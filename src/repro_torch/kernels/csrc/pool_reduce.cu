// Row reduction out[r] = op(p[r, 0..K)) over a row-major (P, K) window
// matrix, op = sum or max.
//
// Replaces the Pallas bodies `_pool_sum_kernel` (src/repro/kernels/conv.py:88,
// global_avgpool and avgpool2d) and `_pool_max_kernel` (conv.py:84,
// maxpool2d), both reached through `_blocked_pool` (conv.py:92).  The Pallas
// grid is sequential over row blocks; here one warp owns a row at a time in
// a grid-stride loop: its lanes stride over K, then a butterfly shuffle
// combines them.  The floor-divide of the average stays in the caller, as in
// the JAX package (ref._pool_mean).
//
// int32 sums wrap mod 2^32: they add in uint32_t.  float32 max propagates NaN
// as jnp.max does.  Bound: bytes (P*K reads, P writes, no reuse); ResNet18's
// global pool is a ~1 MB read at batch 32, so launch latency dominates.
#include "common.cuh"

#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct SumU32 {
  using T = uint32_t;
  __device__ static T identity() { return 0u; }
  __device__ static T combine(T a, T b) { return a + b; }
};
struct SumF32 {
  using T = float;
  __device__ static T identity() { return 0.0f; }
  __device__ static T combine(T a, T b) { return a + b; }
};
struct MaxI32 {
  using T = int32_t;
  __device__ static T identity() { return INT_MIN; }
  __device__ static T combine(T a, T b) { return a > b ? a : b; }
};
struct MaxF32 {
  using T = float;
  __device__ static T identity() { return -__int_as_float(0x7f800000); }  // -inf
  __device__ static T combine(T a, T b) {
    if (a != a) return a;  // NaN propagates
    if (b != b) return b;
    return a > b ? a : b;
  }
};

template <class Op>
__global__ void __launch_bounds__(THREADS)
pool_kernel(const typename Op::T* __restrict__ p, typename Op::T* __restrict__ out,
            long long rows, int k) {
  using T = typename Op::T;
  const int lane = threadIdx.x % 32;
  const long long first = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const long long step = static_cast<long long>(gridDim.x) * WARPS;
  for (long long r = first; r < rows; r += step) {  // warp-uniform
    const T* row = p + r * k;
    T acc = Op::identity();
    for (int j = lane; j < k; j += 32) acc = Op::combine(acc, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = Op::combine(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0) out[r] = acc;
  }
}

template <class Op>
int launch_pool(const void* p, void* out, long long rows, int k, void* stream) {
  pool_kernel<Op><<<repro_grid(rows, WARPS), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename Op::T*>(p), static_cast<typename Op::T*>(out), rows, k);
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

extern "C" int pool_sum_i32(const void* p, void* out, long long rows, int k, void* stream) {
  return launch_pool<SumU32>(p, out, rows, k, stream);
}
extern "C" int pool_sum_f32(const void* p, void* out, long long rows, int k, void* stream) {
  return launch_pool<SumF32>(p, out, rows, k, stream);
}
extern "C" int pool_max_i32(const void* p, void* out, long long rows, int k, void* stream) {
  return launch_pool<MaxI32>(p, out, rows, k, stream);
}
extern "C" int pool_max_f32(const void* p, void* out, long long rows, int k, void* stream) {
  return launch_pool<MaxF32>(p, out, rows, k, stream);
}
