// Row reduction out[r] = op(p[r, 0..K)) over a row-major (P, K) window
// matrix, op = sum or max.
//
// Replaces the Pallas bodies `_pool_sum_kernel` (src/repro/kernels/conv.py:88,
// global_avgpool and avgpool2d) and `_pool_max_kernel` (conv.py:84,
// maxpool2d), both reached through `_blocked_pool` (conv.py:92).  The floor-
// divide of the average stays in the caller, as in the JAX package
// (ref._pool_mean).
//
// Bound: bytes (P*K reads, P writes, no reuse).  The pool windows are short
// (K = 4 at a 2x2 max pool, 16 at ResNet18's global pool), so one warp per row
// would idle most of its lanes and spend more shuffles than loads.  Here each
// row gets a group of G lanes, G a power of two sized to K (the wrapper's
// plan, conv.pool_plan): G lanes x one 16-byte vector cover about K elements,
// so at K = 4 one thread reads a whole row with one 16-byte load and a warp
// reads 512 contiguous bytes.  Past K = 64 the group is the warp, whose lanes
// stride over the row (several vectors in flight a lane).  The grid has a
// block for every THREADS / G rows (conv.pool_plan), as many as the matrix
// needs (rows < 2^31), so a short reduction spreads over every SM and a long
// one streams;
// consecutive groups take consecutive rows, so every load instruction of a
// warp reads neighbouring bytes.  The group then combines with log2(G)
// xor-shuffles.  Vector loads are used only when the row base is 16-byte
// aligned and K % 4 == 0; otherwise the same groups load element by element.
//
// int32 sums wrap mod 2^32: they add in uint32_t, so the order is free.
// float32 sums add in another order than the CPU (within the port's 1e-4
// float tolerance).  Max keeps the dtype; float32 max propagates NaN as
// jnp.max does.
#include "common.cuh"

#include <climits>

namespace {

constexpr int THREADS = 256;

struct SumU32 {
  using T = uint32_t;
  __device__ static T identity() { return 0u; }
  __device__ static T combine(T a, T b) { return a + b; }
  __device__ static T from_bits(uint32_t b) { return b; }
};
struct SumF32 {
  using T = float;
  __device__ static T identity() { return 0.0f; }
  __device__ static T combine(T a, T b) { return a + b; }
  __device__ static T from_bits(uint32_t b) { return __uint_as_float(b); }
};
struct MaxI32 {
  using T = int32_t;
  __device__ static T identity() { return INT_MIN; }
  __device__ static T combine(T a, T b) { return a > b ? a : b; }
  __device__ static T from_bits(uint32_t b) { return static_cast<int32_t>(b); }
};
struct MaxF32 {
  using T = float;
  __device__ static T identity() { return -__int_as_float(0x7f800000); }  // -inf
  __device__ static T combine(T a, T b) {
    if (a != a) return a;  // NaN propagates
    if (b != b) return b;
    return a > b ? a : b;
  }
  __device__ static T from_bits(uint32_t b) { return __uint_as_float(b); }
};

// Item i of a row: the i-th 16-byte vector (its four elements combined in
// order) or the i-th element.
template <class Op, bool VEC>
__device__ __forceinline__ typename Op::T load_item(const typename Op::T* row, int i) {
  if constexpr (VEC) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + i);
    return Op::combine(Op::combine(Op::combine(Op::from_bits(v.x), Op::from_bits(v.y)),
                                   Op::from_bits(v.z)), Op::from_bits(v.w));
  } else {
    return __ldg(row + i);
  }
}

template <class Op, int G, bool VEC>
__global__ void __launch_bounds__(THREADS)
pool_kernel(const typename Op::T* __restrict__ p, typename Op::T* __restrict__ out,
            long long rows, int k) {
  using T = typename Op::T;
  constexpr int GROUPS = THREADS / G;
  const int lane = threadIdx.x % G;
  const int items = VEC ? k / 4 : k;
  const long long r = static_cast<long long>(blockIdx.x) * GROUPS + threadIdx.x / G;
  // past the end: reread the last row and write nothing, so that every lane of
  // a warp reaches the shuffles
  const T* row = p + (r < rows ? r : rows - 1) * k;
  T acc = Op::identity();
#pragma unroll 4
  for (int i = lane; i < items; i += G) acc = Op::combine(acc, load_item<Op, VEC>(row, i));
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) acc = Op::combine(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0 && r < rows) out[r] = acc;
}

template <class Op, int G>
int launch_group(const void* p, void* out, long long rows, int k, int vec, int blocks, void* stream) {
  using T = typename Op::T;
  auto kernel = vec ? pool_kernel<Op, G, true> : pool_kernel<Op, G, false>;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<T*>(out), rows, k);
  return REPRO_LAUNCH_STATUS();
}

template <class Op>
int launch_pool(const void* p, void* out, long long rows, int k, int lanes, int vec, int blocks,
                void* stream) {
  switch (lanes) {
    case 1: return launch_group<Op, 1>(p, out, rows, k, vec, blocks, stream);
    case 2: return launch_group<Op, 2>(p, out, rows, k, vec, blocks, stream);
    case 4: return launch_group<Op, 4>(p, out, rows, k, vec, blocks, stream);
    case 8: return launch_group<Op, 8>(p, out, rows, k, vec, blocks, stream);
    case 16: return launch_group<Op, 16>(p, out, rows, k, vec, blocks, stream);
    case 32: return launch_group<Op, 32>(p, out, rows, k, vec, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// lanes: a power of two from 1 to 32; vec: 1 for 16-byte loads (the base
// 16-byte aligned and k % 4 == 0), else 0; blocks: the grid.
extern "C" int pool_sum_i32(const void* p, void* out, long long rows, int k, int lanes, int vec,
                            int blocks, void* stream) {
  return launch_pool<SumU32>(p, out, rows, k, lanes, vec, blocks, stream);
}
extern "C" int pool_sum_f32(const void* p, void* out, long long rows, int k, int lanes, int vec,
                            int blocks, void* stream) {
  return launch_pool<SumF32>(p, out, rows, k, lanes, vec, blocks, stream);
}
extern "C" int pool_max_i32(const void* p, void* out, long long rows, int k, int lanes, int vec,
                            int blocks, void* stream) {
  return launch_pool<MaxI32>(p, out, rows, k, lanes, vec, blocks, stream);
}
extern "C" int pool_max_f32(const void* p, void* out, long long rows, int k, int lanes, int vec,
                            int blocks, void* stream) {
  return launch_pool<MaxF32>(p, out, rows, k, lanes, vec, blocks, stream);
}
