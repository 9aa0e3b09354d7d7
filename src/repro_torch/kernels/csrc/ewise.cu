// Flat elementwise maps over n elements: o = x + y, and o = max(x, 0).
//
// Replaces the Pallas bodies `_add_kernel` (src/repro/kernels/ewise.py:25,
// ewise_add) and `_relu_kernel` (ewise.py:29, relu), both reached through
// `_blocked_1d` (ewise.py:42).  The wrapper hands over dense operands that
// share one set of strides (contiguous or channels-last), so walking their
// storage in order pairs equal elements.
//
// Bound: bytes (12 or 8 bytes an element, no reuse; ResNet18's largest
// residual add moves ~25 MB at batch 32).  Each thread moves one 16-byte
// vector of each operand, neighbouring threads on neighbouring vectors, and
// the grid has a 128-thread block for every 128 vectors (ewise.ewise_plan),
// as many as the map needs: the SMs take new blocks as old ones finish, so a
// short map spreads over every SM and a long one streams.  The thread body is
// the load, the op and the store; one more thread takes the n % 4 tail.  On
// the H100, at the ResNet's sizes (1 to 8 MB), bounds of a scalar head and
// tail computed in every thread, or two or four vectors a thread on a grid
// capped at one card's threads, cost a few percent against torch.relu
// (PERF.md).  Bases that are not all 16-byte aligned take a scalar kernel,
// one element a thread.
//
// int32 adds wrap mod 2^32: they add in uint32_t.  float32 relu keeps NaN, as
// jnp.maximum does.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ int32_t relu_of(int32_t v) { return v > 0 ? v : 0; }
__device__ __forceinline__ float relu_of(float v) { return (v > 0.0f || v != v) ? v : 0.0f; }

template <typename T>
struct Add {
  static constexpr bool BINARY = true;
  __device__ static T apply(T a, T b) { return a + b; }
};
template <typename T>
struct Relu {
  static constexpr bool BINARY = false;
  __device__ static T apply(T a, T) { return relu_of(a); }
};

// Elements travel as 32-bit words inside uint4 vectors (one 16-byte load or
// store each); Op sees them as T.
template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b) { return static_cast<T>(b); }
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ uint32_t to_bits(uint32_t v) { return v; }
__device__ __forceinline__ uint32_t to_bits(int32_t v) { return static_cast<uint32_t>(v); }
__device__ __forceinline__ uint32_t to_bits(float v) { return __float_as_uint(v); }

template <class Op, typename T>
__device__ __forceinline__ uint32_t apply_bits(uint32_t a, uint32_t b) {
  return to_bits(Op::apply(from_bits<T>(a), from_bits<T>(b)));
}

// One 16-byte vector of each operand a thread; the thread one past the last
// vector takes the n % 4 elements after it.  Every base is 16-byte aligned.
template <class Op, typename T>
__global__ void __launch_bounds__(THREADS)
ewise_vector(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ o, long long n) {
  const long long nvec = n >> 2;
  const long long v = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (v < nvec) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x) + v);
    const uint4 b = Op::BINARY ? __ldg(reinterpret_cast<const uint4*>(y) + v) : a;
    reinterpret_cast<uint4*>(o)[v] = make_uint4(apply_bits<Op, T>(a.x, b.x), apply_bits<Op, T>(a.y, b.y),
                                                apply_bits<Op, T>(a.z, b.z), apply_bits<Op, T>(a.w, b.w));
  } else if (v == nvec) {
    for (long long i = 4 * nvec; i < n; ++i) o[i] = Op::apply(x[i], Op::BINARY ? y[i] : T());
  }
}

// One element a thread, for bases that are not all 16-byte aligned.
template <class Op, typename T>
__global__ void __launch_bounds__(THREADS)
ewise_scalar(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ o, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < n) o[i] = Op::apply(x[i], Op::BINARY ? y[i] : T());
}

template <class Op, typename T>
int launch(const void* x, const void* y, void* o, long long n, int vec, int blocks, void* stream) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    ewise_vector<Op, T><<<blocks, THREADS, 0, s>>>(xt, yt, ot, n);
  else
    ewise_scalar<Op, T><<<blocks, THREADS, 0, s>>>(xt, yt, ot, n);
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

// vec: 1 when x, (y,) o are all 16-byte aligned, else 0; blocks: the grid
// (ewise.ewise_plan), covering every vector and the tail, or every element.
extern "C" int ewise_add_i32(const void* x, const void* y, void* o, long long n, int vec, int blocks,
                             void* stream) {
  return launch<Add<uint32_t>, uint32_t>(x, y, o, n, vec, blocks, stream);
}
extern "C" int ewise_add_f32(const void* x, const void* y, void* o, long long n, int vec, int blocks,
                             void* stream) {
  return launch<Add<float>, float>(x, y, o, n, vec, blocks, stream);
}
extern "C" int relu_i32(const void* x, void* o, long long n, int vec, int blocks, void* stream) {
  return launch<Relu<int32_t>, int32_t>(x, nullptr, o, n, vec, blocks, stream);
}
extern "C" int relu_f32(const void* x, void* o, long long n, int vec, int blocks, void* stream) {
  return launch<Relu<float>, float>(x, nullptr, o, n, vec, blocks, stream);
}
