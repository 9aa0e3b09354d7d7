// Flat elementwise maps over n elements: o = x + y, and o = max(x, 0).
//
// Replaces the Pallas bodies `_add_kernel` (src/repro/kernels/ewise.py:25,
// ewise_add) and `_relu_kernel` (ewise.py:29, relu), both reached through
// `_blocked_1d` (ewise.py:42).  One thread per element in a grid-stride
// loop; neighbouring threads touch neighbouring words, so loads coalesce.
//
// int32 adds wrap mod 2^32: they add in uint32_t.  float32 relu keeps NaN, as
// jnp.maximum does.  Bound: bytes (12 or 8 bytes an element, no reuse);
// ResNet18's largest residual add moves ~25 MB at batch 32.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
add_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ o, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < n; i += step)
    o[i] = x[i] + y[i];
}

__device__ __forceinline__ int32_t relu_of(int32_t v) { return v > 0 ? v : 0; }
__device__ __forceinline__ float relu_of(float v) { return (v > 0.0f || v != v) ? v : 0.0f; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
relu_kernel(const T* __restrict__ x, T* __restrict__ o, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < n; i += step)
    o[i] = relu_of(x[i]);
}

template <typename T>
int launch_add(const void* x, const void* y, void* o, long long n, void* stream) {
  add_kernel<T><<<repro_grid(n, THREADS), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(o), n);
  return REPRO_LAUNCH_STATUS();
}

template <typename T>
int launch_relu(const void* x, void* o, long long n, void* stream) {
  relu_kernel<T><<<repro_grid(n, THREADS), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(o), n);
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

extern "C" int ewise_add_i32(const void* x, const void* y, void* o, long long n, void* stream) {
  return launch_add<uint32_t>(x, y, o, n, stream);
}
extern "C" int ewise_add_f32(const void* x, const void* y, void* o, long long n, void* stream) {
  return launch_add<float>(x, y, o, n, stream);
}
extern "C" int relu_i32(const void* x, void* o, long long n, void* stream) {
  return launch_relu<int32_t>(x, o, n, stream);
}
extern "C" int relu_f32(const void* x, void* o, long long n, void* stream) {
  return launch_relu<float>(x, o, n, stream);
}
