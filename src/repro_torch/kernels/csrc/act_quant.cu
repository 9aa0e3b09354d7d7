// Per-row symmetric quantization of activations, in one pass over memory:
// for each row of an (M, K) bfloat16, float16 or float32 matrix,
//
//     scale = max(max|x| / qmax, 1e-8)
//     q     = clamp(rint(x / scale), -qmax - 1, qmax)  as int8
//
// Replaces no TPU kernel: the JAX package quantizes the quantized linear's
// activations with jnp ops that XLA fuses into one loop
// (src/repro/models/common.py, _dynamic_act_quant).  The port ran the same
// ops as a chain of ~11 PyTorch kernels in front of every bit-sliced GEMM
// call (a cast, abs, amax, the scale's divide and floor, the divide, round,
// two clamps, the cast to int8): ~47 bytes of traffic an element of bf16,
// where reading the input once and writing int8 once is 3.
//
// Bound: bytes (no reuse; a few operations an element against the ~295 a byte
// the card needs before arithmetic binds).  One block a row, whose threads
// hold the row in registers between the reduction and the quantize, so the
// row is read from memory once: each thread loads up to VPT 16-byte vectors,
// neighbouring threads on neighbouring vectors (act_quant.act_quant_plan
// sizes the block to the row); the elements before the first 16-byte
// boundary of the row and after its last one (fewer than a vector each) go
// one to a thread.  The max is reduced by warp shuffles, then over the
// block's warps through shared memory.  The int8 values go out packed, a
// vector's 8 (or 4) in one store where their address allows it.
//
// Bit for bit with the PyTorch chain on the card: max|x| is exact in any
// order; the scale and every x / scale are IEEE divisions (__fdiv_rn, as
// torch divides a tensor by a tensor; a multiply by the reciprocal can round
// one ulp away); rintf rounds half to even, as torch.round; the clamps
// come in the chain's order.  A NaN propagates through the max (nan_max), as
// torch.amax propagates it, and through the scale's floor, as clamp_min: a
// row with a NaN gets a NaN scale, one with an infinity an infinite scale,
// as the chain's.  Where x / scale is NaN the int8 value is unspecified (the
// chain's cast of NaN to int8 is undefined too).
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

namespace {

constexpr int VPT = 4;             // 16-byte vectors a thread holds at most
constexpr int MAX_THREADS = 1024;  // a block: rows of up to 4096 vectors

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Element c of a 16-byte vector held as four 32-bit words (little-endian:
// the low half of a word is the lower element).
template <typename T>
__device__ __forceinline__ float element(const uint32_t (&w)[4], int c) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[c]);
  } else {
    const uint32_t word = w[c / 2];
    const unsigned short bits = static_cast<unsigned short>(c % 2 ? word >> 16 : word & 0xffffu);
    if constexpr (std::is_same_v<T, __half>)
      return __half2float(__ushort_as_half(bits));
    else
      return __uint_as_float(static_cast<uint32_t>(bits) << 16);
  }
}

// max(m, a) that keeps a NaN of either side (fmaxf drops it): one instruction,
// as fmaxf; a compare and a select cost the loop, bound by instruction throughput, ~10%
__device__ __forceinline__ float nan_max(float m, float a) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(a));
  return r;
}

__device__ __forceinline__ int quantize(float v, float scale, float lo, float hi) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, scale)), lo), hi));
}

// One block a row.  x: rows ld elements apart (the last dim contiguous);
// q: (M, K) int8, contiguous; scale: M float32.  The plan guarantees
// blockDim.x · VPT >= K / EPV, blockDim.x a multiple of 32.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
act_quant_rows(const T* __restrict__ x, long long ld, int k, int qmax, int8_t* __restrict__ q,
               float* __restrict__ scale) {
  constexpr int EPV = 16 / sizeof(T);  // elements a vector
  const long long row = blockIdx.x;
  const T* xr = x + row * ld;
  int8_t* qr = q + row * k;
  const int t = threadIdx.x, nt = blockDim.x;
  const int head = min(k, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) % 16 / sizeof(T)));
  const int nvec = (k - head) / EPV;
  const int tail0 = head + nvec * EPV, tail = k - tail0;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);

  uint32_t w[VPT][4];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = t + j * nt;
    if (i < nvec) {
      const uint4 u = xv[i];
      w[j][0] = u.x, w[j][1] = u.y, w[j][2] = u.z, w[j][3] = u.w;
#pragma unroll
      for (int c = 0; c < EPV; ++c) amax = nan_max(amax, fabsf(element<T>(w[j], c)));
    }
  }
  float hv = 0.0f, tv = 0.0f;
  if (t < head) hv = to_float(xr[t]), amax = nan_max(amax, fabsf(hv));
  if (t < tail) tv = to_float(xr[tail0 + t]), amax = nan_max(amax, fabsf(tv));

  __shared__ float warp_max[MAX_THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (t % 32 == 0) warp_max[t / 32] = amax;
  __syncthreads();
  // every warp reduces the block's maxima itself: no second barrier
  amax = t % 32 < nt / 32 ? warp_max[t % 32] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));

  const float d = __fdiv_rn(amax, static_cast<float>(qmax));
  const float s = d < 1e-8f ? 1e-8f : d;  // clamp_min: a NaN stays
  if (t == 0) scale[row] = s;
  const float lo = static_cast<float>(-qmax - 1), hi = static_cast<float>(qmax);

  // a contiguous x and q at aligned bases always store packed
  int8_t* qv = qr + head;
  const bool packed = reinterpret_cast<uintptr_t>(qv) % EPV == 0;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = t + j * nt;
    if (i < nvec) {
      uint32_t out[EPV / 4] = {};
#pragma unroll
      for (int c = 0; c < EPV; ++c)
        out[c / 4] |= (static_cast<uint32_t>(quantize(element<T>(w[j], c), s, lo, hi)) & 0xffu) << (8 * (c % 4));
      int8_t* dst = qv + static_cast<long long>(i) * EPV;
      if (packed) {
        if constexpr (EPV == 8)
          *reinterpret_cast<uint2*>(dst) = make_uint2(out[0], out[1]);
        else
          *reinterpret_cast<uint32_t*>(dst) = out[0];
      } else {
#pragma unroll
        for (int c = 0; c < EPV; ++c) dst[c] = static_cast<int8_t>(out[c / 4] >> (8 * (c % 4)));
      }
    }
  }
  if (t < head) qr[t] = static_cast<int8_t>(quantize(hv, s, lo, hi));
  if (t < tail) qr[tail0 + t] = static_cast<int8_t>(quantize(tv, s, lo, hi));
}

template <typename T>
int launch(const void* x, long long ld, void* q, void* scale, int m, int k, int qmax, int threads,
           void* stream) {
  act_quant_rows<T><<<m, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), ld, k, qmax, static_cast<int8_t*>(q), static_cast<float*>(scale));
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

// x: M rows of K elements, ld elements apart; q: (M, K) int8; scale: M
// float32; qmax = 2^(bits-1) - 1; threads: the block (act_quant_plan).
extern "C" int act_quant_bf16(const void* x, long long ld, void* q, void* scale, int m, int k, int qmax,
                              int threads, void* stream) {
  return launch<__nv_bfloat16>(x, ld, q, scale, m, k, qmax, threads, stream);
}
extern "C" int act_quant_f16(const void* x, long long ld, void* q, void* scale, int m, int k, int qmax,
                             int threads, void* stream) {
  return launch<__half>(x, ld, q, scale, m, k, qmax, threads, stream);
}
extern "C" int act_quant_f32(const void* x, long long ld, void* q, void* scale, int m, int k, int qmax,
                             int threads, void* stream) {
  return launch<float>(x, ld, q, scale, m, k, qmax, threads, stream);
}
