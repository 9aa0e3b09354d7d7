// RG-LRU linear recurrence h_t = a_t · h_{t-1} + b_t over T, from h0.
//
// Replaces the Pallas body of src/repro/kernels/rglru_scan.py:
//   _kernel (25, rglru_scan) → rglru_scan_kernel below.
// The Pallas grid walks T in order and carries h in VMEM scratch from one
// step to the next; blocks on this card run in no order, so a thread owns
// one (b, w) channel and walks all of T itself, h in a register.
//
// Numerics: the Pallas body's a·h + b is one fused multiply-add (rounded
// once), so the update is __fmaf_rn, written out: the result does not
// depend on nvcc's --fmad default.  Each channel is a sequential chain, so
// the output is the same bit for bit at any launch shape.
//
// Bound on this card: bytes.  a, b and the output are read or written once
// (12 bytes per element; (4, 2048, 2560) moves 251.7 MB, 75.1 µs at
// 3.35 TB/s) for one fma each.  Loads coalesce across w (neighbouring
// threads, neighbouring channels).  They do not depend on h, so each thread
// loads PREFETCH steps of a and b before it computes them, keeping many
// loads in flight.  Blocks are small so that B·W channels spread over every
// SM.
#include "common.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int PREFETCH = 8;

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int bsz, int t, int w) {
  const long long ch = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (ch >= static_cast<long long>(bsz) * w) return;
  const int bi = static_cast<int>(ch / w), wi = static_cast<int>(ch % w);
  const size_t base = static_cast<size_t>(bi) * t * w + wi;
  float h = h0[ch];
  int s = 0;
  for (; s + PREFETCH <= t; s += PREFETCH) {
    float av[PREFETCH], bv[PREFETCH];
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      const size_t off = base + static_cast<size_t>(s + j) * w;
      av[j] = __ldg(a + off);
      bv[j] = __ldg(b + off);
    }
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      h = __fmaf_rn(av[j], h, bv[j]);
      out[base + static_cast<size_t>(s + j) * w] = h;
    }
  }
  for (; s < t; ++s) {
    const size_t off = base + static_cast<size_t>(s) * w;
    h = __fmaf_rn(__ldg(a + off), h, __ldg(b + off));
    out[off] = h;
  }
}

}  // namespace

// a, b, out (B, T, W) float32 row-major; h0 (B, W) float32.
extern "C" int rglru_scan_f32(const void* a, const void* b, const void* h0, void* out, int bsz,
                              int t, int w, void* stream) {
  const long long channels = static_cast<long long>(bsz) * w;
  const unsigned int blocks = static_cast<unsigned int>((channels + THREADS - 1) / THREADS);
  rglru_scan_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(h0),
      static_cast<float*>(out), bsz, t, w);
  return REPRO_LAUNCH_STATUS();
}
