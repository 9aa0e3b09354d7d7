// RG-LRU linear recurrence h_t = a_t · h_{t-1} + b_t over T, from h0.
//
// Replaces the Pallas body of src/repro/kernels/rglru_scan.py:
//   _kernel (25, rglru_scan) → rglru_scan_kernel below.
// The Pallas grid walks T in order and carries h in VMEM scratch from one
// step to the next; blocks on this card run in no order, so one warp owns a
// channel group (one b, `group` contiguous w) and walks all of T itself, each
// channel's h in a register of its lane.
//
// Numerics: the Pallas body's a·h + b is one fused multiply-add (rounded
// once), so the update is __fmaf_rn, written out: the result does not
// depend on nvcc's --fmad default, and subnormals are kept (no -ftz).  Each
// channel is a sequential chain, so the output is the same bit for bit at
// any launch shape; T is never split.
//
// Bound on this card: bytes.  a, b and the output are read or written once
// (12 bytes per element; (4, 2048, 2560) moves 251.7 MB, 75.1 µs at
// 3.35 TB/s) for one fma each.  The loads do not depend on h, but each
// chain step does on the last: a thread that loads a few steps, computes
// them and only then loads the next makes one memory round trip every few
// steps (a loaded round trip is about 1 µs), and keeps too few bytes in
// flight to reach the bandwidth (Little's law at 3.35 TB/s and ~1 µs asks
// for about 26 KB in flight an SM).  So each warp keeps a ring of
// SCAN_STAGES stages of SCAN_STEPS steps × `group` channels of a and b in
// shared memory, filled by cp.async (16-byte copies when W % 4 == 0 and a, b
// are 16-byte aligned, else 4-byte ones), SCAN_STAGES - 1 stages ahead of the
// chain: 24 KB in flight a 32-channel group, about 58 KB an SM at the
// phase-3g shape.  Before each stage's chain, its lanes read the stage into
// registers, so no shared-memory latency sits between dependent fmas; the
// outputs of a step go out as one coalesced 128-byte row of the group.
// 32-channel groups give 320 warps over 132 SMs at (4, 2048, 2560), all
// resident at once (32 KB of shared memory each): the busiest SM holds 3
// against a mean of 2.42, which costs nothing while the card's bandwidth,
// not an SM, is the limit.  On this card 32-channel groups of 32-step
// stages beat 16-channel groups and 8- or 16-step stages (whose per-stage
// waits and copy issue sit on the chain's warp), and 4 to 6 stages tied.
// A ragged last stage of T and a ragged last group of W are masked: their
// copies write zeros, and steps past T or channels past W are not computed.
//
// The backward (rglru_scan_bwd_kernel) replaces no Pallas body: the JAX
// package differentiates its associative scan, and the port's forward is
// this kernel, so its gradient is a kernel too.  Given g_t = dL/dh_t it
// walks T from the end: d_{T-1} = g_{T-1}, d_t = fma(a_{t+1}, d_{t+1}, g_t)
// (one __fmaf_rn, as the plain version's exact fma), db_t = d_t and
// da_t = d_t * h_{t-1} with h_{-1} = h0 (one __fmul_rn), and dh0 = a_0 * d_0
// when asked for.  The same partition and ring as the forward, walked from
// the last stage: a stage holds a_t, g_t and h_{t-1} for its 32 steps (h
// shifted one row, from h0 at t = 0), so a_{t+1} is carried in a register
// across steps and stages; 48 KB of shared memory a warp.  Bound: bytes,
// 20 a element (a, g, hs read; da, db written).
#include "common.cuh"

namespace {

constexpr int SCAN_THREADS = 32;  // one warp a channel group
constexpr int SCAN_GROUP = 32;    // channels a group (at most a warp's lanes)
constexpr int SCAN_STEPS = 32;    // steps of T a stage
constexpr int SCAN_STAGES = 4;    // stages of the ring; SCAN_STAGES - 1 in flight

// Copies stage `s` (steps s·SCAN_STEPS ...) of a and b into `slot`, laid out
// [a | b][step][channel]; steps past T and channels past `nch` write zeros.
template <bool VEC>
__device__ __forceinline__ void load_stage(float* slot, const float* __restrict__ a,
                                           const float* __restrict__ b, size_t row0, int s, int t,
                                           int w, int group, int nch) {
  constexpr int PER = VEC ? 4 : 1;  // channels a copy
  const int per_row = group / PER;
  const int per_arr = SCAN_STEPS * per_row;
  const int t0 = s * SCAN_STEPS;
  for (int i = threadIdx.x; i < 2 * per_arr; i += SCAN_THREADS) {
    const int arr = i / per_arr, r = i - arr * per_arr;
    const int step = r / per_row, c = (r - step * per_row) * PER;
    const bool valid = t0 + step < t && c < nch;
    const float* src = (arr ? b : a) + (valid ? row0 + static_cast<size_t>(t0 + step) * w + c : 0);
    const uint32_t dst = smem_addr(slot + (arr * SCAN_STEPS + step) * group + c);
    if constexpr (VEC)
      cp16(dst, src, valid);
    else
      cp4(dst, src, valid);
  }
  cp_commit();
}

template <bool VEC>
__global__ void __launch_bounds__(SCAN_THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out, int t, int w, int group,
                  int groups_per_row) {
  extern __shared__ float4 ring4[];  // [SCAN_STAGES][2][SCAN_STEPS][group]
  float* ring = reinterpret_cast<float*>(ring4);
  const int lane = threadIdx.x;
  const int bi = blockIdx.x / groups_per_row;
  const int w0 = (blockIdx.x - bi * groups_per_row) * group;
  const int nch = min(group, w - w0);
  const size_t row0 = static_cast<size_t>(bi) * t * w + w0;  // element (bi, 0, w0)
  const int slot_floats = 2 * SCAN_STEPS * group;
  const int stages = (t + SCAN_STEPS - 1) / SCAN_STEPS;

  float h = lane < nch ? h0[static_cast<size_t>(bi) * w + w0 + lane] : 0.0f;
  // the prologue: SCAN_STAGES - 1 stages in flight (empty groups past T)
  for (int s = 0; s < SCAN_STAGES - 1; ++s) {
    if (s < stages)
      load_stage<VEC>(ring + s * slot_floats, a, b, row0, s, t, w, group, nch);
    else
      cp_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_wait<SCAN_STAGES - 2>();  // this lane's copies of stage s have landed
    __syncwarp();                // and every lane's; stage s - 1's slot is free
    const int next = s + SCAN_STAGES - 1;
    if (next < stages)
      load_stage<VEC>(ring + (next % SCAN_STAGES) * slot_floats, a, b, row0, next, t, w, group, nch);
    else
      cp_commit();
    if (lane < nch) {
      const float* slot = ring + (s % SCAN_STAGES) * slot_floats;
      float av[SCAN_STEPS], bv[SCAN_STEPS];
#pragma unroll
      for (int j = 0; j < SCAN_STEPS; ++j) {
        av[j] = slot[j * group + lane];
        bv[j] = slot[(SCAN_STEPS + j) * group + lane];
      }
      const int t0 = s * SCAN_STEPS;
      float* o = out + row0 + static_cast<size_t>(t0) * w + lane;
      if (t0 + SCAN_STEPS <= t) {
#pragma unroll
        for (int j = 0; j < SCAN_STEPS; ++j) {
          h = __fmaf_rn(av[j], h, bv[j]);
          o[static_cast<size_t>(j) * w] = h;
        }
      } else {
#pragma unroll
        for (int j = 0; j < SCAN_STEPS; ++j) {
          if (t0 + j < t) {
            h = __fmaf_rn(av[j], h, bv[j]);
            o[static_cast<size_t>(j) * w] = h;
          }
        }
      }
    }
  }
  cp_wait<0>();
}

// Copies stage `s` of the backward's operands into `slot`, laid out
// [a | g | h_prev][step][channel]: a_t, g_t and h_{t-1} (h0 at t = 0) for
// the steps t of the stage; steps past T and channels past `nch` write zeros.
template <bool VEC>
__device__ __forceinline__ void load_bwd_stage(float* slot, const float* __restrict__ a,
                                               const float* __restrict__ g, const float* __restrict__ hs,
                                               const float* __restrict__ h0, size_t row0, size_t h0row, int s,
                                               int t, int w, int group, int nch) {
  constexpr int PER = VEC ? 4 : 1;
  const int per_row = group / PER;
  const int per_arr = SCAN_STEPS * per_row;
  const int t0 = s * SCAN_STEPS;
  for (int i = threadIdx.x; i < 3 * per_arr; i += SCAN_THREADS) {
    const int arr = i / per_arr, r = i - arr * per_arr;
    const int step = r / per_row, c = (r - step * per_row) * PER;
    const int tt = t0 + step;
    const bool valid = tt < t && c < nch;
    const float* src = a;  // read nothing when not valid
    if (valid) {
      if (arr == 0)
        src = a + row0 + static_cast<size_t>(tt) * w + c;
      else if (arr == 1)
        src = g + row0 + static_cast<size_t>(tt) * w + c;
      else
        src = tt > 0 ? hs + row0 + static_cast<size_t>(tt - 1) * w + c : h0 + h0row + c;
    }
    const uint32_t dst = smem_addr(slot + (arr * SCAN_STEPS + step) * group + c);
    if constexpr (VEC)
      cp16(dst, src, valid);
    else
      cp4(dst, src, valid);
  }
  cp_commit();
}

template <bool VEC>
__global__ void __launch_bounds__(SCAN_THREADS)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ hs, const float* __restrict__ h0,
                      const float* __restrict__ g, float* __restrict__ da, float* __restrict__ db,
                      float* __restrict__ dh0, int t, int w, int group, int groups_per_row) {
  extern __shared__ float4 ring4[];  // [SCAN_STAGES][3][SCAN_STEPS][group]
  float* ring = reinterpret_cast<float*>(ring4);
  const int lane = threadIdx.x;
  const int bi = blockIdx.x / groups_per_row;
  const int w0 = (blockIdx.x - bi * groups_per_row) * group;
  const int nch = min(group, w - w0);
  const size_t row0 = static_cast<size_t>(bi) * t * w + w0;  // element (bi, 0, w0)
  const size_t h0row = static_cast<size_t>(bi) * w + w0;
  const int slot_floats = 3 * SCAN_STEPS * group;
  const int stages = (t + SCAN_STEPS - 1) / SCAN_STEPS;

  // the prologue: the last SCAN_STAGES - 1 stages in flight (k-th from the end in slot k)
  for (int k = 0; k < SCAN_STAGES - 1; ++k) {
    if (k < stages)
      load_bwd_stage<VEC>(ring + k * slot_floats, a, g, hs, h0, row0, h0row, stages - 1 - k, t, w, group, nch);
    else
      cp_commit();
  }
  float d = 0.0f, a_next = 0.0f;  // d_{t+1} and a_{t+1}
  for (int k = 0; k < stages; ++k) {
    cp_wait<SCAN_STAGES - 2>();  // this lane's copies of stage k from the end have landed
    __syncwarp();                // and every lane's; the slot of stage k - 1 is free
    const int next = k + SCAN_STAGES - 1;
    if (next < stages)
      load_bwd_stage<VEC>(ring + (next % SCAN_STAGES) * slot_floats, a, g, hs, h0, row0, h0row,
                          stages - 1 - next, t, w, group, nch);
    else
      cp_commit();
    if (lane < nch) {
      const float* slot = ring + (k % SCAN_STAGES) * slot_floats;
      float av[SCAN_STEPS], gv[SCAN_STEPS], hv[SCAN_STEPS];
#pragma unroll
      for (int j = 0; j < SCAN_STEPS; ++j) {
        av[j] = slot[j * group + lane];
        gv[j] = slot[(SCAN_STEPS + j) * group + lane];
        hv[j] = slot[(2 * SCAN_STEPS + j) * group + lane];
      }
      const int t0 = (stages - 1 - k) * SCAN_STEPS;
      float* oa = da + row0 + static_cast<size_t>(t0) * w + lane;
      float* ob = db + row0 + static_cast<size_t>(t0) * w + lane;
      if (k > 0) {  // a whole stage below the last step of T
#pragma unroll
        for (int j = SCAN_STEPS - 1; j >= 0; --j) {
          d = __fmaf_rn(a_next, d, gv[j]);
          ob[static_cast<size_t>(j) * w] = d;
          oa[static_cast<size_t>(j) * w] = __fmul_rn(d, hv[j]);
          a_next = av[j];
        }
      } else {  // the last stage: ragged, and d_{T-1} = g_{T-1} as it is (a -0 stays -0)
#pragma unroll
        for (int j = SCAN_STEPS - 1; j >= 0; --j) {
          if (t0 + j < t) {
            d = t0 + j == t - 1 ? gv[j] : __fmaf_rn(a_next, d, gv[j]);
            ob[static_cast<size_t>(j) * w] = d;
            oa[static_cast<size_t>(j) * w] = __fmul_rn(d, hv[j]);
            a_next = av[j];
          }
        }
      }
    }
  }
  cp_wait<0>();
  if (dh0 != nullptr && lane < nch) dh0[h0row + lane] = __fmul_rn(a_next, d);
}

}  // namespace

// a, b, out (B, T, W) float32 row-major; h0 (B, W) float32.  The launch plan
// is rglru_scan.rglru_plan's: `group` channels a warp (1 to 32, never across
// a row of B), 16-byte copies when `vec` (W and `group` multiples of 4, a and
// b 16-byte aligned), and one block for each of the B · ceil(W / group)
// groups.
extern "C" int rglru_scan_f32(const void* a, const void* b, const void* h0, void* out, int bsz, int t, int w,
                              int group, int vec, int blocks, void* stream) {
  const int groups_per_row = group > 0 ? (w + group - 1) / group : 0;
  if (group < 1 || group > SCAN_THREADS || bsz < 1 || t < 1 || w < 1 ||
      static_cast<long long>(bsz) * groups_per_row != blocks ||
      (vec && (w % 4 != 0 || group % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(b) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(SCAN_STAGES) * 2 * SCAN_STEPS * group * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  const auto* fh = static_cast<const float*>(h0);
  auto* fo = static_cast<float*>(out);
  if (vec)
    rglru_scan_kernel<true><<<blocks, SCAN_THREADS, smem, s>>>(fa, fb, fh, fo, t, w, group, groups_per_row);
  else
    rglru_scan_kernel<false><<<blocks, SCAN_THREADS, smem, s>>>(fa, fb, fh, fo, t, w, group, groups_per_row);
  return REPRO_LAUNCH_STATUS();
}

// The backward of rglru_scan_f32: a, hs, g, da, db (B, T, W) float32
// row-major; h0 and dh0 (B, W), dh0 NULL when its gradient is not needed.
// The same plan as the forward (rglru_scan.rglru_plan over a, hs, h0, g).
extern "C" int rglru_scan_bwd_f32(const void* a, const void* hs, const void* h0, const void* g, void* da,
                                  void* db, void* dh0, int bsz, int t, int w, int group, int vec, int blocks,
                                  void* stream) {
  const int groups_per_row = group > 0 ? (w + group - 1) / group : 0;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (group < 1 || group > SCAN_THREADS || bsz < 1 || t < 1 || w < 1 ||
      static_cast<long long>(bsz) * groups_per_row != blocks ||
      (vec && (w % 4 != 0 || group % 4 != 0 || !aligned(a) || !aligned(hs) || !aligned(h0) || !aligned(g))))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(SCAN_STAGES) * 3 * SCAN_STEPS * group * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* fa = static_cast<const float*>(a);
  const auto* fhs = static_cast<const float*>(hs);
  const auto* fh0 = static_cast<const float*>(h0);
  const auto* fg = static_cast<const float*>(g);
  auto* fda = static_cast<float*>(da);
  auto* fdb = static_cast<float*>(db);
  auto* fdh0 = static_cast<float*>(dh0);
  if (vec)
    rglru_scan_bwd_kernel<true><<<blocks, SCAN_THREADS, smem, s>>>(fa, fhs, fh0, fg, fda, fdb, fdh0, t, w, group,
                                                                   groups_per_row);
  else
    rglru_scan_bwd_kernel<false><<<blocks, SCAN_THREADS, smem, s>>>(fa, fhs, fh0, fg, fda, fdb, fdh0, t, w, group,
                                                                    groups_per_row);
  return REPRO_LAUNCH_STATUS();
}
