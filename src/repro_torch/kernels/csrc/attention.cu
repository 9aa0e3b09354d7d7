// Integer attention decode kernels: q·Kᵀ scores, the fixed-point row softmax,
// the probability-weighted value mix p·V with its arithmetic shift, the
// single-token decode projection, and the KV-cache row append.
//
// Replaces the Pallas bodies of src/repro/kernels/attention.py:
//   _qk_kernel (48, attention_qk)          → rowdot, qk_generic
//   _softmax_kernel (88, softmax_fixedpoint) → softmax_rows, softmax_cluster
//   _pv_kernel (145, attention_pv)          → pv_packed, pv_generic
//   _gemv_kernel (182, decode_gemv)         → rowdot, gemv_generic
//   _kv_append_kernel (218, kv_append)      → kv_append_*
// Each computes what the TPU kernel computes; the blocking is Hopper's own.
//
// Integer semantics are the JAX oracles' exactly: int32 sums and products
// wrap mod 2^32 (they are computed in uint32_t, since signed overflow is
// undefined in C++), every >> is arithmetic, int8 operands are widened in
// registers, never in a separate pass.
//
// Bounds on this card, at a decode step (M = 1 or a GQA group of 7 queries,
// T up to 32768 cache rows of D = Dv = 64): every kernel is bound by bytes
// (at most 2·D integer operations per byte read), and at these sizes by
// launch latency well before that: the K or V cache is 2 MB (0.6 µs at
// 3.35 TB/s).
//
//  * qk and decode_gemv are one function: out[i][r] = Σ_j a[i][j]·w[r][j]
//    mod 2^32, with w the (T, D) cache and a the (M, D) queries, or w the
//    (M, K) weight and a the one (K,) activation.  The serving call reads a
//    2 MB cache (0.6 µs) and the small projections 0.1–4.4 MB, less than or
//    about one launch (1.6–1.9 µs in graph replay): what costs above the
//    floor is dependent round trips, not bytes.  So both
//    take `rowdot` (int8 × int8 or int32 × int32, 16-byte rows, every base
//    16-byte aligned), laid out by attention.rowdot_plan: `lanes` lanes of a
//    warp (and `split` warps) share a row, each on its 16-byte chunks c ≡ slot
//    (mod lanes·split), so the warp's loads cover whole rows and sectors
//    between them; a lane issues all (up to `unroll`) of its row's
//    loads before its first multiply, and loads its chunks of the activation
//    (or of each of up to 8 queries) once, beside them, into registers — no
//    shared-memory staging and no barrier before the first load; rows too
//    long for that stream the activation through the read-only path.  Lanes
//    add in uint32_t by __shfl_xor_sync, split warps through shared memory
//    (order-free mod 2^32), and after the butterfly one warp store writes a
//    contiguous run of results.  A row of at most 32 chunks gets a lane a
//    chunk, so a warp load reads whole rows (D = 64: 8 rows, 512 bytes,
//    which with the cache cold in L2 beat 1–2 lanes a row); a longer row's
//    lane aims at 4 chunks, 2 with a group of queries (on the card 2–4 beat
//    1 and 5–19: one chunk a lane takes more blocks, many a longer chain),
//    and the plan raises
//    lanes·split, then lowers the warps of a block, until the grid covers
//    the 132 SMs (or every row has a block): with the operands cold in L2 a
//    row's bytes come from HBM, and an idle SM is bandwidth not drawn.
//    Above 4224 blocks the grid walks the rows (grid-stride), each block an
//    equal number of steps, so the LM head's 151936 rows keep streaming.
//    Mixed types, ragged rows and misaligned views take qk_generic and
//    gemv_generic.
//  * softmax: a row max, a sum of exponentials Σw and a write, with the
//    normaliser q = 2^(FI+F) // Σw an exact integer floor division, as in the
//    oracle (the Pallas body's restoring division shifts Σw left by up to FI
//    bits in int32 and wraps once a row holds 2^17 near-equal scores).  The
//    decode step has one row of T = 32768, which one block on one SM would
//    walk alone, so a long row (attention.softmax_plan) gets a thread-block
//    cluster of up to 16 blocks on 16 SMs: each block loads its slice with
//    16-byte loads into registers, and the max, then Σw, are reduced by warp
//    shuffles and through the cluster's distributed shared memory, one
//    cluster barrier each (both order-free: a max and a uint32 sum, so
//    bit-exact).  Each
//    exponential is computed once and written with 16-byte stores.  A row
//    longer than the cluster's registers hold loops over its slices and
//    recomputes from L2; short rows take a warp each, 8 rows a block.
//  * pv: a reduction over a long T for only M·Dv outputs.  One launch
//    (attention.pv_plan): blocks split T, and on the packed path (int32 p,
//    int8 v, Dv/16 dividing 32, v 16-byte aligned) every thread loads 16
//    columns of a value row at a time, 4 rows in flight, for up to 4 queries
//    in registers; a block reduces across a warp's rows by shuffles and
//    across warps in shared memory and writes uint32 partial sums.  The last
//    block to take the launch's ticket adds every block's partials
//    (order-free mod 2^32, so bit-exact), applies the shift once to the full
//    sum, never to a partial, and returns the ticket to zero.  Every other
//    operand mix takes the generic kernel, which ends the same way.
//  * kv_append: a copy of the cache with the selected rows replaced, a new
//    tensor (Programs replay the append, so the input is never written).
//    Every nonzero selector entry is honoured.  The serving path's call, a
//    (32768, 64) int8 cache with an int8 one-hot selector, moves 4.23 MB
//    (1.26 µs at 3.35 TB/s), less than one launch (about 1.6–1.9 µs in graph
//    replay): what costs is round trips, not bytes.  A thread that loads
//    its row's selector byte and only then the cache chunk or the new row
//    puts two dependent trips on every thread, so `kv_append_i8_vec` (an
//    int8 cache and row, D % 16 == 0, 16-byte aligned: attention.kv_plan)
//    loads a 16-byte chunk, its selector byte and the row's chunk together
//    and selects once all three have arrived.  One chunk a thread in 512
//    blocks (one wave) beat 2, 4 and 8 chunks a thread in 128–256 blocks,
//    and a bulk-copy design (a block's 16 KB run of rows copied into shared
//    memory and out again by the copy engine, selected rows patched between)
//    lost to the four-chunk kernel on this card.  Every other operand mix takes
//    `kv_append_generic`, an element a thread.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int F = 6;    // SOFTMAX_F: fraction bits of exponentials and outputs
constexpr int K = 3;    // SOFTMAX_K: range-reduction squarings
constexpr int FI = 8;   // SOFTMAX_FI: extra fraction bits of the reciprocal

template <typename T>
__device__ __forceinline__ uint32_t widen(T v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}

__device__ __forceinline__ int32_t as_i32(uint32_t v) { return static_cast<int32_t>(v); }

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int32_t warp_max(int32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// attention_qk: out (M, T) = q (M, D) · k (T, D)ᵀ
// ---------------------------------------------------------------------------

constexpr int QK_THREADS = 128;
constexpr int QK_GROUP = 8;  // queries a thread accumulates at once (blockIdx.y picks the group)

// Any int8/int32 mix, any D: element loads.
template <typename TQ, typename TK>
__global__ void __launch_bounds__(QK_THREADS)
qk_generic(const TQ* __restrict__ q, const TK* __restrict__ k, int32_t* __restrict__ out,
           int m, int t, int d) {
  const int m0 = blockIdx.y * QK_GROUP;
  const int mg = min(QK_GROUP, m - m0);
  const int stride = gridDim.x * QK_THREADS;
  for (int row = blockIdx.x * QK_THREADS + threadIdx.x; row < t; row += stride) {
    const TK* kr = k + static_cast<size_t>(row) * d;
    uint32_t acc[QK_GROUP];
#pragma unroll
    for (int i = 0; i < QK_GROUP; ++i) acc[i] = 0u;
    for (int j = 0; j < d; ++j) {
      const uint32_t kv = widen(kr[j]);
#pragma unroll
      for (int i = 0; i < QK_GROUP; ++i)
        if (i < mg) acc[i] += widen(q[static_cast<size_t>(m0 + i) * d + j]) * kv;
    }
#pragma unroll
    for (int i = 0; i < QK_GROUP; ++i)
      if (i < mg) out[static_cast<size_t>(m0 + i) * t + row] = as_i32(acc[i]);
  }
}

template <typename TQ, typename TK>
void launch_qk_generic(dim3 grid, cudaStream_t s, const void* q, const void* k, void* out,
                       int m, int t, int d) {
  qk_generic<TQ, TK><<<grid, QK_THREADS, 0, s>>>(static_cast<const TQ*>(q),
                                                 static_cast<const TK*>(k),
                                                 static_cast<int32_t*>(out), m, t, d);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ---------------------------------------------------------------------------
// rowdot: out (nq, rows) = a (nq, K) · w (rows, K)ᵀ on 16-byte rows, the
// q·Kᵀ scores and the decode GEMV (launch plan: attention.rowdot_plan)
// ---------------------------------------------------------------------------

constexpr int RD_MAX_WARPS = 8;    // ROWDOT_MAX_WARPS: warps of a block, at most
constexpr int RD_UNROLL = 8;       // ROWDOT_UNROLL: 16-byte weight loads a lane has in flight, at most
constexpr int RD_GROUP = 8;        // ROWDOT_GROUP: queries a block accumulates (grid y takes the groups)
constexpr int RD_XREG_CHUNKS = 16;  // ROWDOT_XREG_CHUNKS: activation chunks a lane keeps in registers

struct RowdotArgs {
  const int4* a;  // (nq, chunks): the queries or the activation, 16 bytes a chunk
  const int4* w;  // (rows, chunks): the cache or the weight
  int32_t* out;   // (nq, rows)
  int rows, nq, chunks;
  int lanes;      // lanes of a warp on one row: a power of two, 1 to 32
  int split;      // warps on one row: a power of two; lanes == 32 when above 1
  int iters;      // chunks a lane takes of its row: ceil(chunks / (lanes · split))
};

// One 16-byte chunk of a weight row times the activation's, added to acc:
// four __dp4a on int8 (the hardware's sum wraps mod 2^32), four uint32_t
// multiply-adds on int32.
__device__ __forceinline__ uint32_t dot16(int4 w, int4 x, uint32_t acc, int8_t) {
  int s = static_cast<int>(acc);
  s = __dp4a(w.x, x.x, s);
  s = __dp4a(w.y, x.y, s);
  s = __dp4a(w.z, x.z, s);
  s = __dp4a(w.w, x.w, s);
  return static_cast<uint32_t>(s);
}

__device__ __forceinline__ uint32_t dot16(int4 w, int4 x, uint32_t acc, int32_t) {
  return acc + static_cast<uint32_t>(w.x) * static_cast<uint32_t>(x.x) +
         static_cast<uint32_t>(w.y) * static_cast<uint32_t>(x.y) +
         static_cast<uint32_t>(w.z) * static_cast<uint32_t>(x.z) +
         static_cast<uint32_t>(w.w) * static_cast<uint32_t>(x.w);
}

// A block takes blockDim.x / (lanes · split) rows at a step, grid-stride over
// the rows.  Thread tid sits on slot tid % (lanes · split) of the step's row
// tid / (lanes · split) and takes the row's chunks slot, slot + lanes·split,
// ...: U weight loads are issued before the first multiply.  G: queries
// (1, or RD_GROUP from blockIdx.y · G on).  XREG: the lane's chunks of the
// activation (all of them: iters <= U) are loaded once, beside the first
// weights, and kept for every row it takes; else each batch reads them
// through the read-only path beside its weights.
template <typename T, int U, int G, bool XREG>
__global__ void __launch_bounds__(32 * RD_MAX_WARPS) rowdot(const RowdotArgs p) {
  __shared__ uint32_t part[G][RD_MAX_WARPS];  // split rows: each warp's sums
  const int span = p.lanes * p.split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = tid & (span - 1);
  const int per_step = blockDim.x / span;
  const int m0 = blockIdx.y * G, mg = min(G, p.nq - m0);
  const int4* a = p.a + static_cast<size_t>(m0) * p.chunks;
  const int4 zero = make_int4(0, 0, 0, 0);
  int4 xr[XREG ? G * U : 1];
  if constexpr (XREG) {
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = slot + u * span;
        xr[i * U + u] = i < mg && c < p.chunks ? __ldg(a + static_cast<size_t>(i) * p.chunks + c) : zero;
      }
  }
  for (int base = blockIdx.x * per_step; base < p.rows; base += gridDim.x * per_step) {
    const int row = base + tid / span;
    const bool live = row < p.rows;
    const int4* wr = p.w + static_cast<size_t>(live ? row : 0) * p.chunks;
    uint32_t acc[G];
#pragma unroll
    for (int i = 0; i < G; ++i) acc[i] = 0u;
    for (int it = 0; it < p.iters; it += U) {
      int4 wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = slot + (it + u) * span;
        wv[u] = live && c < p.chunks ? __ldg(wr + c) : zero;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = slot + (it + u) * span;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          int4 xv;
          if constexpr (XREG)
            xv = xr[i * U + u];
          else
            xv = i < mg && c < p.chunks ? __ldg(a + static_cast<size_t>(i) * p.chunks + c) : zero;
          acc[i] = dot16(wv[u], xv, acc[i], T{});
        }
      }
    }
    if (p.split == 1) {
      // the lanes of a row: a butterfly inside each aligned group of `lanes`
      for (int o = 1; o < p.lanes; o <<= 1)
#pragma unroll
        for (int i = 0; i < G; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
      // every lane holds its row's sum: lane r takes row r's, and one store
      // writes the warp's rows in a contiguous run
      const int wrows = 32 / p.lanes;
      const int r0 = base + warp * wrows;
      const int src = (lane & (wrows - 1)) * p.lanes;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const uint32_t v = __shfl_sync(0xffffffffu, acc[i], src);
        if (lane < wrows && i < mg && r0 + lane < p.rows)
          p.out[static_cast<size_t>(m0 + i) * p.rows + r0 + lane] = as_i32(v);
      }
    } else {
      // whole warps on a row: each warp's sum into shared memory, then one
      // thread a (query, row) adds the row's warps and stores
#pragma unroll
      for (int i = 0; i < G; ++i) acc[i] = warp_sum(acc[i]);
      if (lane == 0)
#pragma unroll
        for (int i = 0; i < G; ++i) part[i][warp] = acc[i];
      __syncthreads();
      if (tid < G * per_step) {
        const int i = tid / per_step, r = tid - i * per_step;
        if (i < mg && base + r < p.rows) {
          uint32_t sum = 0u;
          for (int k = 0; k < p.split; ++k) sum += part[i][r * p.split + k];
          p.out[static_cast<size_t>(m0 + i) * p.rows + base + r] = as_i32(sum);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
void launch_rowdot_t(const RowdotArgs& p, bool xreg, int unroll, int group, dim3 grid, dim3 block,
                     cudaStream_t s) {
  if (group == 1) {
    if (!xreg)
      rowdot<T, RD_UNROLL, 1, false><<<grid, block, 0, s>>>(p);
    else if (unroll == 1)
      rowdot<T, 1, 1, true><<<grid, block, 0, s>>>(p);
    else if (unroll == 2)
      rowdot<T, 2, 1, true><<<grid, block, 0, s>>>(p);
    else if (unroll == 4)
      rowdot<T, 4, 1, true><<<grid, block, 0, s>>>(p);
    else
      rowdot<T, 8, 1, true><<<grid, block, 0, s>>>(p);
  } else {
    if (!xreg)
      rowdot<T, RD_UNROLL, RD_GROUP, false><<<grid, block, 0, s>>>(p);
    else if (unroll == 1)
      rowdot<T, 1, RD_GROUP, true><<<grid, block, 0, s>>>(p);
    else
      rowdot<T, 2, RD_GROUP, true><<<grid, block, 0, s>>>(p);
  }
}

// a (nq, K) and w (rows, K), both int8 or both int32 (`bytes`), row-major,
// 16-byte rows and bases; out (nq, rows) int32.  The plan is
// attention.rowdot_plan's; one it does not give is refused.
int launch_rowdot(const void* a, const void* w, void* out, int rows, int nq, int k, int bytes, int lanes,
                  int split, int warps, int unroll, int group, int blocks, cudaStream_t s) {
  const long long row_bytes = static_cast<long long>(k) * bytes;
  const auto pow2 = [](int v) { return v > 0 && (v & (v - 1)) == 0; };
  if ((bytes != 1 && bytes != 4) || k <= 0 || row_bytes % 16 != 0 || !aligned(a, 16) || !aligned(w, 16) ||
      !pow2(lanes) || lanes > 32 || !pow2(split) || (split > 1 && lanes != 32) || !pow2(warps) ||
      warps < split || warps > RD_MAX_WARPS || !pow2(unroll) || unroll > RD_UNROLL ||
      (group != 1 && group != RD_GROUP) || blocks < 1 || (nq + group - 1) / group > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = static_cast<int>(row_bytes / 16);
  const int span = lanes * split;
  const int iters = (chunks + span - 1) / span;
  const bool xreg = iters <= unroll && group * unroll <= RD_XREG_CHUNKS;
  if (!xreg && unroll != RD_UNROLL) return static_cast<int>(cudaErrorInvalidValue);
  const RowdotArgs p{static_cast<const int4*>(a), static_cast<const int4*>(w), static_cast<int32_t*>(out),
                     rows, nq, chunks, lanes, split, iters};
  const dim3 grid(blocks, (nq + group - 1) / group), block(32 * warps);
  if (bytes == 1)
    launch_rowdot_t<int8_t>(p, xreg, unroll, group, grid, block, s);
  else
    launch_rowdot_t<int32_t>(p, xreg, unroll, group, grid, block, s);
  return REPRO_LAUNCH_STATUS();
}

// ---------------------------------------------------------------------------
// softmax_fixedpoint: out (R, T) int32 probabilities with F fraction bits
// ---------------------------------------------------------------------------

constexpr int SM_ROW_WARPS = 8;      // rows path: a warp a row, 8 rows a block
constexpr int SMC_THREADS = 256;     // cluster path: threads of a block
constexpr int SMC_WARPS = SMC_THREADS / 32;
constexpr int SMC_ELEMS = 16;        // cluster path: scores a thread keeps in registers
constexpr int SMC_MAX_CLUSTER = 16;  // blocks of a row's cluster (above 8: non-portable)
constexpr int SMC_PORTABLE_CLUSTER = 8;

// The unnormalized exponential of one score, in the oracle's int32 recipe.
// `lo` is the clamp bound -2^(F+sigma) (the host keeps F + sigma <= 31).
__device__ __forceinline__ int32_t softmax_w(int32_t x, int32_t mx, int sigma, int32_t lo) {
  const int32_t tt = as_i32(static_cast<uint32_t>(x) - static_cast<uint32_t>(mx));
  const int32_t u = max(tt, lo) >> sigma;
  const int32_t sq = as_i32(static_cast<uint32_t>(u) * static_cast<uint32_t>(u)) >> (F + 1);
  int32_t w = as_i32(static_cast<uint32_t>(u) + (1u << F) + static_cast<uint32_t>(sq));
#pragma unroll
  for (int i = 0; i < K; ++i) w = as_i32(static_cast<uint32_t>(w) * static_cast<uint32_t>(w)) >> F;
  return w;
}

// floor(n / s) for n >= 0, as the oracle's `//` (s == 0 only when a row's
// exponentials wrap to a zero sum, which no row of at most 2^25 scores whose
// range fits int32 does; it gives 0).
__device__ __forceinline__ int32_t floor_div(int32_t n, int32_t s) {
  if (s > 0) return n / s;
  if (s == 0) return 0;
  const int64_t q = static_cast<int64_t>(n) / s;  // truncates toward zero
  return static_cast<int32_t>(q * s == n ? q : q - 1);
}

__device__ __forceinline__ int32_t softmax_out(int32_t w, int32_t qn) {
  return as_i32(static_cast<uint32_t>(w) * static_cast<uint32_t>(qn)) >> FI;
}

// Short rows: a warp a row, three passes over it (max, Σw, write), the row
// re-read from L1.
template <typename TX>
__global__ void __launch_bounds__(32 * SM_ROW_WARPS)
softmax_rows(const TX* __restrict__ x, int32_t* __restrict__ out, int r, int t, int sigma, int lo) {
  const int row = blockIdx.x * SM_ROW_WARPS + (threadIdx.x >> 5);
  if (row >= r) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const TX* xr = x + static_cast<size_t>(row) * t;
  int32_t* orow = out + static_cast<size_t>(row) * t;
  int32_t mx = INT32_MIN;
  for (int j = lane; j < t; j += 32) mx = max(mx, static_cast<int32_t>(xr[j]));
  mx = warp_max(mx);
  uint32_t s = 0u;
  for (int j = lane; j < t; j += 32)
    s += static_cast<uint32_t>(softmax_w(static_cast<int32_t>(xr[j]), mx, sigma, lo));
  const int32_t qn = floor_div(1 << (FI + F), as_i32(warp_sum(s)));
  for (int j = lane; j < t; j += 32) orow[j] = softmax_out(softmax_w(static_cast<int32_t>(xr[j]), mx, sigma, lo), qn);
}

// A 16-byte chunk of a row, widened: 4 int32 or 16 int8 scores.
__device__ __forceinline__ void unpack(const int4 raw, int32_t (&v)[4]) {
  v[0] = raw.x;
  v[1] = raw.y;
  v[2] = raw.z;
  v[3] = raw.w;
}

__device__ __forceinline__ int32_t sbyte(int32_t word, int k) {  // signed byte k of a word
  return as_i32(static_cast<uint32_t>(word) << (24 - 8 * k)) >> 24;
}

__device__ __forceinline__ void unpack(const int4 raw, int32_t (&v)[16]) {
  const int32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = sbyte(w[k >> 2], k & 3);
}

// Chunk c of a row: one 16-byte load when `vec` (the row 16-byte aligned,
// T a multiple of a chunk), else element loads, INT32_MIN past the row's end.
template <typename TX, int VEC>
__device__ __forceinline__ void load_chunk(const TX* __restrict__ xr, int c, int t, int vec, int32_t (&v)[VEC]) {
  if (vec) {
    unpack(__ldg(reinterpret_cast<const int4*>(xr) + c), v);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = c * VEC + k < t ? static_cast<int32_t>(xr[c * VEC + k]) : INT32_MIN;
  }
}

template <int VEC>
__device__ __forceinline__ void store_chunk(int32_t* __restrict__ orow, int c, int t, int vec, const int32_t (&o)[VEC]) {
  if (vec) {
    int4* dst = reinterpret_cast<int4*>(orow + static_cast<size_t>(c) * VEC);
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) dst[q] = make_int4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (c * VEC + k < t) orow[c * VEC + k] = o[k];
  }
}

// One value a thread → its max (MAX) or uint32 sum over the whole cluster,
// returned to every thread: warp shuffles; each warp's result stored into
// slot rank · SMC_WARPS + warp of `slots` in every block of the cluster
// (distributed shared memory); one cluster barrier; then every warp reduces
// its own block's copy.  No block reads another's shared memory, so none
// waits for the others at its end.  A row takes one `slots` array per
// reduction: a block writes a reduction's array again only after the row's
// next barrier, which every block reaches after it has read that array.
template <bool MAX>
__device__ __forceinline__ int32_t cluster_reduce(int32_t v, int32_t* slots, cg::cluster_group& cluster) {
  const int lane = threadIdx.x & 31;
  const int blocks = static_cast<int>(cluster.num_blocks());
  v = MAX ? warp_max(v) : as_i32(warp_sum(static_cast<uint32_t>(v)));
  if (lane < blocks)
    *cluster.map_shared_rank(slots + cluster.block_rank() * SMC_WARPS + (threadIdx.x >> 5), lane) = v;
  cluster.sync();
  int32_t acc = MAX ? INT32_MIN : 0;
  for (int i = lane; i < blocks * SMC_WARPS; i += 32)
    acc = MAX ? max(acc, slots[i]) : as_i32(static_cast<uint32_t>(acc) + static_cast<uint32_t>(slots[i]));
  return MAX ? warp_max(acc) : as_i32(warp_sum(static_cast<uint32_t>(acc)));
}

// Long rows: a cluster of gridDim.x blocks a row (row blockIdx.y, then every
// gridDim.y-th), block rank b on the 16-byte chunks [b·cpb, (b+1)·cpb) of it,
// chunk c + k·SMC_THREADS to thread c.  REGS: a thread keeps its scores, then
// their exponentials, in registers (at most SMC_ELEMS); else each pass
// re-reads its chunks (from L2) and the write recomputes the exponentials.
template <typename TX, bool REGS>
__global__ void __launch_bounds__(SMC_THREADS)
softmax_cluster(const TX* __restrict__ x, int32_t* __restrict__ out, int r, int t, int sigma, int lo, int vec,
                int chunks_per_block) {
  constexpr int VEC = 16 / sizeof(TX);
  constexpr int NV = REGS ? SMC_ELEMS / VEC : 1;
  __shared__ int32_t max_slots[SMC_MAX_CLUSTER * SMC_WARPS];  // every warp's max, from every block
  __shared__ int32_t sum_slots[SMC_MAX_CLUSTER * SMC_WARPS];  // and its Σw
  cg::cluster_group cluster = cg::this_cluster();
  const int nchunks = (t + VEC - 1) / VEC;
  const int c0 = static_cast<int>(cluster.block_rank()) * chunks_per_block + threadIdx.x;
  const int c1 = min(nchunks, static_cast<int>(cluster.block_rank()) * chunks_per_block + chunks_per_block);
  for (int row = blockIdx.y; row < r; row += gridDim.y) {
    const TX* xr = x + static_cast<size_t>(row) * t;
    int32_t* orow = out + static_cast<size_t>(row) * t;
    int32_t v[NV][VEC];
    int32_t mx = INT32_MIN;
    if constexpr (REGS) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = c0 + k * SMC_THREADS;
        if (c < c1) {
          load_chunk<TX, VEC>(xr, c, t, vec, v[k]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[k][e] = INT32_MIN;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) mx = max(mx, v[k][e]);
      }
    } else {
      for (int c = c0; c < c1; c += SMC_THREADS) {
        load_chunk<TX, VEC>(xr, c, t, vec, v[0]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) mx = max(mx, v[0][e]);
      }
    }
    mx = cluster_reduce<true>(mx, max_slots, cluster);

    uint32_t s = 0u;
    if constexpr (REGS) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = c0 + k * SMC_THREADS;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[k][e] = softmax_w(v[k][e], mx, sigma, lo);
          if (c < c1 && c * VEC + e < t) s += static_cast<uint32_t>(v[k][e]);
        }
      }
    } else {
      for (int c = c0; c < c1; c += SMC_THREADS) {
        load_chunk<TX, VEC>(xr, c, t, vec, v[0]);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (c * VEC + e < t) s += static_cast<uint32_t>(softmax_w(v[0][e], mx, sigma, lo));
      }
    }
    const int32_t qn = floor_div(1 << (FI + F), cluster_reduce<false>(as_i32(s), sum_slots, cluster));

    int32_t o[VEC];
    if constexpr (REGS) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = c0 + k * SMC_THREADS;
        if (c < c1) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[e] = softmax_out(v[k][e], qn);
          store_chunk<VEC>(orow, c, t, vec, o);
        }
      }
    } else {
      for (int c = c0; c < c1; c += SMC_THREADS) {
        load_chunk<TX, VEC>(xr, c, t, vec, v[0]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = softmax_out(softmax_w(v[0][e], mx, sigma, lo), qn);
        store_chunk<VEC>(orow, c, t, vec, o);
      }
    }
  }
}

// A cluster launch of softmax_cluster<TX, REGS> (cudaLaunchKernelEx with a
// cluster-dimension attribute); a cluster above 8 blocks opts in to the
// non-portable size once per instance.
template <typename TX, bool REGS>
int launch_softmax_cluster(cudaStream_t s, const void* x, void* out, int r, int t, int sigma, int lo, int vec,
                           int chunks_per_block, int cluster, int rows) {
  void (*kernel)(const TX*, int32_t*, int, int, int, int, int, int) = softmax_cluster<TX, REGS>;
  static bool opted_in = false;
  if (cluster > SMC_PORTABLE_CLUSTER && !opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, rows, 1);
  cfg.blockDim = dim3(SMC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TX*>(x), static_cast<int32_t*>(out), r,
                                           t, sigma, lo, vec, chunks_per_block);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the status is returned here
    return static_cast<int>(e);
  }
  return REPRO_LAUNCH_STATUS();
}

// ---------------------------------------------------------------------------
// attention_pv: out (M, Dv) = (p (M, T) · v (T, Dv)) >> shift
// ---------------------------------------------------------------------------

constexpr int PV_THREADS = 256;
constexpr int PV_WARPS = PV_THREADS / 32;
constexpr int PV_UNROLL = 4;           // value rows a packed-path thread loads before it multiplies
constexpr int PV_MAX_GROUP = 4;        // queries a block accumulates (blockIdx.y picks the group)
constexpr int PV_PACKED_MAX_DV = 256;  // packed path: Dv / 16 threads a row, dividing 32

struct PvArgs {
  const void* p;
  const void* v;
  uint32_t* partial;     // blocks along T × npad words
  unsigned int* ticket;  // 0 at every launch's start and end
  int32_t* out;
  int m, t, dv;
  int rows_per_block;
  int npad;  // M·Dv rounded up to a multiple of 4
  int shift;
};

// Takes a ticket: an atomic add of 1 at device scope with acquire-release
// order, so that the block's writes before it (ordered by a block barrier)
// are visible to whoever takes a later ticket, and the earlier takers'
// writes to this thread (a cheaper fence than __threadfence's sequential
// consistency).
__device__ __forceinline__ unsigned int ticket_acq_rel(unsigned int* ticket) {
  unsigned int old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

// The launch's last step.  Every block has written its uint32 partial sums
// (row blockIdx.x of `partial`); the last block to take the ticket adds the
// rows, mod 2^32 in any order, applies the arithmetic shift to the full sums,
// writes out and sets the ticket back to 0.  The ticket is the wrapper's, one
// per device, and serves one stream at a time.
__device__ void pv_finish(const PvArgs& a) {
  __shared__ bool last;
  __shared__ uint4 red[PV_THREADS];
  const int tid = threadIdx.x;
  __syncthreads();  // the block's partials are written
  if (tid == 0)     // release them (with the barrier, for the whole block); acquire the others'
    last = ticket_acq_rel(a.ticket) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  const int nq = a.npad / 4, n = a.m * a.dv;
  const uint4* part = reinterpret_cast<const uint4*>(a.partial);
  const int lanes = nq < PV_THREADS ? PV_THREADS / nq : 1;  // threads adding one quad of outputs
  const int per_round = PV_THREADS / lanes;
  for (int base = 0; base < nq; base += per_round) {
    const int q = base + tid % per_round, g = tid / per_round;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    if (q < nq && g < lanes) {
#pragma unroll 4
      for (int b = g; b < static_cast<int>(gridDim.x); b += lanes) {
        const uint4 w = __ldcg(part + static_cast<size_t>(b) * nq + q);  // from L2: other SMs wrote it
        acc.x += w.x;
        acc.y += w.y;
        acc.z += w.z;
        acc.w += w.w;
      }
    }
    red[tid] = acc;
    __syncthreads();
    if (g == 0 && q < nq) {
      for (int j = 1; j < lanes; ++j) {
        const uint4 w = red[tid + j * per_round];
        acc.x += w.x;
        acc.y += w.y;
        acc.z += w.z;
        acc.w += w.w;
      }
      const uint32_t sums[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < n) a.out[4 * q + e] = as_i32(sums[e]) >> a.shift;
    }
    __syncthreads();
  }
  if (tid == 0) *a.ticket = 0u;
}

// int32 p, int8 v, Dv / 16 dividing 32, v 16-byte aligned: a thread takes 16
// columns of a value row (one 16-byte load), Dv / 16 threads a row, so a
// block covers PV_THREADS / (Dv / 16) rows at a step with every thread busy;
// PV_UNROLL rows are in flight before any is multiplied.  G queries
// (from blockIdx.y · G) are accumulated in registers.
template <int G>
__global__ void __launch_bounds__(PV_THREADS) pv_packed(const PvArgs a) {
  __shared__ uint32_t warp_part[PV_WARPS][G * PV_PACKED_MAX_DV];
  const int32_t* p = static_cast<const int32_t*>(a.p);
  const int4* v16 = static_cast<const int4*>(a.v);
  const int lanes = a.dv >> 4;                // threads a row
  const int c = threadIdx.x & (lanes - 1);    // this thread's 16 columns
  const int step = PV_THREADS / lanes;        // rows a block covers at once
  const int m0 = blockIdx.y * G, mg = min(G, a.m - m0);
  const int r0 = blockIdx.x * a.rows_per_block, r1 = min(a.t, r0 + a.rows_per_block);
  uint32_t acc[G][16];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[i][e] = 0u;
  for (int r = r0 + threadIdx.x / lanes; r < r1; r += PV_UNROLL * step) {
    int4 vv[PV_UNROLL];
    uint32_t pp[PV_UNROLL][G];
#pragma unroll
    for (int u = 0; u < PV_UNROLL; ++u) {
      const int row = r + u * step;
      const bool ok = row < r1;
      vv[u] = ok ? __ldg(v16 + static_cast<size_t>(row) * lanes + c) : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < G; ++i)
        pp[u][i] = ok && i < mg ? static_cast<uint32_t>(__ldg(p + static_cast<size_t>(m0 + i) * a.t + row)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < PV_UNROLL; ++u) {
      const int32_t w[4] = {vv[u].x, vv[u].y, vv[u].z, vv[u].w};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const uint32_t ve = static_cast<uint32_t>(sbyte(w[e >> 2], e & 3));
#pragma unroll
        for (int i = 0; i < G; ++i) acc[i][e] += pp[u][i] * ve;
      }
    }
  }
  // across the warp's rows: the threads on the same columns are `lanes` apart
  for (int o = lanes; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < lanes) {  // lane == c: the warp's first row
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < 16; ++e) warp_part[warp][i * a.dv + 16 * c + e] = acc[i][e];
  }
  __syncthreads();
  // across the block's warps, into this block's partial sums
  for (int idx = threadIdx.x; idx < mg * a.dv; idx += PV_THREADS) {
    uint32_t s = 0u;
#pragma unroll
    for (int w = 0; w < PV_WARPS; ++w) s += warp_part[w][idx];
    a.partial[static_cast<size_t>(blockIdx.x) * a.npad + static_cast<size_t>(m0) * a.dv + idx] = s;
  }
  pv_finish(a);
}

// Any int8/int32 mix, any Dv and alignment: a thread a column (column passes
// when Dv > PV_THREADS) and PV_THREADS / min(Dv, PV_THREADS) threads a column,
// each on every such row of the block's range; shared memory adds a column's
// threads.  G queries as in pv_packed.
template <typename TP, typename TV, int G>
__global__ void __launch_bounds__(PV_THREADS) pv_generic(const PvArgs a) {
  __shared__ uint32_t col_part[G][PV_THREADS];
  const TP* p = static_cast<const TP*>(a.p);
  const TV* v = static_cast<const TV*>(a.v);
  const int cols = min(a.dv, PV_THREADS);
  const int lanes = PV_THREADS / cols;  // threads on one column
  const int j0 = threadIdx.x % cols, s = threadIdx.x / cols;
  const int m0 = blockIdx.y * G, mg = min(G, a.m - m0);
  const int r0 = blockIdx.x * a.rows_per_block, r1 = min(a.t, r0 + a.rows_per_block);
  for (int jb = 0; jb < a.dv; jb += cols) {
    const int j = jb + j0;
    uint32_t acc[G];
#pragma unroll
    for (int i = 0; i < G; ++i) acc[i] = 0u;
    if (s < lanes && j < a.dv) {
      for (int r = r0 + s; r < r1; r += lanes) {
        const uint32_t vv = widen(v[static_cast<size_t>(r) * a.dv + j]);
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (i < mg) acc[i] += widen(p[static_cast<size_t>(m0 + i) * a.t + r]) * vv;
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) col_part[i][threadIdx.x] = acc[i];
    __syncthreads();
    if (s == 0 && j < a.dv) {
      for (int i = 0; i < mg; ++i) {
        uint32_t sum = 0u;
        for (int l = 0; l < lanes; ++l) sum += col_part[i][j0 + l * cols];
        a.partial[static_cast<size_t>(blockIdx.x) * a.npad + static_cast<size_t>(m0 + i) * a.dv + j] = sum;
      }
    }
    __syncthreads();
  }
  pv_finish(a);
}

template <typename TP, typename TV>
void launch_pv_generic(int group, dim3 grid, cudaStream_t s, const PvArgs& a) {
  if (group == 1)
    pv_generic<TP, TV, 1><<<grid, PV_THREADS, 0, s>>>(a);
  else if (group == 2)
    pv_generic<TP, TV, 2><<<grid, PV_THREADS, 0, s>>>(a);
  else
    pv_generic<TP, TV, 4><<<grid, PV_THREADS, 0, s>>>(a);
}

// ---------------------------------------------------------------------------
// decode_gemv: out (M,) = w (M, K) · x (K,)
// ---------------------------------------------------------------------------

constexpr int GEMV_WARPS = 8;
constexpr int GEMV_THREADS = 32 * GEMV_WARPS;
constexpr int GEMV_STAGE_BYTES = 48 * 1024;  // static shared memory a block may take unasked

// Any int8/int32 mix, any K, any alignment: element loads.  `stage`: copy x
// into shared memory first (the host sets it when K elements fit).
template <typename TW, typename TX>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_generic(const TW* __restrict__ w, const TX* __restrict__ x, int32_t* __restrict__ out,
             int m, int k, int stage) {
  extern __shared__ int4 gemv_smem[];
  const TX* xs = x;
  if (stage) {
    TX* buf = reinterpret_cast<TX*>(gemv_smem);
    for (int j = threadIdx.x; j < k; j += GEMV_THREADS) buf[j] = x[j];
    __syncthreads();
    xs = buf;
  }
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * GEMV_WARPS + (threadIdx.x >> 5); row < m; row += gridDim.x * GEMV_WARPS) {
    const TW* wr = w + static_cast<size_t>(row) * k;
    uint32_t acc = 0u;
    for (int j = lane; j < k; j += 32) acc += widen(wr[j]) * widen(xs[j]);
    acc = warp_sum(acc);
    if (lane == 0) out[row] = as_i32(acc);
  }
}

template <typename TW, typename TX>
void launch_gemv_generic(unsigned int blocks, size_t smem, cudaStream_t s, const void* w, const void* x,
                         void* out, int m, int k, int stage) {
  gemv_generic<TW, TX><<<blocks, GEMV_THREADS, smem, s>>>(static_cast<const TW*>(w),
                                                          static_cast<const TX*>(x),
                                                          static_cast<int32_t*>(out), m, k, stage);
}

// ---------------------------------------------------------------------------
// kv_append: out (T, D) = cache with the rows where sel != 0 set to `nw`
// ---------------------------------------------------------------------------

constexpr int KV_THREADS = 256;

template <typename TC, typename TN, typename TS>
__global__ void __launch_bounds__(KV_THREADS)
kv_append_generic(const TC* __restrict__ cache, const TN* __restrict__ nw,
                  const TS* __restrict__ sel, TC* __restrict__ out, int n, int d) {
  const int stride = gridDim.x * KV_THREADS;
  for (int i = blockIdx.x * KV_THREADS + threadIdx.x; i < n; i += stride) {
    const int row = i / d;
    // the int32 → int8 cast keeps the low byte, as XLA's convert does
    out[i] = sel[row] != 0 ? static_cast<TC>(static_cast<int32_t>(nw[i - row * d])) : cache[i];
  }
}

// int8 cache and row, D % 16 == 0, 16-byte aligned: a 16-byte chunk a
// thread, loaded together with its row's selector byte and the row's chunk
// of `nw` (an L1 hit after the first), and selected without a branch, so no
// load waits on another and none can be sunk into a branch.
template <typename TS>
__global__ void __launch_bounds__(KV_THREADS)
kv_append_i8_vec(const int4* __restrict__ cache, const int4* __restrict__ nw,
                 const TS* __restrict__ sel, int4* __restrict__ out, int n16, int d16) {
  const int i = blockIdx.x * KV_THREADS + threadIdx.x;
  if (i >= n16) return;
  const int row = i / d16;
  const int4 c = cache[i];
  const int4 v = nw[i - row * d16];
  const int m = -static_cast<int>(sel[row] != 0);  // all ones on a selected row
  out[i] = make_int4(c.x ^ ((c.x ^ v.x) & m), c.y ^ ((c.y ^ v.y) & m), c.z ^ ((c.z ^ v.z) & m),
                     c.w ^ ((c.w ^ v.w) & m));
}

template <typename TC, typename TN, typename TS>
void launch_kv_generic(int blocks, cudaStream_t s, const void* cache, const void* nw, const void* sel,
                       void* out, int n, int d) {
  kv_append_generic<TC, TN, TS><<<blocks, KV_THREADS, 0, s>>>(
      static_cast<const TC*>(cache), static_cast<const TN*>(nw), static_cast<const TS*>(sel),
      static_cast<TC*>(out), n, d);
}

template <typename TC, typename TN>
void launch_kv_by_sel(int sel_bytes, int blocks, cudaStream_t s, const void* cache, const void* nw,
                      const void* sel, void* out, int n, int d) {
  if (sel_bytes == 1)
    launch_kv_generic<TC, TN, int8_t>(blocks, s, cache, nw, sel, out, n, d);
  else
    launch_kv_generic<TC, TN, int32_t>(blocks, s, cache, nw, sel, out, n, d);
}

}  // namespace

// q (M, D), k (T, D): int8 (bytes 1) or int32 (bytes 4), row-major; out (M, T) int32.
// The launch plan is attention.rowdot_plan's: `vec` takes rowdot (q and k
// both int8 or both int32, 16-byte rows, both 16-byte aligned) with its
// lanes, split, warps, unroll, group and blocks; else qk_generic, a thread a
// row and groups of QK_GROUP queries on grid y, which ignores the rest.
extern "C" int attention_qk(const void* q, const void* k, void* out, int m, int t, int d, int q_bytes,
                            int k_bytes, int vec, int lanes, int split, int warps, int unroll, int group,
                            int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (q_bytes != k_bytes) return static_cast<int>(cudaErrorInvalidValue);
    return launch_rowdot(q, k, out, t, m, d, k_bytes, lanes, split, warps, unroll, group, blocks, s);
  }
  const dim3 grid(repro_grid(t, QK_THREADS), (m + QK_GROUP - 1) / QK_GROUP);
  if (q_bytes == 1 && k_bytes == 1) {
    launch_qk_generic<int8_t, int8_t>(grid, s, q, k, out, m, t, d);
  } else if (q_bytes == 1) {
    launch_qk_generic<int8_t, int32_t>(grid, s, q, k, out, m, t, d);
  } else if (k_bytes == 1) {
    launch_qk_generic<int32_t, int8_t>(grid, s, q, k, out, m, t, d);
  } else {
    launch_qk_generic<int32_t, int32_t>(grid, s, q, k, out, m, t, d);
  }
  return REPRO_LAUNCH_STATUS();
}

// x (R, T) int8 or int32; out (R, T) int32.  0 <= sigma, sigma + F <= 31.
// The launch plan is attention.softmax_plan's: `cluster` 0 takes the rows
// kernel over `blocks` blocks; else a cluster of `cluster` blocks a row
// (cudaLaunchKernelEx), `blocks` rows at once (grid y), each block on
// `chunks_per_block` 16-byte chunks of the row, read and written 16 bytes at
// a time when `vec` (x and out 16-byte aligned, T a multiple of a chunk),
// kept in registers when `regs`.
extern "C" int softmax_fixedpoint(const void* x, void* out, int r, int t, int sigma, int x_bytes, int cluster,
                                  int chunks_per_block, int regs, int vec, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lo = sigma + F == 31 ? INT32_MIN : -(1 << (sigma + F));
  if (cluster == 0) {
    if (x_bytes == 1)
      softmax_rows<int8_t><<<blocks, 32 * SM_ROW_WARPS, 0, s>>>(static_cast<const int8_t*>(x),
                                                                static_cast<int32_t*>(out), r, t, sigma, lo);
    else
      softmax_rows<int32_t><<<blocks, 32 * SM_ROW_WARPS, 0, s>>>(static_cast<const int32_t*>(x),
                                                                 static_cast<int32_t*>(out), r, t, sigma, lo);
    return REPRO_LAUNCH_STATUS();
  }
  const int vec_elems = 16 / x_bytes;
  const long long chunks = (static_cast<long long>(t) + vec_elems - 1) / vec_elems;
  if (cluster < 0 || cluster > SMC_MAX_CLUSTER || blocks < 1 || blocks > 65535 || chunks_per_block < 1 ||
      static_cast<long long>(cluster) * chunks_per_block < chunks ||
      (vec && (t % vec_elems != 0 || !aligned(x, 16) || !aligned(out, 16))) ||
      (regs && chunks_per_block > SMC_THREADS * (SMC_ELEMS / vec_elems)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_bytes == 1)
    return regs ? launch_softmax_cluster<int8_t, true>(s, x, out, r, t, sigma, lo, vec, chunks_per_block, cluster, blocks)
                : launch_softmax_cluster<int8_t, false>(s, x, out, r, t, sigma, lo, vec, chunks_per_block, cluster,
                                                        blocks);
  return regs ? launch_softmax_cluster<int32_t, true>(s, x, out, r, t, sigma, lo, vec, chunks_per_block, cluster, blocks)
              : launch_softmax_cluster<int32_t, false>(s, x, out, r, t, sigma, lo, vec, chunks_per_block, cluster,
                                                       blocks);
}

// p (M, T), v (T, Dv): int8 or int32 (bytes 1 or 4), row-major; out (M, Dv)
// int32.  The launch plan is attention.pv_plan's: the packed kernel or the
// generic one, `group` queries a block (1, 2 or 4; grid y takes the groups),
// `rows_per_block` rows of T a block and `blocks` blocks along T.
// `partial` holds blocks × npad words (npad: M·Dv rounded up to a multiple
// of 4; 16-byte aligned); `ticket` is a word that is 0 at every launch's
// start and end.  0 <= shift <= 31.
extern "C" int attention_pv(const void* p, const void* v, void* partial, void* ticket, void* out, int m, int t,
                            int dv, int shift, int p_bytes, int v_bytes, int packed, int group, int rows_per_block,
                            int blocks, int npad, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = dv / 16;
  const bool packs = p_bytes == 4 && v_bytes == 1 && dv % 16 == 0 && dv <= PV_PACKED_MAX_DV && lanes > 0 &&
                     32 % lanes == 0 && aligned(v, 16);
  const int groups = group > 0 ? (m + group - 1) / group : 0;
  if ((packed && !packs) || (group != 1 && group != 2 && group != PV_MAX_GROUP) || groups > 65535 ||
      npad % 4 != 0 || npad < m * dv || !aligned(partial, 16) || blocks < 1 || rows_per_block < 1 ||
      static_cast<long long>(blocks) * rows_per_block < t)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks, groups);
  const PvArgs a{p, v, static_cast<uint32_t*>(partial), static_cast<unsigned int*>(ticket),
                 static_cast<int32_t*>(out), m, t, dv, rows_per_block, npad, shift};
  if (packed) {
    if (group == 1)
      pv_packed<1><<<grid, PV_THREADS, 0, s>>>(a);
    else if (group == 2)
      pv_packed<2><<<grid, PV_THREADS, 0, s>>>(a);
    else
      pv_packed<PV_MAX_GROUP><<<grid, PV_THREADS, 0, s>>>(a);
  } else if (p_bytes == 1 && v_bytes == 1) {
    launch_pv_generic<int8_t, int8_t>(group, grid, s, a);
  } else if (p_bytes == 1) {
    launch_pv_generic<int8_t, int32_t>(group, grid, s, a);
  } else if (v_bytes == 1) {
    launch_pv_generic<int32_t, int8_t>(group, grid, s, a);
  } else {
    launch_pv_generic<int32_t, int32_t>(group, grid, s, a);
  }
  return REPRO_LAUNCH_STATUS();
}

// cache (T, D) and out: int8 or int32 (cache_bytes); nw (D,): int8 or int32;
// sel (T,): 1-byte (int8, bool) or int32.  out must not alias cache.  The
// launch plan is attention.kv_plan's: `vec` takes kv_append_i8_vec (int8
// cache and row, D % 16 == 0, cache, row and out 16-byte aligned), a chunk
// a thread; else the generic kernel; `blocks` blocks.
extern "C" int kv_append(const void* cache, const void* nw, const void* sel, void* out, int t, int d,
                         int cache_bytes, int new_bytes, int sel_bytes, int vec, int blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = t * d;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    const int n16 = n / 16;
    if (cache_bytes != 1 || new_bytes != 1 || d % 16 != 0 || !aligned(cache, 16) || !aligned(nw, 16) ||
        !aligned(out, 16) || static_cast<long long>(blocks) * KV_THREADS < n16)
      return static_cast<int>(cudaErrorInvalidValue);
    if (sel_bytes == 1)
      kv_append_i8_vec<int8_t><<<blocks, KV_THREADS, 0, s>>>(
          static_cast<const int4*>(cache), static_cast<const int4*>(nw), static_cast<const int8_t*>(sel),
          static_cast<int4*>(out), n16, d / 16);
    else
      kv_append_i8_vec<int32_t><<<blocks, KV_THREADS, 0, s>>>(
          static_cast<const int4*>(cache), static_cast<const int4*>(nw), static_cast<const int32_t*>(sel),
          static_cast<int4*>(out), n16, d / 16);
  } else if (cache_bytes == 1 && new_bytes == 1) {
    launch_kv_by_sel<int8_t, int8_t>(sel_bytes, blocks, s, cache, nw, sel, out, n, d);
  } else if (cache_bytes == 1) {
    launch_kv_by_sel<int8_t, int32_t>(sel_bytes, blocks, s, cache, nw, sel, out, n, d);
  } else if (new_bytes == 1) {
    launch_kv_by_sel<int32_t, int8_t>(sel_bytes, blocks, s, cache, nw, sel, out, n, d);
  } else {
    launch_kv_by_sel<int32_t, int32_t>(sel_bytes, blocks, s, cache, nw, sel, out, n, d);
  }
  return REPRO_LAUNCH_STATUS();
}

// w (M, K), x (K,): int8 (bytes 1) or int32 (bytes 4), w row-major; out (M,) int32.
// The launch plan is attention.rowdot_plan's: `vec` takes rowdot (w and x
// both int8 or both int32, 16-byte rows, both 16-byte aligned; group 1);
// else gemv_generic, a warp a row, x staged in shared memory when it fits
// GEMV_STAGE_BYTES, which ignores the rest.
extern "C" int decode_gemv(const void* w, const void* x, void* out, int m, int k, int w_bytes, int x_bytes,
                           int vec, int lanes, int split, int warps, int unroll, int group, int blocks,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (w_bytes != x_bytes || group != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_rowdot(x, w, out, m, 1, k, w_bytes, lanes, split, warps, unroll, group, blocks, s);
  }
  const unsigned int grid = repro_grid(m, GEMV_WARPS);
  const long long x_size = static_cast<long long>(k) * x_bytes;
  const int stage = x_size <= GEMV_STAGE_BYTES ? 1 : 0;
  const size_t smem = stage ? static_cast<size_t>((x_size + 15) / 16 * 16) : 0;
  if (w_bytes == 1 && x_bytes == 1) {
    launch_gemv_generic<int8_t, int8_t>(grid, smem, s, w, x, out, m, k, stage);
  } else if (w_bytes == 1) {
    launch_gemv_generic<int8_t, int32_t>(grid, smem, s, w, x, out, m, k, stage);
  } else if (x_bytes == 1) {
    launch_gemv_generic<int32_t, int8_t>(grid, smem, s, w, x, out, m, k, stage);
  } else {
    launch_gemv_generic<int32_t, int32_t>(grid, smem, s, w, x, out, m, k, stage);
  }
  return REPRO_LAUNCH_STATUS();
}
