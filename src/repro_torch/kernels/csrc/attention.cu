// Integer attention decode kernels: q·Kᵀ scores, the fixed-point row softmax,
// the probability-weighted value mix p·V with its arithmetic shift, the
// single-token decode projection, and the KV-cache row append.
//
// Replaces the Pallas bodies of src/repro/kernels/attention.py:
//   _qk_kernel (48, attention_qk)          → qk_* below
//   _softmax_kernel (88, softmax_fixedpoint) → softmax_kernel
//   _pv_kernel (145, attention_pv)          → pv_partial + pv_finalize
//   _gemv_kernel (182, decode_gemv)         → gemv_*
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
//  * qk: a tall GEMV.  One thread per cache row, each row read once (16-byte
//    loads when D % 16 == 0), up to 8 queries per thread accumulated with
//    __dp4a on int8; the query words are broadcast reads that stay in L1.
//  * softmax: one block per row, three passes (max, Σw, write), the row
//    re-read from L1/L2.  The normaliser q = 2^(FI+F) // Σw is an exact
//    integer floor division, as in the oracle: the Pallas body's restoring
//    division shifts Σw left by up to FI bits in int32 and wraps once a row
//    holds 2^17 near-equal scores.  With one row (M = 1) only one block runs.
//  * pv: a reduction over a long T for only M·Dv outputs, so T is split into
//    chunks, one block each, writing uint32 partial sums; a second kernel
//    adds the partials (order-free mod 2^32, so bit-exact) and applies the
//    shift to the full sum, never to a partial.
//  * decode_gemv: (M, K) weights × (K,) activation, a GEMV bound by the
//    weight bytes (Qwen2-0.5B's tied LM head, (151936, 896) int8, moves
//    136.1 MB: 40.6 µs).  One warp per output row, its lanes on neighbouring
//    16-byte chunks of the row (int8, K % 16 == 0, aligned rows: __dp4a) or
//    on neighbouring elements (every other case); the activation is staged
//    once per block in shared memory when it fits in 48 KB, else read
//    through L1.  Lanes add in uint32_t and a __shfl_xor_sync tree sums them:
//    the wrap makes the order free.
//  * kv_append: a copy of the cache with the selected rows replaced, a new
//    tensor (Programs replay the append, so the input is never written).
//    Every nonzero selector entry is honoured.  int8 caches go 16 bytes a
//    thread when D % 16 == 0.
#include "common.cuh"

namespace {

constexpr int F = 6;    // SOFTMAX_F: fraction bits of exponentials and outputs
constexpr int K = 3;    // SOFTMAX_K: range-reduction squarings
constexpr int FI = 8;   // SOFTMAX_FI: extra fraction bits of the reciprocal

template <typename T>
__device__ __forceinline__ uint32_t widen(T v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}

__device__ __forceinline__ int32_t as_i32(uint32_t v) { return static_cast<int32_t>(v); }

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

// int8 × int8 with D % 16 == 0, q 4-byte and k 16-byte aligned: a key row is
// loaded 16 bytes at a time, four products per __dp4a.
__global__ void __launch_bounds__(QK_THREADS)
qk_i8_packed(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
             int32_t* __restrict__ out, int m, int t, int d) {
  const int m0 = blockIdx.y * QK_GROUP;
  const int mg = min(QK_GROUP, m - m0);
  const int words = d / 4;
  const int* qw = reinterpret_cast<const int*>(q) + static_cast<size_t>(m0) * words;
  const int stride = gridDim.x * QK_THREADS;
  for (int row = blockIdx.x * QK_THREADS + threadIdx.x; row < t; row += stride) {
    int acc[QK_GROUP];
#pragma unroll
    for (int i = 0; i < QK_GROUP; ++i) acc[i] = 0;
    const int4* kr = reinterpret_cast<const int4*>(k + static_cast<size_t>(row) * d);
    for (int w4 = 0; w4 < words / 4; ++w4) {
      const int4 kv = kr[w4];
#pragma unroll
      for (int i = 0; i < QK_GROUP; ++i) {
        if (i < mg) {
          const int* qi = qw + i * words + 4 * w4;
          acc[i] = __dp4a(kv.x, qi[0], acc[i]);
          acc[i] = __dp4a(kv.y, qi[1], acc[i]);
          acc[i] = __dp4a(kv.z, qi[2], acc[i]);
          acc[i] = __dp4a(kv.w, qi[3], acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < QK_GROUP; ++i)
      if (i < mg) out[static_cast<size_t>(m0 + i) * t + row] = acc[i];
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
// softmax_fixedpoint: out (R, T) int32 probabilities with F fraction bits
// ---------------------------------------------------------------------------

constexpr int SM_THREADS = 512;

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

template <typename TX>
__global__ void __launch_bounds__(SM_THREADS)
softmax_kernel(const TX* __restrict__ x, int32_t* __restrict__ out, int t, int sigma, int lo) {
  __shared__ int32_t red[SM_THREADS];
  const TX* xr = x + static_cast<size_t>(blockIdx.x) * t;
  int32_t* orow = out + static_cast<size_t>(blockIdx.x) * t;
  const int tid = threadIdx.x;

  int32_t mx = INT32_MIN;
  for (int j = tid; j < t; j += SM_THREADS) mx = max(mx, static_cast<int32_t>(xr[j]));
  red[tid] = mx;
  __syncthreads();
  for (int h = SM_THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] = max(red[tid], red[tid + h]);
    __syncthreads();
  }
  mx = red[0];
  __syncthreads();

  uint32_t s = 0u;
  for (int j = tid; j < t; j += SM_THREADS)
    s += static_cast<uint32_t>(softmax_w(static_cast<int32_t>(xr[j]), mx, sigma, lo));
  red[tid] = as_i32(s);
  __syncthreads();
  for (int h = SM_THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) red[tid] = as_i32(static_cast<uint32_t>(red[tid]) + static_cast<uint32_t>(red[tid + h]));
    __syncthreads();
  }
  const int32_t qn = floor_div(1 << (FI + F), red[0]);

  for (int j = tid; j < t; j += SM_THREADS) {
    const int32_t w = softmax_w(static_cast<int32_t>(xr[j]), mx, sigma, lo);
    orow[j] = as_i32(static_cast<uint32_t>(w) * static_cast<uint32_t>(qn)) >> FI;
  }
}

// ---------------------------------------------------------------------------
// attention_pv: out (M, Dv) = (p (M, T) · v (T, Dv)) >> shift
// ---------------------------------------------------------------------------

constexpr int PV_THREADS = 256;
constexpr int FIN_THREADS = 256;

template <typename TP, typename TV>
__global__ void __launch_bounds__(PV_THREADS)
pv_partial(const TP* __restrict__ p, const TV* __restrict__ v, uint32_t* __restrict__ partial,
           int m, int t, int dv, int chunk) {
  const int t0 = blockIdx.x * chunk;
  const int t1 = min(t, t0 + chunk);
  const int n = m * dv;
  uint32_t* part = partial + static_cast<size_t>(blockIdx.x) * n;
  for (int idx = threadIdx.x; idx < n; idx += PV_THREADS) {
    const int mi = idx / dv, j = idx % dv;
    const TP* pr = p + static_cast<size_t>(mi) * t;
    uint32_t acc = 0u;
    for (int r = t0; r < t1; ++r) acc += widen(pr[r]) * widen(v[static_cast<size_t>(r) * dv + j]);
    part[idx] = acc;
  }
}

__global__ void __launch_bounds__(FIN_THREADS)
pv_finalize(const uint32_t* __restrict__ partial, int32_t* __restrict__ out, int n, int chunks,
            int shift) {
  const int idx = blockIdx.x * FIN_THREADS + threadIdx.x;
  if (idx >= n) return;
  uint32_t acc = 0u;
  for (int c = 0; c < chunks; ++c) acc += partial[static_cast<size_t>(c) * n + idx];
  out[idx] = as_i32(acc) >> shift;
}

template <typename TP, typename TV>
void launch_pv_partial(int chunks, cudaStream_t s, const void* p, const void* v, void* partial,
                       int m, int t, int dv, int chunk) {
  pv_partial<TP, TV><<<chunks, PV_THREADS, 0, s>>>(static_cast<const TP*>(p),
                                                   static_cast<const TV*>(v),
                                                   static_cast<uint32_t*>(partial), m, t, dv,
                                                   chunk);
}

// ---------------------------------------------------------------------------
// decode_gemv: out (M,) = w (M, K) · x (K,)
// ---------------------------------------------------------------------------

constexpr int GEMV_WARPS = 8;
constexpr int GEMV_THREADS = 32 * GEMV_WARPS;
constexpr int GEMV_STAGE_BYTES = 48 * 1024;  // static shared memory a block may take unasked

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// int8 × int8, K % 16 == 0, w 16-byte aligned (and x too when not staged):
// 16 bytes of the row a lane, four products per __dp4a.
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_i8_packed(const int8_t* __restrict__ w, const int8_t* __restrict__ x, int32_t* __restrict__ out,
               int m, int k, int stage) {
  extern __shared__ int4 gemv_smem[];
  const int chunks = k / 16;
  const int4* xs = reinterpret_cast<const int4*>(x);
  if (stage) {  // byte by byte: x itself need not be aligned
    int8_t* buf = reinterpret_cast<int8_t*>(gemv_smem);
    for (int j = threadIdx.x; j < k; j += GEMV_THREADS) buf[j] = x[j];
    __syncthreads();
    xs = gemv_smem;
  }
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * GEMV_WARPS + (threadIdx.x >> 5); row < m; row += gridDim.x * GEMV_WARPS) {
    const int4* wr = reinterpret_cast<const int4*>(w + static_cast<size_t>(row) * k);
    int acc = 0;
    for (int c = lane; c < chunks; c += 32) {
      const int4 wv = wr[c], xv = xs[c];
      acc = __dp4a(wv.x, xv.x, acc);
      acc = __dp4a(wv.y, xv.y, acc);
      acc = __dp4a(wv.z, xv.z, acc);
      acc = __dp4a(wv.w, xv.w, acc);
    }
    const uint32_t sum = warp_sum(static_cast<uint32_t>(acc));
    if (lane == 0) out[row] = as_i32(sum);
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

// int8 cache and int8 row, D % 16 == 0, 16-byte aligned: 16 bytes a thread.
template <typename TS>
__global__ void __launch_bounds__(KV_THREADS)
kv_append_i8_vec16(const int4* __restrict__ cache, const int4* __restrict__ nw,
                   const TS* __restrict__ sel, int4* __restrict__ out, int n16, int d16) {
  const int stride = gridDim.x * KV_THREADS;
  for (int i = blockIdx.x * KV_THREADS + threadIdx.x; i < n16; i += stride) {
    const int row = i / d16;
    out[i] = sel[row] != 0 ? nw[i - row * d16] : cache[i];
  }
}

template <typename TC, typename TN, typename TS>
void launch_kv_generic(cudaStream_t s, const void* cache, const void* nw, const void* sel,
                       void* out, int n, int d) {
  kv_append_generic<TC, TN, TS><<<repro_grid(n, KV_THREADS), KV_THREADS, 0, s>>>(
      static_cast<const TC*>(cache), static_cast<const TN*>(nw), static_cast<const TS*>(sel),
      static_cast<TC*>(out), n, d);
}

template <typename TC, typename TN>
void launch_kv_by_sel(int sel_bytes, cudaStream_t s, const void* cache, const void* nw,
                      const void* sel, void* out, int n, int d) {
  if (sel_bytes == 1)
    launch_kv_generic<TC, TN, int8_t>(s, cache, nw, sel, out, n, d);
  else
    launch_kv_generic<TC, TN, int32_t>(s, cache, nw, sel, out, n, d);
}

}  // namespace

// q (M, D), k (T, D): int8 (bytes 1) or int32 (bytes 4), row-major; out (M, T) int32.
extern "C" int attention_qk(const void* q, const void* k, void* out, int m, int t, int d,
                            int q_bytes, int k_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(repro_grid(t, QK_THREADS), (m + QK_GROUP - 1) / QK_GROUP);
  if (q_bytes == 1 && k_bytes == 1 && d % 16 == 0 && aligned(q, 4) && aligned(k, 16)) {
    qk_i8_packed<<<grid, QK_THREADS, 0, s>>>(static_cast<const int8_t*>(q),
                                             static_cast<const int8_t*>(k),
                                             static_cast<int32_t*>(out), m, t, d);
  } else if (q_bytes == 1 && k_bytes == 1) {
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
extern "C" int softmax_fixedpoint(const void* x, void* out, int r, int t, int sigma, int x_bytes,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lo = sigma + F == 31 ? INT32_MIN : -(1 << (sigma + F));
  if (x_bytes == 1)
    softmax_kernel<int8_t><<<r, SM_THREADS, 0, s>>>(static_cast<const int8_t*>(x),
                                                    static_cast<int32_t*>(out), t, sigma, lo);
  else
    softmax_kernel<int32_t><<<r, SM_THREADS, 0, s>>>(static_cast<const int32_t*>(x),
                                                     static_cast<int32_t*>(out), t, sigma, lo);
  return REPRO_LAUNCH_STATUS();
}

// p (M, T), v (T, Dv): int8 or int32; one block per `chunk` rows of T,
// each writing M·Dv words of `partial` (ceil(T / chunk)·M·Dv in all);
// out (M, Dv) int32.  0 <= shift <= 31.
extern "C" int attention_pv(const void* p, const void* v, void* partial, void* out, int m, int t,
                            int dv, int chunk, int shift, int p_bytes, int v_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (t + chunk - 1) / chunk;
  const int n = m * dv;
  if (p_bytes == 1 && v_bytes == 1)
    launch_pv_partial<int8_t, int8_t>(chunks, s, p, v, partial, m, t, dv, chunk);
  else if (p_bytes == 1)
    launch_pv_partial<int8_t, int32_t>(chunks, s, p, v, partial, m, t, dv, chunk);
  else if (v_bytes == 1)
    launch_pv_partial<int32_t, int8_t>(chunks, s, p, v, partial, m, t, dv, chunk);
  else
    launch_pv_partial<int32_t, int32_t>(chunks, s, p, v, partial, m, t, dv, chunk);
  const int status = REPRO_LAUNCH_STATUS();
  if (status != 0) return status;
  pv_finalize<<<(n + FIN_THREADS - 1) / FIN_THREADS, FIN_THREADS, 0, s>>>(
      static_cast<const uint32_t*>(partial), static_cast<int32_t*>(out), n, chunks, shift);
  return REPRO_LAUNCH_STATUS();
}

// cache (T, D) and out: int8 or int32 (cache_bytes); nw (D,): int8 or int32;
// sel (T,): 1-byte (int8, bool) or int32.  out must not alias cache.
extern "C" int kv_append(const void* cache, const void* nw, const void* sel, void* out, int t,
                         int d, int cache_bytes, int new_bytes, int sel_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = t * d;
  if (cache_bytes == 1 && new_bytes == 1 && d % 16 == 0 && aligned(cache, 16) && aligned(nw, 16) &&
      aligned(out, 16)) {
    const int n16 = n / 16;
    if (sel_bytes == 1)
      kv_append_i8_vec16<int8_t><<<repro_grid(n16, KV_THREADS), KV_THREADS, 0, s>>>(
          static_cast<const int4*>(cache), static_cast<const int4*>(nw),
          static_cast<const int8_t*>(sel), static_cast<int4*>(out), n16, d / 16);
    else
      kv_append_i8_vec16<int32_t><<<repro_grid(n16, KV_THREADS), KV_THREADS, 0, s>>>(
          static_cast<const int4*>(cache), static_cast<const int4*>(nw),
          static_cast<const int32_t*>(sel), static_cast<int4*>(out), n16, d / 16);
  } else if (cache_bytes == 1 && new_bytes == 1) {
    launch_kv_by_sel<int8_t, int8_t>(sel_bytes, s, cache, nw, sel, out, n, d);
  } else if (cache_bytes == 1) {
    launch_kv_by_sel<int8_t, int32_t>(sel_bytes, s, cache, nw, sel, out, n, d);
  } else if (new_bytes == 1) {
    launch_kv_by_sel<int32_t, int8_t>(sel_bytes, s, cache, nw, sel, out, n, d);
  } else {
    launch_kv_by_sel<int32_t, int32_t>(sel_bytes, s, cache, nw, sel, out, n, d);
  }
  return REPRO_LAUNCH_STATUS();
}

// w (M, K), x (K,): int8 (bytes 1) or int32 (bytes 4), w row-major; out (M,) int32.
extern "C" int decode_gemv(const void* w, const void* x, void* out, int m, int k, int w_bytes,
                           int x_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = repro_grid(m, GEMV_WARPS);
  const long long x_size = static_cast<long long>(k) * x_bytes;
  const int stage = x_size <= GEMV_STAGE_BYTES ? 1 : 0;
  const size_t smem = stage ? static_cast<size_t>((x_size + 15) / 16 * 16) : 0;
  if (w_bytes == 1 && x_bytes == 1 && k % 16 == 0 && aligned(w, 16) && (stage || aligned(x, 16))) {
    gemv_i8_packed<<<blocks, GEMV_THREADS, smem, s>>>(static_cast<const int8_t*>(w),
                                                      static_cast<const int8_t*>(x),
                                                      static_cast<int32_t*>(out), m, k, stage);
  } else if (w_bytes == 1 && x_bytes == 1) {
    launch_gemv_generic<int8_t, int8_t>(blocks, smem, s, w, x, out, m, k, stage);
  } else if (w_bytes == 1) {
    launch_gemv_generic<int8_t, int32_t>(blocks, smem, s, w, x, out, m, k, stage);
  } else if (x_bytes == 1) {
    launch_gemv_generic<int32_t, int8_t>(blocks, smem, s, w, x, out, m, k, stage);
  } else {
    launch_gemv_generic<int32_t, int32_t>(blocks, smem, s, w, x, out, m, k, stage);
  }
  return REPRO_LAUNCH_STATUS();
}
