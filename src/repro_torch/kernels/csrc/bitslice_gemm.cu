// Bit-sliced integer matrix product, the paper's bit-serial GEMM:
//
//   out (M, N) int32 = Σ_{(s,t) in pairs} (x[s] @ w[t]) << (slice_bits·(s+t))
//
// over x (Sx, M, K) int8 and w (Sw, K, N) int8 slice stacks, row-major,
// wrapping mod 2^32.
//
// Replaces the Pallas body `_kernel` (src/repro/kernels/bitslice_matmul.py:29),
// reached through `bitslice_matmul` (bitslice_matmul.py:53) from api.matmul.
// The pair list is the caller's `active_pairs(Sx, Sw, skip)`: a pair that the
// zero-slice skip dropped is not in it, and nothing is computed for it.  The
// list travels in the kernel's parameter block (at most MAX_PAIRS pairs), so
// a launch captured in a CUDA graph carries it too.
//
// Design.  Each block owns a BM x BN output tile and takes one pass over K,
// as the Pallas body does: per K tile it stages every slice that some pair
// needs in shared memory (each slice read from device memory once per tile,
// not once per pair), then runs all pairs over it with __dp4a (four int8
// products per instruction).  Pairs are sorted by diagonal d = s+t on the
// host; the products of one diagonal share an int32 accumulator, which is
// shifted left by slice_bits·d once per K tile and added into the total.
// Shifting distributes over addition mod 2^32, so folding per tile equals
// the reference's per-pair shift.  A shift of 32 or more is undefined in
// C++, while the reference gives 0 there: the kernel skips such a diagonal
// (it adds 0 mod 2^32) and neither computes its products nor stages slices
// that only it would read.  Totals are uint32_t, so the wrap is defined.
//
// Layout in shared memory: four consecutive k of one row (x) or one column
// (w) are packed into a 32-bit word, little-endian, which is __dp4a's
// operand; rows are padded by one word so the column-wise reads of w hit
// distinct banks.  Ragged M, N and K edges are zero-filled on load and
// skipped on store.  x is read in whole words when K % 4 == 0 and the stack
// is 4-byte aligned, else byte by byte; w is read by byte, coalesced along N.
//
// Bound: the Table III GEMM (61440 x 2048 x 32) is byte-bound on the card
// (the x stack dominates); a wide N such as the Qwen2-0.5B MLP projection
// (4096 x 896 x 4864) is operation-bound.  __dp4a runs on the CUDA cores,
// far below the int8 tensor-core rate; mma/wgmma tiles are later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TM = 4, TN = 4;  // outputs per thread: TM rows x TN columns
constexpr int MAX_PAIRS = 1024;
constexpr int MAX_SLICES = 64;  // slice-usage masks are 64-bit
constexpr int SMEM_LIMIT = 48 * 1024;  // dynamic shared memory without opt-in

struct PairList {
  int n;
  unsigned long long x_used, w_used;  // slices some computed pair reads
  unsigned char s[MAX_PAIRS];
  unsigned char t[MAX_PAIRS];
};

// KW: 32-bit words of K per tile (BK = 4·KW bytes).
template <int BM, int BN, int KW>
__global__ void __launch_bounds__(THREADS)
bitslice_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                uint32_t* __restrict__ out, int m, int n, int k, int sx, int sw,
                int slice_bits, bool x_words, const PairList pairs) {
  constexpr int COL_THREADS = BN / TN;
  constexpr int ROW_THREADS = BM / TM;
  static_assert(COL_THREADS * ROW_THREADS == THREADS, "tile / thread mismatch");
  constexpr int LD = KW + 1;  // padded row stride in words
  constexpr int BK = 4 * KW;

  extern __shared__ uint32_t smem[];
  uint32_t* xs = smem;                  // [sx][BM][LD]
  uint32_t* ws = smem + sx * BM * LD;   // [sw][BN][LD]

  const int tid = threadIdx.x;
  const int tx = tid % COL_THREADS, ty = tid / COL_THREADS;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;

  uint32_t total[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) total[i][j] = 0u;

  for (int k0 = 0; pairs.n > 0 && k0 < k; k0 += BK) {
    for (int s = 0; s < sx; ++s) {
      if (!((pairs.x_used >> s) & 1ull)) continue;
      const int8_t* xsl = x + static_cast<size_t>(s) * m * k;
      for (int i = tid; i < BM * KW; i += THREADS) {
        const int r = i / KW, q = i % KW;
        const int gr = row0 + r, gk = k0 + 4 * q;
        uint32_t v = 0u;
        if (gr < m && gk < k) {
          const int8_t* p = xsl + static_cast<size_t>(gr) * k + gk;
          if (x_words) {
            v = *reinterpret_cast<const uint32_t*>(p);
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (gk + b < k) v |= static_cast<uint32_t>(static_cast<uint8_t>(p[b])) << (8 * b);
          }
        }
        xs[(s * BM + r) * LD + q] = v;
      }
    }
    for (int t = 0; t < sw; ++t) {
      if (!((pairs.w_used >> t) & 1ull)) continue;
      const int8_t* wsl = w + static_cast<size_t>(t) * k * n;
      for (int i = tid; i < KW * BN; i += THREADS) {
        const int q = i / BN, c = i % BN;
        const int gc = col0 + c, gk = k0 + 4 * q;
        uint32_t v = 0u;
        if (gc < n) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (gk + b < k)
              v |= static_cast<uint32_t>(static_cast<uint8_t>(
                       wsl[static_cast<size_t>(gk + b) * n + gc])) << (8 * b);
        }
        ws[(t * BN + c) * LD + q] = v;
      }
    }
    __syncthreads();

    int p = 0;
    while (p < pairs.n) {
      const int d = pairs.s[p] + pairs.t[p];
      const int shift = slice_bits * d;
      if (shift >= 32) {  // adds 0 mod 2^32: skip the whole diagonal
        while (p < pairs.n && pairs.s[p] + pairs.t[p] == d) ++p;
        continue;
      }
      int acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0;
      for (; p < pairs.n && pairs.s[p] + pairs.t[p] == d; ++p) {
        const uint32_t* xa = xs + (pairs.s[p] * BM + ty) * LD;
        const uint32_t* wb = ws + (pairs.t[p] * BN + tx) * LD;
#pragma unroll
        for (int q = 0; q < KW; ++q) {
          int a[TM], b[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = static_cast<int>(xa[i * ROW_THREADS * LD + q]);
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = static_cast<int>(wb[j * COL_THREADS * LD + q]);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) total[i][j] += static_cast<uint32_t>(acc[i][j]) << shift;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * ROW_THREADS;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * COL_THREADS;
      if (c < n) out[static_cast<size_t>(r) * n + c] = total[i][j];
    }
  }
}

template <int BM, int BN, int KW>
int launch_tiles(const int8_t* x, const int8_t* w, uint32_t* out, int m, int n, int k,
                 int sx, int sw, int slice_bits, bool x_words, const PairList& pairs,
                 cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(sx * BM + sw * BN) * (KW + 1) * sizeof(uint32_t);
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  bitslice_kernel<BM, BN, KW><<<grid, THREADS, smem, stream>>>(
      x, w, out, m, n, k, sx, sw, slice_bits, x_words, pairs);
  return REPRO_LAUNCH_STATUS();
}

// The widest K tile (words) whose staged slices fit the shared-memory limit
// and that K can fill; 0 if not even one word fits.
int choose_kw(int rows, int k) {
  const int kw_needed = (k + 3) / 4;
  for (int kw = 16; kw >= 1; kw /= 2) {
    if (kw > 1 && kw / 2 >= kw_needed) continue;
    if (static_cast<size_t>(rows) * (kw + 1) * sizeof(uint32_t) <= SMEM_LIMIT) return kw;
  }
  return 0;
}

template <int BM, int BN>
int launch_bitslice(const int8_t* x, const int8_t* w, uint32_t* out, int m, int n, int k,
                    int sx, int sw, int slice_bits, bool x_words, const PairList& pairs,
                    cudaStream_t stream) {
  switch (choose_kw(sx * BM + sw * BN, k)) {
    case 16: return launch_tiles<BM, BN, 16>(x, w, out, m, n, k, sx, sw, slice_bits, x_words, pairs, stream);
    case 8: return launch_tiles<BM, BN, 8>(x, w, out, m, n, k, sx, sw, slice_bits, x_words, pairs, stream);
    case 4: return launch_tiles<BM, BN, 4>(x, w, out, m, n, k, sx, sw, slice_bits, x_words, pairs, stream);
    case 2: return launch_tiles<BM, BN, 2>(x, w, out, m, n, k, sx, sw, slice_bits, x_words, pairs, stream);
    case 1: return launch_tiles<BM, BN, 1>(x, w, out, m, n, k, sx, sw, slice_bits, x_words, pairs, stream);
    default: return static_cast<int>(cudaErrorInvalidConfiguration);
  }
}

}  // namespace

// pair_s / pair_t: n_pairs slice indices, sorted by s+t.  x_words: K % 4 == 0
// and x is 4-byte aligned.  Refuses (cudaErrorInvalidValue) more than
// MAX_PAIRS pairs or MAX_SLICES slices per operand.
extern "C" int bitslice_gemm_i8(const void* x, const void* w, void* out, int m, int n, int k,
                                int sx, int sw, int slice_bits, int x_words,
                                const unsigned char* pair_s, const unsigned char* pair_t,
                                int n_pairs, void* stream) {
  if (n_pairs < 0 || n_pairs > MAX_PAIRS || sx < 1 || sw < 1 || sx > MAX_SLICES ||
      sw > MAX_SLICES)
    return static_cast<int>(cudaErrorInvalidValue);
  PairList pairs;
  pairs.n = n_pairs;
  pairs.x_used = pairs.w_used = 0ull;
  for (int i = 0; i < n_pairs; ++i) {
    if (pair_s[i] >= sx || pair_t[i] >= sw) return static_cast<int>(cudaErrorInvalidValue);
    pairs.s[i] = pair_s[i];
    pairs.t[i] = pair_t[i];
    if (slice_bits * (pair_s[i] + pair_t[i]) < 32) {
      pairs.x_used |= 1ull << pair_s[i];
      pairs.w_used |= 1ull << pair_t[i];
    }
  }
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // A narrow N (the Table III GEMM's 32) takes tall tiles; otherwise square.
  if (n <= 32)
    return launch_bitslice<128, 32>(xp, wp, op, m, n, k, sx, sw, slice_bits, x_words != 0, pairs, st);
  return launch_bitslice<64, 64>(xp, wp, op, m, n, k, sx, sw, slice_bits, x_words != 0, pairs, st);
}
