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
// zero-slice skip dropped is not in it, and nothing is computed for it.  A
// shift of 32 or more is undefined in C++, while the reference gives 0 there:
// both paths skip such a diagonal (it adds 0 mod 2^32) and stage no slice
// that only it would read.  Totals are uint32_t, so the wrap is defined.
// bitslice_matmul.bitslice_plan picks the path.
//
// Tensor-core path (bitslice_mma_kernel).  Every slice is a signed int8
// digit, so every pair is one s8 x s8 mma.sync m16n8k32.  It takes calls
// whose computed pairs are all pairs of at most two x slices and two w
// slices (every PrecisionSpec preset: int4/int8 1 x 1, w8a16 2 x 1, int16
// 2 x 2, and the zero-skip 1 x 2), with K % 16 == 0, the x stack 16-byte
// aligned, N % 4 == 0 and the w stack 4-byte aligned; slice and pair counts
// are template constants.  Pairs on one diagonal d = s + t share an s32
// accumulator (local diagonal i + j of the staged slices; in the 2 x 2 case
// the slices' gaps must be equal so that (0,1) and (1,0) share one).  An
// accumulator stays exact without relying on the tensor cores' overflow
// behaviour: |product| <= 2^14, so p pairs over L of K stay in s32 while
// L·p <= FOLD_LP = 2^17 - 1; every `fold_tiles` K tiles (the plan's fold
// interval) the block adds Σ acc_d << shift_d into its own tile of `out`
// (stored at the first fold, added after) and restarts its accumulators.
// Loads: cp.async, STAGES deep, 16-byte copies of x rows into 128-byte tile
// rows whose chunks are XOR-swizzled so that ldmatrix.x4 (four consecutive-K
// bytes of a row a register, as the s8 A fragment wants) is free of bank
// conflicts; w rows are copied as they lie ((K, N), 16-byte copies when
// N % 16 == 0, else 4-byte) and each warp transposes its B fragments with
// __byte_perm: four 4-byte loads of K rows 4t..4t+3 at columns 4g..4g+3 give
// the fragments of four 8-column MMA tiles at once, if MMA tile i's column g
// is output column 4g + i.  That permutation leaves each thread eight
// adjacent output columns, stored as two 16-byte words.  Tiles: 128 x 32
// (four warps of 32 x 32) for N <= 32, the Table III GEMM's 480 blocks;
// 128 x 128 (eight warps of 64 x 32) otherwise, 64 x 128 with three
// accumulators (2 x 2 slices).
//
// __dp4a path (bitslice_kernel), for everything else: K % 16 != 0, a
// misaligned stack, more slices (sb = 1 with up to 1024 pairs, sb 4 with 6 x
// 5 slices), a pair set that is not all pairs of its slices.  Each block owns
// a BM x BN output tile and takes one pass over K: per K tile it stages every
// slice that some pair needs in shared memory, then runs all pairs over it
// with __dp4a (four int8 products per instruction).  Pairs are sorted by
// diagonal on the host; the products of one diagonal share an int32
// accumulator, shifted left by slice_bits·d once per K tile and added into the
// total.  Four consecutive k of one row (x) or one column (w) are packed into
// a 32-bit word, __dp4a's operand; rows are padded by one word so the
// column-wise reads of w hit distinct banks.  Ragged M, N and K edges are
// zero-filled on load and skipped on store (both paths).  x is read in whole
// words when K % 4 == 0 and the stack is 4-byte aligned, else byte by byte; w
// is read by byte, coalesced along N.
//
// Dequantizing epilogue (both tensor-core kernels, template parameter Out):
// where a block folds once (K <= fold_k), each s32 sum leaves as the
// quantized linear's output, not as int32: float(acc) · x_scale[row] ·
// w_scale[col] (+ bias[col], K4 alone), rounded to Out (float, bfloat16 or
// half), the PyTorch chain's operations in its order, each rounded on its own
// (__fmul_rn, __fadd_rn: nothing contracts into an FMA), so the output
// equals the chain's bit for bit (a NaN's payload aside).  The scales and
// the bias are read at the fold, a row and a run at a time; a run of four
// columns is one 16-byte (float) or 8-byte (16-bit types) store.  It takes
// the int32 pass plus 4-5 PyTorch passes over (M, N) off the path.
//
// Grouped path (bitslice_grouped_kernel): the routed experts of a mixture of
// experts, every expert's product of one projection of one layer in one
// launch.  It replaces no TPU kernel: the JAX package multiplies experts with
// jnp.einsum outside Pallas (src/repro/models/moe.py).  The rows (one int8
// slice each) are sorted by expert and the experts' row offsets lie on the
// device; each block finds its expert and M tile from them and runs the
// tensor-core path's tile over that expert's rows and its own (K, N) weight,
// so a tile never spans two experts and an empty expert launches no block
// that works.  Bound: at Moonlight-16B-A3B's prefill (~1,500 rows an expert,
// K x N 2048 x 2816 and 1408 x 2048) operations, at mma.sync's rate as
// above; the last, partial tile of each expert computes up to 127 zero rows.
//
// Bound: the Table III GEMM (61440 x 2048 x 32) is byte-bound on the card
// (the x stack dominates: the tall tiles stream it once); a wide N such as
// the Qwen2-0.5B MLP projection (4096 x 896 x 4864) is operation-bound, at
// mma.sync's rate, below the dense wgmma int8 rate the bound counts
// (wgmma and TMA are later work).
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

namespace {

// ------------------------------------------------------------ __dp4a path

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

// ------------------------------------------------------ tensor-core path

namespace {
namespace tc {

// bitslice_matmul.BITSLICE_MMA_BK: bytes of K a stage holds.  128-byte rows
// read faster than 64-byte ones in a sweep on the H100 (PERF.md §6).
constexpr int BK = 128;
static_assert(BK == 64 || BK == 128, "xoff's swizzle and the tiles' copies take 64- or 128-byte K tiles");
constexpr int STAGES = 3;  // bitslice_matmul.BITSLICE_MMA_STAGES
constexpr int WN = 32;     // columns a warp owns: four 8-column MMA tiles
// bitslice_matmul.BITSLICE_FOLD_LP: an s32 accumulator of p pairs over L of K
// stays exact while L·p·2^14 < 2^31
constexpr int FOLD_LP = (1 << 17) - 1;

// The dtype codes of the dequantizing epilogue's output and bias
// (bitslice_matmul.DTYPE_CODES); DT_NONE: no bias.
constexpr int DT_NONE = 0, DT_F32 = 1, DT_BF16 = 2, DT_F16 = 3;

__host__ __device__ constexpr int dt_size(int dt) { return dt == DT_F32 ? 4 : dt == DT_NONE ? 0 : 2; }

struct Args {
  const int8_t* x[2];    // the staged x slices, (M, K) each
  const int8_t* w[2];    // the staged w slices, (K, N) each
  void* out;             // (M, N): uint32_t sums, or the epilogue's Out
  int m, n, k;
  int shift[3];          // slice_bits·(s+t) of local diagonal i + j
  int fold_tiles;        // K tiles summed between folds into out
  int w_vec;             // 16-byte copies of w rows (else 4-byte)
  // the epilogue's row scales (M,), column scales (N,) and bias (N,) of
  // dtype code bias_type; after the fields above, whose order keeps the
  // int32 instances at their registers (K4 1 x 2's spills otherwise)
  const float* x_scale;
  const float* w_scale;
  const void* bias;
  int bias_type;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte of (row r, K byte kb) in an x tile of BK-byte rows: 16-byte chunks
// XOR-ed inside each 128-byte line by the line's index (mod the chunks a
// row holds), so that ldmatrix's eight rows of one chunk column fall in
// eight distinct bank groups (at BK = 128: r & 7).
__device__ __forceinline__ int xoff(int r, int kb) {
  return (r * BK + kb) ^ ((r / (128 / BK) % (BK / 16)) << 4);
}

// Byte of (K row kr, column byte nb) in a w tile of BN-byte rows: bits 5-6
// XOR-ed by (kr >> 2) & 3, constant inside each 128-byte line for BN >= 32,
// so that a warp's fragment loads (K rows kk + 4t + j, columns 4g) hit 32
// distinct banks.
template <int BN>
__device__ __forceinline__ int woff(int kr, int nb) { return (kr * BN + nb) ^ (((kr >> 2) & 3) << 5); }

// Four words of consecutive K rows (four column bytes each) → four words of
// one column each (four consecutive-K bytes, low K first).
__device__ __forceinline__ void transpose4(const uint32_t w[4], uint32_t v[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362), hi23 = __byte_perm(w[2], w[3], 0x7362);
  v[0] = __byte_perm(lo01, lo23, 0x5410);
  v[1] = __byte_perm(lo01, lo23, 0x7632);
  v[2] = __byte_perm(hi01, hi23, 0x5410);
  v[3] = __byte_perm(hi01, hi23, 0x7632);
}

template <int BM, int BN, int WM>
__host__ __device__ constexpr int threads_of() { return 32 * (BM / WM) * (BN / WN); }

// One stage: each staged x slice's BM x BK tile and each w slice's BK x BN
// tile of K tile kt, zero-filled past M, N and K.
template <int NX, int NW, int BM, int BN, int THREADS>
__device__ __forceinline__ void load_stage(uint8_t* st, const Args& args, int row0, int col0, int kt) {
  constexpr int X_TILE = BM * BK, W_TILE = BK * BN;
  const int m = args.m, n = args.n, k = args.k, k0 = kt * BK;
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < X_TILE / 16 / THREADS; ++j) {
      const int q = threadIdx.x + j * THREADS;
      const int r = q / (BK / 16), kb = q % (BK / 16) * 16;
      const int gr = row0 + r, gk = k0 + kb;
      const bool ok = gr < m && gk < k;  // K % 16 == 0: a chunk is all in or all out
      cp16(smem_addr(st + i * X_TILE + xoff(r, kb)), ok ? args.x[i] + static_cast<size_t>(gr) * k + gk : args.x[i],
           ok);
    }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint8_t* ws = st + NX * X_TILE + i * W_TILE;
    if (args.w_vec) {  // N % 16 == 0
#pragma unroll
      for (int j = 0; j < W_TILE / 16 / THREADS; ++j) {
        const int q = threadIdx.x + j * THREADS;
        const int kr = q / (BN / 16), nb = (q % (BN / 16)) * 16;
        const int gk = k0 + kr, gn = col0 + nb;
        const bool ok = gk < k && gn < n;
        cp16(smem_addr(ws + woff<BN>(kr, nb)), ok ? args.w[i] + static_cast<size_t>(gk) * n + gn : args.w[i], ok);
      }
    } else {  // N % 4 == 0
#pragma unroll
      for (int j = 0; j < W_TILE / 4 / THREADS; ++j) {
        const int q = threadIdx.x + j * THREADS;
        const int kr = q / (BN / 4), nb = (q % (BN / 4)) * 4;
        const int gk = k0 + kr, gn = col0 + nb;
        const bool ok = gk < k && gn < n;
        cp4(smem_addr(ws + woff<BN>(kr, nb)), ok ? args.w[i] + static_cast<size_t>(gk) * n + gn : args.w[i], ok);
      }
    }
  }
}

// A run of four dequantized columns, rounded to Out, in one store.
__device__ __forceinline__ void store_run(float* p, const float (&y)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}

__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float (&y)[4]) {
  uint32_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __bfloat16_as_ushort(__float2bfloat16_rn(y[i]));
  *reinterpret_cast<uint2*>(p) = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
}

__device__ __forceinline__ void store_run(__half* p, const float (&y)[4]) {
  uint32_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __half_as_ushort(__float2half_rn(y[i]));
  *reinterpret_cast<uint2*>(p) = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
}

__device__ __forceinline__ float bias_at(const Args& a, int c) {
  if (a.bias_type == DT_F32) return static_cast<const float*>(a.bias)[c];
  if (a.bias_type == DT_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[c]);
  return __half2float(static_cast<const __half*>(a.bias)[c]);
}

// Out = uint32_t: out += Σ_e acc_e << shift_e over the warp's WM x 32 (out
// = at the first fold).  Else (one fold) out = Out(float(Σ_e acc_e <<
// shift_e) · x_scale · w_scale (+ bias)).  Registers 0-1 sit at row g, 2-3
// at row g + 8; register 2h + c of MMA tile nt at output column 8t + 4c +
// nt, so each thread owns two runs of four adjacent columns a row.
template <typename Out, int NACC, int MT>
__device__ __forceinline__ void fold(const int (&acc)[NACC][MT][4][4], const Args& args, int row, int col,
                                     bool first) {
  constexpr bool RAW = std::is_same<Out, uint32_t>::value;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + mt * 16 + h * 8;
      if (r >= args.m) continue;
      float xs = 0.f;
      if constexpr (!RAW) xs = args.x_scale[r];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cc = col + 4 * c;
        if (cc >= args.n) continue;  // N % 4 == 0: a run is all in or all out
        uint32_t v[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t sum = 0u;
#pragma unroll
          for (int e = 0; e < NACC; ++e) sum += static_cast<uint32_t>(acc[e][mt][nt][2 * h + c]) << args.shift[e];
          v[nt] = sum;
        }
        Out* dst = static_cast<Out*>(args.out) + static_cast<size_t>(r) * args.n + cc;
        if constexpr (RAW) {
          uint4 o = make_uint4(v[0], v[1], v[2], v[3]);
          if (!first) {  // this thread wrote these words at the last fold
            const uint4 p = *reinterpret_cast<const uint4*>(dst);
            o.x += p.x; o.y += p.y; o.z += p.z; o.w += p.w;
          }
          *reinterpret_cast<uint4*>(dst) = o;
        } else {
          float y[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            y[nt] = __fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(v[nt])), xs), args.w_scale[cc + nt]);
          if (args.bias_type != DT_NONE) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) y[nt] = __fadd_rn(y[nt], bias_at(args, cc + nt));
          }
          store_run(dst, y);
        }
      }
    }
}

// NX x NW staged slices, all NX·NW pairs: the output tile at (row0, col0), a
// BM x BN tile of warps WM x WN, over all of K, staged in `smem`, folded
// into Out (see fold).
template <typename Out, int NX, int NW, int BM, int BN, int WM>
__device__ __forceinline__ void mma_tile(const Args& args, uint8_t* smem, int row0, int col0) {
  constexpr int THREADS = threads_of<BM, BN, WM>(), WARPS_N = BN / WN;
  constexpr int MT = WM / 16;         // 16-row MMA tiles a warp
  constexpr int NACC = NX + NW - 1;   // local diagonals i + j
  constexpr int X_TILE = BM * BK, W_TILE = BK * BN, STAGE = NX * X_TILE + NW * W_TILE;
  static_assert(X_TILE % (16 * THREADS) == 0 && W_TILE % (16 * THREADS) == 0, "tile / thread mismatch");

  const int ktiles = (args.k + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int g = lane >> 2, t = lane & 3;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage<NX, NW, BM, BN, THREADS>(smem + s * STAGE, args, row0, col0, s);
    cp_commit();
  }
  // K in ranges of fold_tiles K tiles; one pass (for the zeros) when K == 0
  int kt = 0;
  for (bool first = true; first || kt < ktiles; first = false) {
    // acc[e][mt][nt][reg]: local diagonal e, 16-row tile mt, 8-column tile nt
    int acc[NACC][MT][4][4];
#pragma unroll
    for (int e = 0; e < NACC; ++e)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[e][mt][nt][r] = 0;
    for (const int end = min(ktiles, kt + args.fold_tiles); kt < end; ++kt) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      {  // refill the stage the previous step read (every thread is past it)
        const int next = kt + STAGES - 1;
        if (next < ktiles) load_stage<NX, NW, BM, BN, THREADS>(smem + (next % STAGES) * STAGE, args, row0, col0, next);
        cp_commit();
      }
      const uint8_t* st = smem + (kt % STAGES) * STAGE;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 32) {
        uint32_t a[NX][MT][4];
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // lanes 0-7: rows 0-7 at K 0-15, 8-15: rows 8-15, 16-23: rows 0-7
            // at K 16-31, 24-31: rows 8-15 → registers a0..a3 of the s8 fragment
            const int r = wm0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldmatrix_x4(a[i][mt], smem_addr(st + i * X_TILE + xoff(r, ks + (lane >> 4) * 16)));
          }
        uint32_t b[NW][4][2];
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const uint8_t* ws = st + NX * X_TILE + i * W_TILE;
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // K 0-15 and 16-31 of the step
            uint32_t rows[4], cols[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              rows[j] = *reinterpret_cast<const uint32_t*>(ws + woff<BN>(ks + 16 * h + 4 * t + j, wn0 + 4 * g));
            transpose4(rows, cols);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) b[i][nt][h] = cols[nt];
          }
        }
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) mma_s8(acc[i + j][mt][nt], a[i][mt], b[j][nt]);
      }
    }
    fold<Out>(acc, args, row0 + wm0 + g, col0 + wn0 + 8 * t, first);  // the range's end: keeps s32 exact
  }
  cp_wait<0>();
}

template <typename Out, int NX, int NW, int BM, int BN, int WM>
__global__ void __launch_bounds__(threads_of<BM, BN, WM>())
bitslice_mma_kernel(const Args args) {
  extern __shared__ uint4 smem_raw[];
  mma_tile<Out, NX, NW, BM, BN, WM>(args, reinterpret_cast<uint8_t*>(smem_raw), blockIdx.x * BM, blockIdx.y * BN);
}

// The grouped product: group e's rows [offsets[e], offsets[e+1]) of x (one
// int8 slice, rows sorted by group) times its own weight w[e] (K, N), into
// the same rows of out.  blockIdx.x counts the groups' BM-row tiles in group
// order (a group of c rows has ceil(c / BM), an empty one none); the grid is
// sized for the most any split of the rows can need, ceil(rows / BM) +
// groups, so the host never reads the counts, and the blocks past the last
// tile return at once.  No tile spans two groups: a group's last tile is
// zero-filled past its rows and stores none of them.  The epilogue takes the
// group's rows' scales and its own row of the column scales (w_scale (groups,
// N)); it adds no bias.
template <typename Out, int BM, int BN, int WM>
__global__ void __launch_bounds__(threads_of<BM, BN, WM>())
bitslice_grouped_kernel(const Args args, const int* __restrict__ offsets, int groups) {
  int tile = blockIdx.x, e = 0, lo = 0, rows = 0;
  for (; e < groups; ++e) {
    lo = offsets[e];
    rows = offsets[e + 1] - lo;
    const int tiles = rows > 0 ? (rows + BM - 1) / BM : 0;
    if (tile < tiles) break;
    tile -= tiles;
  }
  if (e == groups) return;  // uniform over the block: before any barrier
  Args a = args;
  a.x[0] = args.x[0] + static_cast<size_t>(lo) * args.k;
  a.w[0] = args.w[0] + static_cast<size_t>(e) * args.k * args.n;
  a.out = static_cast<Out*>(args.out) + static_cast<size_t>(lo) * args.n;
  a.m = rows;
  if constexpr (!std::is_same<Out, uint32_t>::value) {
    a.x_scale = args.x_scale + lo;
    a.w_scale = args.w_scale + static_cast<size_t>(e) * args.n;
  }
  extern __shared__ uint4 smem_raw[];
  mma_tile<Out, 1, 1, BM, BN, WM>(a, reinterpret_cast<uint8_t*>(smem_raw), tile * BM, blockIdx.y * BN);
}

template <typename Out, int BM, int BN, int WM>
int launch_grouped(const Args& a, const int* offsets, int groups, int rows, cudaStream_t stream) {
  constexpr int THREADS = threads_of<BM, BN, WM>();
  constexpr int SMEM = STAGES * (BM + BN) * BK;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(bitslice_grouped_kernel<Out, BM, BN, WM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((rows + BM - 1) / BM + groups, (a.n + BN - 1) / BN);
  bitslice_grouped_kernel<Out, BM, BN, WM><<<grid, THREADS, SMEM, stream>>>(a, offsets, groups);
  return REPRO_LAUNCH_STATUS();
}

// The 128 x 128 tile (128 x 32 for N <= 32).
template <typename Out>
int launch_grouped_tile(const Args& a, const int* offsets, int groups, int rows, cudaStream_t stream) {
  if (a.n <= 32) return launch_grouped<Out, 128, 32, 32>(a, offsets, groups, rows, stream);
  return launch_grouped<Out, 128, 128, 64>(a, offsets, groups, rows, stream);
}

template <typename Out, int NX, int NW, int BM, int BN, int WM>
int launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int THREADS = threads_of<BM, BN, WM>();
  constexpr int SMEM = STAGES * (NX * BM + NW * BN) * BK;
  // above the default 48 KB: opt in once per instance, at its first launch
  // (chip_smoke.py and the card tests launch eagerly before any graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(bitslice_mma_kernel<Out, NX, NW, BM, BN, WM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((a.m + BM - 1) / BM, (a.n + BN - 1) / BN);
  bitslice_mma_kernel<Out, NX, NW, BM, BN, WM><<<grid, THREADS, SMEM, stream>>>(a);
  return REPRO_LAUNCH_STATUS();
}

// The tile of bitslice_matmul.BITSLICE_MMA_TILES: (BM, BN, WM).
template <typename Out, int NX, int NW>
int launch_slices(const Args& a, bool narrow, cudaStream_t stream) {
  if (narrow) return launch_mma<Out, NX, NW, 128, 32, 32>(a, stream);
  if constexpr (NX * NW == 4) return launch_mma<Out, NX, NW, 64, 128, 32>(a, stream);
  else return launch_mma<Out, NX, NW, 128, 128, 64>(a, stream);
}

// What the epilogue refuses, in both entry points: an unknown dtype code, K
// past one fold, a scale, bias or output off its element (the output off a
// run's store).
bool dequant_refuses(const void* out, const void* x_scale, const void* w_scale, const void* bias, int k,
                     int out_type, int bias_type, int fold_tiles) {
  const auto misaligned = [](const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to != 0; };
  return out_type < DT_F32 || out_type > DT_F16 || bias_type < DT_NONE || bias_type > DT_F16 ||
         (k + BK - 1) / BK > fold_tiles || misaligned(out, 4 * dt_size(out_type)) || misaligned(x_scale, 4) ||
         misaligned(w_scale, 4) || (bias_type != DT_NONE && misaligned(bias, dt_size(bias_type)));
}

// launch(Out*{}) with the Out of a dtype code.
template <typename F>
int with_out_type(int out_type, F&& launch) {
  if (out_type == DT_F32) return launch(static_cast<float*>(nullptr));
  if (out_type == DT_BF16) return launch(static_cast<__nv_bfloat16*>(nullptr));
  return launch(static_cast<__half*>(nullptr));
}

}  // namespace tc
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

// The tensor-core path: `nx` x `nw` staged slices (1 or 2 each; x1 and w1
// unused when 1), all their pairs; `shift0..2` of local diagonals 0..nx+nw-2;
// `narrow`: the 128 x 32 tile; `w_vec`: 16-byte w copies; `fold_tiles`: K
// tiles between folds.  Refuses (cudaErrorInvalidValue) what the path does not
// take, a fold interval past FOLD_LP included.
extern "C" int bitslice_gemm_mma(const void* x0, const void* x1, const void* w0, const void* w1, void* out,
                                 int m, int n, int k, int nx, int nw, int shift0, int shift1, int shift2,
                                 int narrow, int w_vec, int fold_tiles, void* stream) {
  const int per_diagonal = (nx == 2 && nw == 2) ? 2 : 1;
  const auto misaligned = [](const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to != 0; };
  if (nx < 1 || nx > 2 || nw < 1 || nw > 2 || k % 16 != 0 || n % 4 != 0 || fold_tiles < 1 ||
      static_cast<long long>(fold_tiles) * tc::BK * per_diagonal > tc::FOLD_LP || misaligned(x0, 16) ||
      misaligned(x1, 16) || misaligned(w0, w_vec ? 16 : 4) || misaligned(w1, w_vec ? 16 : 4) ||
      (w_vec && n % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Args a{};
  a.x[0] = static_cast<const int8_t*>(x0);
  a.x[1] = static_cast<const int8_t*>(x1);
  a.w[0] = static_cast<const int8_t*>(w0);
  a.w[1] = static_cast<const int8_t*>(w1);
  a.out = static_cast<uint32_t*>(out);
  a.m = m;
  a.n = n;
  a.k = k;
  a.shift[0] = shift0;
  a.shift[1] = shift1;
  a.shift[2] = shift2;
  a.fold_tiles = fold_tiles;
  a.w_vec = w_vec;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool nar = narrow != 0;
  if (nx == 1 && nw == 1) return tc::launch_slices<uint32_t, 1, 1>(a, nar, st);
  if (nx == 2 && nw == 1) return tc::launch_slices<uint32_t, 2, 1>(a, nar, st);
  if (nx == 1 && nw == 2) return tc::launch_slices<uint32_t, 1, 2>(a, nar, st);
  return tc::launch_slices<uint32_t, 2, 2>(a, nar, st);
}

// The grouped product: x (rows, K) int8 sorted by group, w (groups, K, N)
// int8, offsets (groups + 1) int32 on the device (offsets[0] = 0,
// nondecreasing, offsets[groups] = rows), out (rows, N) int32; one slice pair,
// no shift.  The 128 x 128 tile (128 x 32 for N <= 32).  Refuses
// (cudaErrorInvalidValue) K % 16 != 0, N % 4 != 0, a misaligned operand or a
// fold interval past FOLD_LP.
extern "C" int bitslice_gemm_grouped(const void* x, const void* w, const void* offsets, void* out, int rows,
                                     int n, int k, int groups, int w_vec, int fold_tiles, void* stream) {
  const auto misaligned = [](const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to != 0; };
  if (rows < 0 || groups < 1 || k % 16 != 0 || n % 4 != 0 || fold_tiles < 1 ||
      static_cast<long long>(fold_tiles) * tc::BK > tc::FOLD_LP || misaligned(x, 16) ||
      misaligned(w, w_vec ? 16 : 4) || misaligned(offsets, 4) || misaligned(out, 16) || (w_vec && n % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Args a{};
  a.x[0] = a.x[1] = static_cast<const int8_t*>(x);
  a.w[0] = a.w[1] = static_cast<const int8_t*>(w);
  a.out = static_cast<uint32_t*>(out);
  a.m = rows;
  a.n = n;
  a.k = k;
  a.shift[0] = a.shift[1] = a.shift[2] = 0;
  a.fold_tiles = fold_tiles;
  a.w_vec = w_vec;
  return tc::launch_grouped_tile<uint32_t>(a, static_cast<const int*>(offsets), groups, rows,
                                           static_cast<cudaStream_t>(stream));
}

// The tensor-core path with the dequantizing epilogue: one slice pair, no
// shift, x (M, K) and w (K, N) int8, out (M, N) of dtype code out_type,
// x_scale (M,) and w_scale (N,) float32, bias (N,) of dtype code bias_type
// (DT_NONE: none, bias unused); the plan as bitslice_gemm_mma's.  Refuses
// (cudaErrorInvalidValue) what that path refuses and what the epilogue does
// (tc::dequant_refuses): K past one fold among them.
extern "C" int bitslice_gemm_mma_dequant(const void* x, const void* w, void* out, const void* x_scale,
                                         const void* w_scale, const void* bias, int out_type, int bias_type,
                                         int m, int n, int k, int narrow, int w_vec, int fold_tiles,
                                         void* stream) {
  const auto misaligned = [](const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to != 0; };
  if (k % 16 != 0 || n % 4 != 0 || fold_tiles < 1 || static_cast<long long>(fold_tiles) * tc::BK > tc::FOLD_LP ||
      misaligned(x, 16) || misaligned(w, w_vec ? 16 : 4) || (w_vec && n % 16 != 0) ||
      tc::dequant_refuses(out, x_scale, w_scale, bias, k, out_type, bias_type, fold_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Args a{};
  a.x[0] = a.x[1] = static_cast<const int8_t*>(x);
  a.w[0] = a.w[1] = static_cast<const int8_t*>(w);
  a.out = out;
  a.x_scale = static_cast<const float*>(x_scale);
  a.w_scale = static_cast<const float*>(w_scale);
  a.bias = bias;
  a.bias_type = bias_type;
  a.m = m;
  a.n = n;
  a.k = k;
  a.fold_tiles = fold_tiles;
  a.w_vec = w_vec;
  const auto st = static_cast<cudaStream_t>(stream);
  return tc::with_out_type(out_type, [&](auto* o) {
    return tc::launch_slices<std::remove_pointer_t<decltype(o)>, 1, 1>(a, narrow != 0, st);
  });
}

// The grouped path with the dequantizing epilogue: bitslice_gemm_grouped's
// operands and plan, out (rows, N) of dtype code out_type, x_scale (rows,)
// and w_scale (groups, N) float32, no bias.  Refuses (cudaErrorInvalidValue)
// what that path refuses and what the epilogue does.
extern "C" int bitslice_gemm_grouped_dequant(const void* x, const void* w, const void* offsets, void* out,
                                             const void* x_scale, const void* w_scale, int out_type, int rows,
                                             int n, int k, int groups, int w_vec, int fold_tiles, void* stream) {
  const auto misaligned = [](const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to != 0; };
  if (rows < 0 || groups < 1 || k % 16 != 0 || n % 4 != 0 || fold_tiles < 1 ||
      static_cast<long long>(fold_tiles) * tc::BK > tc::FOLD_LP || misaligned(x, 16) ||
      misaligned(w, w_vec ? 16 : 4) || misaligned(offsets, 4) || (w_vec && n % 16 != 0) ||
      tc::dequant_refuses(out, x_scale, w_scale, nullptr, k, out_type, tc::DT_NONE, fold_tiles))
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Args a{};
  a.x[0] = a.x[1] = static_cast<const int8_t*>(x);
  a.w[0] = a.w[1] = static_cast<const int8_t*>(w);
  a.out = out;
  a.x_scale = static_cast<const float*>(x_scale);
  a.w_scale = static_cast<const float*>(w_scale);
  a.m = rows;
  a.n = n;
  a.k = k;
  a.fold_tiles = fold_tiles;
  a.w_vec = w_vec;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int*>(offsets);
  return tc::with_out_type(out_type, [&](auto* o) {
    return tc::launch_grouped_tile<std::remove_pointer_t<decltype(o)>>(a, off, groups, rows, st);
  });
}
