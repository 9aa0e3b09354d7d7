// Integer (and float32) matrix product C = A @ B: A (M, K) row-major, B
// either (K, N) row-major ("kn", as int_matmul passes it) or (N, K)
// row-major ("nk", a conv weight's own (OC, C·KH·KW) layout), C (M, N).
//
// Replaces the Pallas body `_dot_kernel` (src/repro/kernels/conv.py:49),
// reached through `_blocked_matmul` (conv.py:56) from conv2d (after im2col)
// and int_matmul.  The Pallas kernel keeps all of K resident in VMEM
// (conv.py:70); a Hopper block has at most 227 KB of shared memory, so every
// kernel here walks K in tiles.  conv.gemm_plan picks the kernel and its grid.
//
// int32 products wrap mod 2^32 exactly as the JAX oracle does.  Signed
// overflow is undefined in C++, so sums are taken in uint32_t and the
// caller's int32 buffers are reinterpreted, never converted.
//
// int32, tile path (gemm_tile_kernel): int8 tensor-core digits.  An int32 x
// that fits in b signed bytes is exactly  Σ_{i<b-1} u8_i(x)·2^(8i) +
// s8_{b-1}(x)·2^(8(b-1)),  where digit i is x's raw byte i, read unsigned
// below the top digit and signed at it (the bytes above are only sign).  So
// A·B mod 2^32 is the sum over digit pairs (i, j) of (A_i·B_j) << 8(i+j), and
// pairs with i + j >= 4 vanish mod 2^32.  Each warp reads its int32 A and B
// tiles (32 rows of A, 32 columns of B, one 32-wide K step) from shared
// memory and votes (a warp-wide OR) on the bytes b_A and b_B their values
// need.  A switch on the vote enters code compiled for those two counts, so
// that the pairs, the digits extracted and each MMA's types are constants
// there (as run-time values they keep the compiler from unrolling the pairs
// and scheduling the MMAs around them).  __byte_perm packs
// four consecutive-K bytes of one digit into a fragment register, and
// mma.sync m16n8k32 runs with the u8/s8 type of each digit for every pair
// with i < b_A, j < b_B and i + j <= 3, into one s32 accumulator per shift
// s = i + j.  The epilogue adds Σ acc_s << 8s in uint32_t.  The vote reads
// the data, so no hint can make a result wrong.  An accumulator of p pairs
// stays exact while K · p · 255 · 255 < 2^31: a block's K range (its split)
// is never longer than conv.GEMM_K_CHUNK (8192, four pairs), and splits of K
// add into a zeroed C with uint32_t atomics (exact and deterministic: the
// adds commute mod 2^32).  cp.async brings the int32 tiles into shared
// memory, STAGES deep, with 16-byte copies where every row is 16-byte
// aligned and 4-byte copies otherwise (the stem's K = 27, a kn B, which is
// transposed on the way in).  Rows of a tile are XOR-swizzled by 16-byte
// chunk so that a quarter-warp's 16-byte fragment loads hit 32 banks.
//
// int32, small-M path (gemm_small_kernel, M <= 16 with a kn B; the decode
// layer's M = 1): a thread owns four neighbouring columns of B (one 16-byte
// load a row) or one, walks a K range with MT <= 16 rows of A staged in
// shared memory, and adds its partial sums into a zeroed C with uint32_t
// atomics; the K ranges split so that the grid holds enough loads in flight.
//
// Bound on this card: bytes, for both.  ResNet18's 21 GEMMs at batch 32 read
// and write 666 MB (0.199 ms at 3.35 TB/s) and need about 142 G int8
// products at its data (0.072 ms at 1979 TOP/s); the decode layer's three
// M = 1 GEMMs move 35.1 MB (10.5 µs).
//
// float32 (gemm_f32_kernel): a SIMT GEMM on the CUDA cores with FFMA
// (__fmaf_rn), never TF32 and never the tensor cores.  Bound: operations (at
// (2048, 2304) x (2304, 256), 2.4 GFLOP against 7.3 MB).  Each 128-thread
// block owns a 128 x 64 tile of C over one K range; each thread holds 8 x 8
// outputs (rows ty*4 + {0..3} and +64, columns tx*4 + {0..3} and +32), so one
// K step costs four float4 shared loads for 64 FMAs.  Both tiles are stored
// K-major ([BK][BM] and [BK][BN], rows padded by 4 floats): cp.async brings
// them in F_STAGES deep, B as (K, N) by 16-byte copies when N % 4 == 0 and B
// is 16-byte aligned (4-byte copies otherwise), A and an (N, K) B transposed
// on the way in by 4-byte copies whose lanes (4 rows x 8 K a warp) hit 32
// distinct banks under the padding.  conv.gemm_f32_plan splits K so that the
// grid holds about two blocks an SM; the partial tiles of a split go to a
// workspace the wrapper allocates and gemm_f32_reduce adds them in split
// order, so that a result never depends on the order blocks run in (no float
// atomics).
#include "common.cuh"

namespace {

// ---------------------------------------------------------------- float32

constexpr int FBM = 128, FBN = 64, FBK = 16;  // conv.GEMM_F32_TILE
constexpr int F_STAGES = 2;                   // conv.GEMM_F32_STAGES
constexpr int F_TX = FBN / 8, F_TY = FBM / 8;  // threads along N and M, 8 x 8 outputs each
constexpr int F_THREADS = F_TX * F_TY;         // 128
constexpr int F_LDA = FBM + 4, F_LDB = FBN + 4;  // padded K rows (floats)
constexpr int F_STAGE = FBK * (F_LDA + F_LDB);   // floats a stage
// 25,600 bytes: within the default limit, so no cudaFuncSetAttribute is needed.
// Two stages (a double buffer) read faster than three in a sweep of tiles and
// stages at (2048, 2304) x (2304, 256) on the H100 (PERF.md §6).
constexpr int F_SMEM_BYTES = F_STAGES * F_STAGE * 4;
constexpr int F_REDUCE_THREADS = 256;
static_assert(FBK % 8 == 0 && FBM * FBK % F_THREADS == 0 && FBN * FBK % (4 * F_THREADS) == 0,
              "float32 tile / thread mismatch");

// A (M, K) row-major → as[kk][r]: lanes over 4 rows x 8 K, so that a warp's
// 4-byte stores hit 32 distinct banks under the padding.
__device__ __forceinline__ void f_load_a(float* as, const float* __restrict__ a, int m, int k, int row0, int k0,
                                         int k_end) {
#pragma unroll
  for (int j = 0; j < FBM * FBK / F_THREADS; ++j) {
    const int q = threadIdx.x + j * F_THREADS;
    const int r = q / (4 * FBK) * 4 + (q & 3), kk = (q >> 2) % FBK;
    const int gr = row0 + r, gk = k0 + kk;
    const bool ok = gr < m && gk < k_end;
    cp4(smem_addr(as + kk * F_LDA + r), ok ? a + static_cast<size_t>(gr) * k + gk : a, ok);
  }
}

// B → bs[kk][c]: (N, K) transposed like A; (K, N) by 16-byte copies (VEC) or
// by 4-byte copies along N.
template <bool B_NK, bool VEC>
__device__ __forceinline__ void f_load_b(float* bs, const float* __restrict__ b, int n, int k, int col0, int k0,
                                         int k_end) {
  if (B_NK) {
#pragma unroll
    for (int j = 0; j < FBN * FBK / F_THREADS; ++j) {
      const int q = threadIdx.x + j * F_THREADS;
      const int c = q / (4 * FBK) * 4 + (q & 3), kk = (q >> 2) % FBK;
      const int gc = col0 + c, gk = k0 + kk;
      const bool ok = gc < n && gk < k_end;
      cp4(smem_addr(bs + kk * F_LDB + c), ok ? b + static_cast<size_t>(gc) * k + gk : b, ok);
    }
  } else if (VEC) {
#pragma unroll
    for (int j = 0; j < FBN * FBK / 4 / F_THREADS; ++j) {
      const int q = threadIdx.x + j * F_THREADS;
      const int kk = q / (FBN / 4), c = q % (FBN / 4) * 4;
      const int gc = col0 + c, gk = k0 + kk;
      const bool ok = gc < n && gk < k_end;  // n % 4 == 0: a chunk is all in or all out
      cp16(smem_addr(bs + kk * F_LDB + c), ok ? b + static_cast<size_t>(gk) * n + gc : b, ok);
    }
  } else {
#pragma unroll
    for (int j = 0; j < FBN * FBK / F_THREADS; ++j) {
      const int q = threadIdx.x + j * F_THREADS;
      const int kk = q / FBN, c = q % FBN;
      const int gc = col0 + c, gk = k0 + kk;
      const bool ok = gc < n && gk < k_end;
      cp4(smem_addr(bs + kk * F_LDB + c), ok ? b + static_cast<size_t>(gk) * n + gc : b, ok);
    }
  }
}

// C (or split z's slab of the workspace) = A[:, K range z] @ B[K range z, :].
template <bool B_NK, bool VEC>
__global__ void __launch_bounds__(F_THREADS)
gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
                int m, int n, int k, int k_chunk) {
  extern __shared__ float4 f_smem_raw[];
  float* smem = reinterpret_cast<float*>(f_smem_raw);
  const int tx = threadIdx.x % F_TX, ty = threadIdx.x / F_TX;
  const int row0 = blockIdx.x * FBM, col0 = blockIdx.y * FBN;
  const int kb = blockIdx.z * k_chunk, ke = min(k, kb + k_chunk);
  const int steps = ke > kb ? (ke - kb + FBK - 1) / FBK : 0;
  c += static_cast<size_t>(blockIdx.z) * m * n;

  auto stage_a = [&](int s) { return smem + s * F_STAGE; };
  auto stage_b = [&](int s) { return smem + s * F_STAGE + FBK * F_LDA; };
  auto load = [&](int s, int k0) {
    f_load_a(stage_a(s), a, m, k, row0, k0, ke);
    f_load_b<B_NK, VEC>(stage_b(s), b, n, k, col0, k0, ke);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < steps) load(s, kb + s * FBK);
    cp_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_wait<F_STAGES - 2>();
    __syncthreads();
    {  // refill the stage the previous step read (every thread is past it)
      const int next = step + F_STAGES - 1;
      if (next < steps) load(next % F_STAGES, kb + next * FBK);
      cp_commit();
    }
    const float* as = stage_a(step % F_STAGES);
    const float* bs = stage_b(step % F_STAGES);
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * F_LDA + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * F_LDA + FBM / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * F_LDB + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * F_LDB + FBN / 2 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  }
  cp_wait<0>();

  const bool vec_out = (n & 3) == 0;  // rows of C 16-byte aligned (C from torch.empty)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i >> 2) * (FBM / 2) + ty * 4 + (i & 3);
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = col0 + h * (FBN / 2) + tx * 4;
      float* dst = c + static_cast<size_t>(r) * n + cc;
      if (vec_out && cc + 3 < n) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                                                      acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (cc + e < n) dst[e] = acc[i][h * 4 + e];
      }
    }
  }
}

// C = Σ_z ws[z] in split order z = 0, 1, ...: the same bits on every run.
template <typename V>
__global__ void __launch_bounds__(F_REDUCE_THREADS)
gemm_f32_reduce(const V* __restrict__ ws, V* __restrict__ c, long long count, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(F_REDUCE_THREADS) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * F_REDUCE_THREADS) {
    V s = ws[i];
    for (int z = 1; z < splits; ++z) {
      const V v = ws[z * count + i];
      if constexpr (sizeof(V) == 16) {
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      } else {
        s += v;
      }
    }
    c[i] = s;
  }
}

// ------------------------------------------------- int32, tensor-core tile

constexpr int TBM = 64, TBN = 64, TBK = 32;  // conv.GEMM_TILE
constexpr int STAGES = 3;
constexpr int TILE_THREADS = 128;            // 2 x 2 warps, each 32 x 32 of C
constexpr int TILE_WORDS = TBM * TBK;        // A and B tiles alike: 64 rows of 32 K
// 48 KB: within the default limit, so no cudaFuncSetAttribute is needed
constexpr int SMEM_BYTES = STAGES * 2 * TILE_WORDS * 4;

// Word of (row r, K column c) in a tile: 16-byte chunk c / 4 XOR-ed with the
// row's parity, so rows r and r + 1 of a quarter-warp's loads hit disjoint
// banks.
__device__ __forceinline__ int swz(int r, int c) {
  return r * TBK + ((((c >> 2) ^ ((r & 1) << 2))) << 2) + (c & 3);
}

// B's modes: (N, K) with 16-byte copies, (N, K) with 4-byte copies, (K, N)
// transposed into the tile's [n][k] rows by 4-byte copies.
enum BMode { B_NK16 = 0, B_NK4 = 1, B_KN4 = 2 };

// One 64 x 32 tile of a row-major (rows, k) matrix into `tile` (rows from
// r0, K columns from k0; zero past `rows` or past `k_end`).
template <bool VEC>
__device__ __forceinline__ void load_rows(uint32_t* tile, const uint32_t* __restrict__ src, int rows,
                                          int k, int r0, int k0, int k_end) {
  if (VEC) {
#pragma unroll
    for (int j = 0; j < TILE_WORDS / 4 / TILE_THREADS; ++j) {  // 4 chunks of 16 bytes a thread
      const int q = threadIdx.x + j * TILE_THREADS;
      const int r = q >> 3, c = (q & 7) << 2;
      const int gr = r0 + r, gk = k0 + c;
      const bool ok = gr < rows && gk < k_end;
      cp16(smem_addr(tile + swz(r, c)), ok ? src + static_cast<size_t>(gr) * k + gk : src, ok);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < TILE_WORDS / TILE_THREADS; ++j) {  // 16 words a thread
      const int q = threadIdx.x + j * TILE_THREADS;
      const int r = q >> 5, c = q & 31;
      const int gr = r0 + r, gk = k0 + c;
      const bool ok = gr < rows && gk < k_end;
      cp4(smem_addr(tile + swz(r, c)), ok ? src + static_cast<size_t>(gr) * k + gk : src, ok);
    }
  }
}

// One 32 x 64 tile of a row-major (k, n) matrix, transposed into the tile's
// [n][k] rows.
__device__ __forceinline__ void load_kn(uint32_t* tile, const uint32_t* __restrict__ src, int n,
                                        int c0, int k0, int k_end) {
#pragma unroll 4
  for (int j = 0; j < TILE_WORDS / TILE_THREADS; ++j) {
    const int q = threadIdx.x + j * TILE_THREADS;
    const int kk = q >> 6, cc = q & 63;
    const int gk = k0 + kk, gc = c0 + cc;
    const bool ok = gk < k_end && gc < n;
    cp4(smem_addr(tile + swz(cc, kk)), ok ? src + static_cast<size_t>(gk) * n + gc : src, ok);
  }
}

// Signed bytes that hold every value whose x ^ (x >> 31) was OR-ed into y.
__device__ __forceinline__ int bytes_needed(uint32_t y) {
  return y < 0x80u ? 1 : y < 0x8000u ? 2 : y < 0x800000u ? 3 : 4;
}

__device__ __forceinline__ uint32_t magnitude_bits(uint32_t x) {
  return x ^ static_cast<uint32_t>(static_cast<int32_t>(x) >> 31);
}

// Four int32 words of consecutive K → d[i] = their bytes i for i < ND,
// packed low to high in K order (a 4 x 4 byte transpose, cut to ND rows).
template <int ND>
__device__ __forceinline__ void to_digits(const uint4 w, uint32_t d[4]) {
  if (ND == 1) {
    d[0] = __byte_perm(__byte_perm(w.x, w.y, 0x0040), __byte_perm(w.z, w.w, 0x0040), 0x5410);
    return;
  }
  const uint32_t lo01 = __byte_perm(w.x, w.y, 0x5140), lo23 = __byte_perm(w.z, w.w, 0x5140);
  d[0] = __byte_perm(lo01, lo23, 0x5410);
  d[1] = __byte_perm(lo01, lo23, 0x7632);
  if (ND == 2) return;
  const uint32_t hi01 = __byte_perm(w.x, w.y, 0x7362), hi23 = __byte_perm(w.z, w.w, 0x7362);
  d[2] = __byte_perm(hi01, hi23, 0x5410);
  if (ND == 4) d[3] = __byte_perm(hi01, hi23, 0x7632);
}

template <bool SA, bool SB>
__device__ __forceinline__ void mma(int c[4], const uint32_t a[4], const uint32_t b[2]) {
#define REPRO_MMA(TA, TB)                                                                  \
  asm("mma.sync.aligned.m16n8k32.row.col.s32." TA "." TB ".s32 "                          \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"                   \
               : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))
  if (SA && SB) REPRO_MMA("s8", "s8");
  else if (SA) REPRO_MMA("s8", "u8");
  else if (SB) REPRO_MMA("u8", "s8");
  else REPRO_MMA("u8", "u8");
#undef REPRO_MMA
}

// The pair (digit i of A, digit j of B) over a warp's four 8-column tiles.
template <bool SA, bool SB>
__device__ __forceinline__ void mma_row(int acc[4][4], const uint32_t a[4], const uint32_t b[4][2]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) mma<SA, SB>(acc[nt], a, b[nt]);
}

// B's digits, NB of them, from the warp's raw B words: bd[digit][nt][register].
template <int NB>
__device__ __forceinline__ void b_digits(const uint4 bw[4][2], uint32_t bd[4][4][2]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t d[4];
      to_digits<NB>(bw[nt][h], d);
#pragma unroll
      for (int i = 0; i < NB; ++i) bd[i][nt][h] = d[i];
    }
}

// One 16-row tile's K step with NA digits of A and NB of B, known at
// compile time: A's digits from its raw words, then every pair whose shift
// stays below 32 bits into the accumulator of its shift.
template <int NA, int NB>
__device__ __forceinline__ void mma_tile(int acc[4][4][4], const uint4 aw[4], const uint32_t bd[4][4][2]) {
  uint32_t ad[4][4];  // [digit][register]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t d[4];
    to_digits<NA>(aw[q], d);
#pragma unroll
    for (int i = 0; i < NA; ++i) ad[i][q] = d[i];
  }
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (i + j > 3) continue;
      const bool sa = i == NA - 1, sb = j == NB - 1;
      if (sa && sb) mma_row<true, true>(acc[i + j], ad[i], bd[j]);
      else if (sa) mma_row<true, false>(acc[i + j], ad[i], bd[j]);
      else if (sb) mma_row<false, true>(acc[i + j], ad[i], bd[j]);
      else mma_row<false, false>(acc[i + j], ad[i], bd[j]);
    }
}

template <bool A_VEC, int B_MODE>
__global__ void __launch_bounds__(TILE_THREADS)
gemm_tile_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ c,
                 int m, int n, int k, int k_chunk, int atomic) {
  extern __shared__ uint4 smem_raw[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_raw);
  const int row0 = blockIdx.x * TBM, col0 = blockIdx.y * TBN;
  const int kb = blockIdx.z * k_chunk, ke = min(k, kb + k_chunk);
  const int steps = (ke - kb + TBK - 1) / TBK;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;  // the warp's 32 x 32 of the block's 64 x 64
  const int g = lane >> 2, t = lane & 3;

  auto stage_a = [&](int s) { return smem + s * 2 * TILE_WORDS; };
  auto stage_b = [&](int s) { return smem + s * 2 * TILE_WORDS + TILE_WORDS; };
  auto load = [&](int s, int k0) {
    load_rows<A_VEC>(stage_a(s), a, m, k, row0, k0, ke);
    if (B_MODE == B_KN4) load_kn(stage_b(s), b, n, col0, k0, ke);
    else load_rows<B_MODE == B_NK16>(stage_b(s), b, n, k, col0, k0, ke);
  };

  // acc_mt[mt][s][nt][e]: 16-row tile mt, shift s, 8-column tile nt
  int acc_mt[2][4][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_mt[i][s][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, kb + s * TBK);
    cp_commit();
  }

  for (int step = 0; step < steps; ++step) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    {  // refill the stage the previous step read (every thread is past it)
      const int next = step + STAGES - 1;
      if (next < steps) load(next % STAGES, kb + next * TBK);
      cp_commit();
    }
    const uint32_t* as = stage_a(step % STAGES);
    const uint32_t* bs = stage_b(step % STAGES);

    // B: 4 column tiles × 2 registers, each from one 16-byte chunk of a row
    uint4 bw[4][2];
    uint32_t yb = 0;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = wn * 32 + nt * 8 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bw[nt][h] = *reinterpret_cast<const uint4*>(bs + swz(r, h * 16 + t * 4));
        yb |= magnitude_bits(bw[nt][h].x) | magnitude_bits(bw[nt][h].y) |
              magnitude_bits(bw[nt][h].z) | magnitude_bits(bw[nt][h].w);
      }
    }
    const int nb = bytes_needed(__reduce_or_sync(0xffffffffu, yb));
    uint32_t bd[4][4][2];  // [digit][nt][register]
    switch (nb) {  // the vote picks code whose digit counts are constants
      case 1: b_digits<1>(bw, bd); break;
      case 2: b_digits<2>(bw, bd); break;
      case 3: b_digits<3>(bw, bd); break;
      default: b_digits<4>(bw, bd); break;
    }

    uint4 aw[2][4];
    uint32_t ya = 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wm * 32 + mt * 16 + g + (q & 1) * 8;
        aw[mt][q] = *reinterpret_cast<const uint4*>(as + swz(r, (q >> 1) * 16 + t * 4));
        ya |= magnitude_bits(aw[mt][q].x) | magnitude_bits(aw[mt][q].y) | magnitude_bits(aw[mt][q].z) |
              magnitude_bits(aw[mt][q].w);
      }
    const int na = bytes_needed(__reduce_or_sync(0xffffffffu, ya));
    switch ((na - 1) * 4 + nb - 1) {
#define REPRO_TILE(A, B) \
  case (A - 1) * 4 + B - 1: mma_tile<A, B>(acc_mt[0], aw[0], bd); mma_tile<A, B>(acc_mt[1], aw[1], bd); break;
      REPRO_TILE(1, 1) REPRO_TILE(1, 2) REPRO_TILE(1, 3) REPRO_TILE(1, 4)
      REPRO_TILE(2, 1) REPRO_TILE(2, 2) REPRO_TILE(2, 3) REPRO_TILE(2, 4)
      REPRO_TILE(3, 1) REPRO_TILE(3, 2) REPRO_TILE(3, 3) REPRO_TILE(3, 4)
      REPRO_TILE(4, 1) REPRO_TILE(4, 2) REPRO_TILE(4, 3) REPRO_TILE(4, 4)
#undef REPRO_TILE
    }
  }
  cp_wait<0>();

  // C: Σ acc_s << 8s mod 2^32; registers (e) 0-1 at row g, 2-3 at row g+8,
  // columns 2t and 2t+1 of each 8-column tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm * 32 + mt * 16 + g + (e >> 1) * 8;
        const int cc = col0 + wn * 32 + nt * 8 + 2 * t + (e & 1);
        if (r >= m || cc >= n) continue;
        const uint32_t v = static_cast<uint32_t>(acc_mt[mt][0][nt][e]) +
                           (static_cast<uint32_t>(acc_mt[mt][1][nt][e]) << 8) +
                           (static_cast<uint32_t>(acc_mt[mt][2][nt][e]) << 16) +
                           (static_cast<uint32_t>(acc_mt[mt][3][nt][e]) << 24);
        uint32_t* dst = c + static_cast<size_t>(r) * n + cc;
        if (atomic) atomicAdd(dst, v);
        else *dst = v;
      }
}

// ------------------------------------------------------ int32, small M

constexpr int SMALL_THREADS = 128;  // conv.GEMM_SMALL_THREADS
constexpr int SMALL_MAX_K = 256;    // conv.GEMM_SMALL_MAX_K: A rows staged per block

// V: uint4 (four columns of B a thread, 16-byte loads) or uint32_t (one).
template <int MT, typename V>
__global__ void __launch_bounds__(SMALL_THREADS)
gemm_small_kernel(const uint32_t* __restrict__ a, const V* __restrict__ b, uint32_t* __restrict__ c,
                  int m, int n, int k, int k_chunk) {
  constexpr int W = sizeof(V) / 4;  // columns a thread
  __shared__ uint32_t as[MT][SMALL_MAX_K];
  const int kb = blockIdx.y * k_chunk, len = min(k, kb + k_chunk) - kb;
  for (int i = threadIdx.x; i < MT * SMALL_MAX_K; i += SMALL_THREADS) {
    const int r = i / SMALL_MAX_K, kk = i % SMALL_MAX_K;
    as[r][kk] = (r < m && kk < len) ? a[static_cast<size_t>(r) * k + kb + kk] : 0u;
  }
  __syncthreads();
  const int groups = n / W;
  const int grp = blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (grp >= groups) return;
  uint32_t acc[MT][W];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int e = 0; e < W; ++e) acc[r][e] = 0u;
  const V* bp = b + static_cast<size_t>(kb) * groups + grp;
  int kk = 0;
  for (; kk + 4 <= len; kk += 4) {  // four rows of B in flight
    V bv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) bv[u] = __ldg(bp + static_cast<size_t>(kk + u) * groups);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t* be = reinterpret_cast<const uint32_t*>(&bv[u]);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const uint32_t av = as[r][kk + u];
#pragma unroll
        for (int e = 0; e < W; ++e) acc[r][e] += av * be[e];
      }
    }
  }
  for (; kk < len; ++kk) {
    const V bv = __ldg(bp + static_cast<size_t>(kk) * groups);
    const uint32_t* be = reinterpret_cast<const uint32_t*>(&bv);
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int e = 0; e < W; ++e) acc[r][e] += as[r][kk] * be[e];
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    if (r >= m) break;
#pragma unroll
    for (int e = 0; e < W; ++e) atomicAdd(c + static_cast<size_t>(r) * n + grp * W + e, acc[r][e]);
  }
}

template <int MT>
void launch_small(const void* a, const void* b, void* c, int m, int n, int k, int vec, int splits,
                  int k_chunk, cudaStream_t s) {
  const int groups = vec ? n / 4 : n;
  const dim3 grid((groups + SMALL_THREADS - 1) / SMALL_THREADS, splits);
  if (vec)
    gemm_small_kernel<MT, uint4><<<grid, SMALL_THREADS, 0, s>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint4*>(b), static_cast<uint32_t*>(c), m, n, k, k_chunk);
  else
    gemm_small_kernel<MT, uint32_t><<<grid, SMALL_THREADS, 0, s>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), static_cast<uint32_t*>(c), m, n, k,
        k_chunk);
}

template <bool A_VEC, int B_MODE>
int launch_tile(const void* a, const void* b, void* c, int m, int n, int k, int splits, int k_chunk,
                cudaStream_t s) {
  const dim3 grid((m + TBM - 1) / TBM, (n + TBN - 1) / TBN, splits);
  gemm_tile_kernel<A_VEC, B_MODE><<<grid, TILE_THREADS, SMEM_BYTES, s>>>(static_cast<const uint32_t*>(a),
                                                static_cast<const uint32_t*>(b), static_cast<uint32_t*>(c), m,
                                                n, k, k_chunk, splits > 1);
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

// int32: the launch plan of conv.gemm_plan after the extents.  `b_nk`: B is
// (N, K); `small`: the small-M kernel (M <= 16, B (K, N)); `a_vec`, `b_vec`:
// 16-byte copies of A's and B's rows; `splits` K ranges of `k_chunk` each
// (K-tile multiples on the tile path), added into C zeroed here when there
// is more than one (always on the small-M path).
extern "C" int int_gemm_i32(const void* a, const void* b, void* c, int m, int n, int k, int b_nk, int small,
                            int a_vec, int b_vec, int splits, int k_chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (small || splits > 1) {
    const cudaError_t e = cudaMemsetAsync(c, 0, static_cast<size_t>(m) * n * 4, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (small) {
    if (m <= 1) launch_small<1>(a, b, c, m, n, k, b_vec, splits, k_chunk, s);
    else if (m <= 2) launch_small<2>(a, b, c, m, n, k, b_vec, splits, k_chunk, s);
    else if (m <= 4) launch_small<4>(a, b, c, m, n, k, b_vec, splits, k_chunk, s);
    else if (m <= 8) launch_small<8>(a, b, c, m, n, k, b_vec, splits, k_chunk, s);
    else launch_small<16>(a, b, c, m, n, k, b_vec, splits, k_chunk, s);
    return REPRO_LAUNCH_STATUS();
  }
  const int mode = !b_nk ? B_KN4 : b_vec ? B_NK16 : B_NK4;
  if (a_vec) {
    if (mode == B_NK16) return launch_tile<true, B_NK16>(a, b, c, m, n, k, splits, k_chunk, s);
    if (mode == B_NK4) return launch_tile<true, B_NK4>(a, b, c, m, n, k, splits, k_chunk, s);
    return launch_tile<true, B_KN4>(a, b, c, m, n, k, splits, k_chunk, s);
  }
  if (mode == B_NK16) return launch_tile<false, B_NK16>(a, b, c, m, n, k, splits, k_chunk, s);
  if (mode == B_NK4) return launch_tile<false, B_NK4>(a, b, c, m, n, k, splits, k_chunk, s);
  return launch_tile<false, B_KN4>(a, b, c, m, n, k, splits, k_chunk, s);
}

// float32: B (K, N), or (N, K) when `b_nk`; the launch plan of
// conv.gemm_f32_plan after it: `b_vec` (16-byte copies of a (K, N) B),
// `splits` K ranges of `k_chunk` each.  With more than one split the partial
// tiles go to `ws` (splits x M x N floats) and are added into C in order.
extern "C" int int_gemm_f32(const void* a, const void* b, void* c, void* ws, int m, int n, int k, int b_nk,
                            int b_vec, int splits, int k_chunk, void* stream) {
  if (splits < 1 || (splits > 1 && ws == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + FBM - 1) / FBM, (n + FBN - 1) / FBN, splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* dst = static_cast<float*>(splits > 1 ? ws : c);
  if (b_nk) gemm_f32_kernel<true, false><<<grid, F_THREADS, F_SMEM_BYTES, s>>>(fa, fb, dst, m, n, k, k_chunk);
  else if (b_vec) gemm_f32_kernel<false, true><<<grid, F_THREADS, F_SMEM_BYTES, s>>>(fa, fb, dst, m, n, k, k_chunk);
  else gemm_f32_kernel<false, false><<<grid, F_THREADS, F_SMEM_BYTES, s>>>(fa, fb, dst, m, n, k, k_chunk);
  if (splits == 1) return REPRO_LAUNCH_STATUS();
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long count = static_cast<long long>(m) * n;
  if (count % 4 == 0)
    gemm_f32_reduce<float4><<<repro_grid(count / 4, F_REDUCE_THREADS), F_REDUCE_THREADS, 0, s>>>(
        static_cast<const float4*>(ws), static_cast<float4*>(c), count / 4, splits);
  else
    gemm_f32_reduce<float><<<repro_grid(count, F_REDUCE_THREADS), F_REDUCE_THREADS, 0, s>>>(
        static_cast<const float*>(ws), static_cast<float*>(c), count, splits);
  return REPRO_LAUNCH_STATUS();
}
