// Integer (and float32) matrix product C = A @ B, row-major, A (M, K),
// B (K, N), C (M, N).
//
// Replaces the Pallas body `_dot_kernel` (src/repro/kernels/conv.py:49),
// reached through `_blocked_matmul` (conv.py:56) from conv2d (after im2col)
// and int_matmul.  The Pallas kernel keeps all of K resident in VMEM
// (conv.py:70); on Hopper a block has at most 227 KB of shared memory, which
// K = 4608 (ResNet18's stage 4) does not fit, so this kernel walks K in tiles
// of BK inside the block.  Each block owns a BM x BN output tile; each of its
// 256 threads accumulates TM x TN outputs in registers.  Ragged M, N and K
// edges are masked with zero fill on load and skipped on store.
//
// int32: the product wraps mod 2^32 exactly as the JAX oracle does.  Signed
// overflow is undefined in C++, so the int32 instance multiplies and adds in
// uint32_t and the caller's int32 buffers are reinterpreted, never converted.
// float32: plain FMA on the CUDA cores, never TF32.
//
// Bound: the int32 instance runs on IMAD, 64 per clock per SM on Hopper, so
// ResNet18's ~0.56 G MAC per image is operation-bound (the bytes are ~10x
// below the memory rate).  This first kernel is simple tiled SIMT code;
// int8 tensor-core digits are later work.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int ROW_STEP = BM / TM;               // 16: rows of a thread are strided
constexpr int COL_STEP = BN / TN;               // 16: so are its columns

__device__ __forceinline__ uint32_t mac(uint32_t acc, uint32_t a, uint32_t b) {
  return acc + a * b;
}
__device__ __forceinline__ float mac(float acc, float a, float b) {
  return __fmaf_rn(a, b, acc);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
            int m, int n, int k) {
  __shared__ T as[BK][BM + 1];  // +1: the transposing store avoids bank conflicts
  __shared__ T bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % COL_STEP, ty = tid / COL_STEP;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? a[static_cast<size_t>(gr) * k + gk] : T(0);
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, cc = i % BN;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n) ? b[static_cast<size_t>(gk) * n + gc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + i * ROW_STEP];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * COL_STEP];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(acc[i][j], av[i], bv[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * ROW_STEP;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = col0 + tx + j * COL_STEP;
      if (cc < n) c[static_cast<size_t>(r) * n + cc] = acc[i][j];
    }
  }
}

template <typename T>
int launch_gemm(const void* a, const void* b, void* c, int m, int n, int k, void* stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  gemm_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), m, n, k);
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

extern "C" int int_gemm_i32(const void* a, const void* b, void* c, int m, int n, int k,
                            void* stream) {
  return launch_gemm<uint32_t>(a, b, c, m, n, k, stream);
}

extern "C" int int_gemm_f32(const void* a, const void* b, void* c, int m, int n, int k,
                            void* stream) {
  return launch_gemm<float>(a, b, c, m, n, k, stream);
}
