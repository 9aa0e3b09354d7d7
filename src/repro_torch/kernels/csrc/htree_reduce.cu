// H-tree reduction: (N, D) → (D,) summed over N in the H-tree's order,
// adjacent pairs first, then pairs of pairs (N a power of two).
//
// Replaces the Pallas body of src/repro/kernels/htree_reduce.py:
//   _kernel (25, htree_reduce) → htree_chunk_kernel below.
// The Pallas body halves an (N, bd) slab held in VMEM log2(N) times.
//
// Bound on this card: bytes.  One add per element read, so (256, 65536) in
// float32 or int32 moves 67.1 MB (20.0 µs at 3.35 TB/s); what keeps a kernel
// from that rate is too little memory traffic in flight.  One column a
// thread, with 4-byte loads, reaches only 65536 threads at D = 65536, a
// quarter of the card.
//
// Design: the N rows of a column split into S aligned power-of-two chunks,
// each a subtree of the H-tree, and a thread sums one chunk of one group of
// columns: the 16 bytes of neighbouring columns (4 float32 or int32, 8
// bfloat16) with one load a row where D is a multiple of them and the base
// is 16-byte aligned, one column otherwise (htree_reduce.htree_plan picks S,
// the loads and the blocks, so that the grid holds about half a card's
// threads).  A thread loads its chunk GROUP rows at a time, adds each load
// group as a subtree in registers, adjacent pairs first, and merges the
// group sums through a binary counter: group g is merged with the partial
// of level l while bit l of g is set, the earlier partial on the left —
// exactly the tree's sums, in its order.  Chunks of up to GROUP << 4 rows
// keep the counter in registers (its depth fixed per launch); longer chunks
// keep it in local memory.  A block is S chunk rows × (THREADS / S) column
// groups; the S chunk sums meet in shared memory and are added adjacent
// pairs first, one level per barrier, in one launch with no atomics.
//
// Each partial is rounded to the input's type, as the tree rounds it:
// float32 adds are IEEE adds (nvcc does not reassociate them), bfloat16
// partials are added in float32 and rounded to bfloat16 (round to nearest
// even), as PyTorch and XLA do, and int32 sums wrap mod 2^32 (in uint32_t).
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int CHUNK_THREADS = 256;   // htree_reduce.HTREE_THREADS
constexpr int MAX_CHUNKS = 32;       // htree_reduce.HTREE_MAX_CHUNKS
constexpr int GROUP = 8;             // rows a thread loads, then adds as one subtree
constexpr int MAX_REG_LEVELS = 4;    // chunks of up to GROUP << 4 rows: counter in registers
constexpr int MAX_LEVELS = 32;       // N < 2^31
static_assert(CHUNK_THREADS % MAX_CHUNKS == 0 && CHUNK_THREADS / MAX_CHUNKS >= 8,
              "a block holds whole rows of chunks, at least 8 column groups wide");

// a bfloat16 as its bits, so that packs of them stay plain data in shared memory
struct BF16 {
  unsigned short bits;
};

__device__ __forceinline__ float add1(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ uint32_t add1(uint32_t a, uint32_t b) { return a + b; }
__device__ __forceinline__ BF16 add1(BF16 a, BF16 b) {
  const float r = __bfloat162float(__ushort_as_bfloat16(a.bits)) + __bfloat162float(__ushort_as_bfloat16(b.bits));
  return {__bfloat16_as_ushort(__float2bfloat16_rn(r))};
}

// W neighbouring columns of element type E, loaded and added together.
template <typename E, int W>
struct alignas(sizeof(E) * W) Pack {
  E v[W];
};

template <typename E, int W>
__device__ __forceinline__ Pack<E, W> add(Pack<E, W> a, const Pack<E, W>& b) {
#pragma unroll
  for (int i = 0; i < W; ++i) a.v[i] = add1(a.v[i], b.v[i]);
  return a;
}

template <typename P>
__device__ __forceinline__ P load(const P* p) {
  P r;
  if constexpr (sizeof(P) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  } else if constexpr (sizeof(P) == 4) {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
    memcpy(&r, &u, 4);
  } else {
    static_assert(sizeof(P) == 2, "16-, 4- or 2-byte packs");
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&r, &u, 2);
  }
  return r;
}

// P: a pack of columns; G rows a load group; LV >= 0: every chunk holds
// G << LV rows and the counter (LV levels) stays in registers, each index a
// constant; LV < 0: any number of groups, the counter in local memory.
template <typename P, int G, int LV>
__global__ void __launch_bounds__(CHUNK_THREADS)
htree_chunk_kernel(const P* __restrict__ x, P* __restrict__ out, int n, int groups, int chunks) {
  __shared__ P part[CHUNK_THREADS];
  const int cols = CHUNK_THREADS / chunks;            // column groups a block
  const int s = threadIdx.x / cols;                   // this thread's chunk
  const int grp = blockIdx.x * cols + threadIdx.x % cols;
  const int rows = n / chunks;                        // a power of two
  P v{};
  if (grp < groups) {
    const P* xc = x + static_cast<size_t>(s) * rows * groups + grp;
    P pend[LV > 0 ? LV : LV < 0 ? MAX_LEVELS : 1];
    const int n_groups = LV >= 0 ? 1 << LV : rows / G;
#pragma unroll 1
    for (int gi = 0; gi < n_groups; ++gi) {
      P b[G];
#pragma unroll
      for (int j = 0; j < G; ++j) b[j] = load(xc + static_cast<size_t>(gi * G + j) * groups);
#pragma unroll
      for (int w = 1; w < G; w *= 2)  // the group's levels, adjacent pairs first
#pragma unroll
        for (int j = 0; j < G; j += 2 * w) b[j] = add(b[j], b[j + w]);
      P r = b[0];
      if constexpr (LV >= 0) {
#pragma unroll
        for (int l = 0; l < (LV > 0 ? LV : 0); ++l) {
          if (!((gi >> l) & 1)) {
            pend[l] = r;
            break;
          }
          r = add(pend[l], r);
        }
      } else {
        for (int l = 0; (gi >> l) & 1; ++l) r = add(pend[l], r);
        pend[__ffs(~gi) - 1] = r;
      }
      v = r;  // after the last group: the chunk's root
    }
  }
  part[threadIdx.x] = v;
  for (int w = 1; w < chunks; w *= 2) {  // adjacent chunks first
    __syncthreads();
    if (s % (2 * w) == 0) part[threadIdx.x] = add(part[threadIdx.x], part[threadIdx.x + w * cols]);
  }
  if (s == 0 && grp < groups) out[grp] = part[threadIdx.x];
}

template <typename P>
void launch_chunks(const void* x, void* out, int n, int groups, int chunks, int blocks, cudaStream_t s) {
  const P* xv = static_cast<const P*>(x);
  P* ov = static_cast<P*>(out);
  const int rows = n / chunks;
#define REPRO_CHUNK(G, LV) htree_chunk_kernel<P, G, LV><<<blocks, CHUNK_THREADS, 0, s>>>(xv, ov, n, groups, chunks)
  if (rows == 1) REPRO_CHUNK(1, 0);
  else if (rows == 2) REPRO_CHUNK(2, 0);
  else if (rows == 4) REPRO_CHUNK(4, 0);
  else if (rows == GROUP) REPRO_CHUNK(GROUP, 0);
  else if (rows == GROUP << 1) REPRO_CHUNK(GROUP, 1);
  else if (rows == GROUP << 2) REPRO_CHUNK(GROUP, 2);
  else if (rows == GROUP << 3) REPRO_CHUNK(GROUP, 3);
  else if (rows == GROUP << MAX_REG_LEVELS) REPRO_CHUNK(GROUP, MAX_REG_LEVELS);
  else REPRO_CHUNK(GROUP, -1);
#undef REPRO_CHUNK
}

// The launch plan (htree_reduce.htree_plan): `chunks` (a power of two, at
// most N and MAX_CHUNKS) chunks a column, `vec` 16-byte loads of 16 / sizeof(E)
// columns (D a multiple of them, x and out 16-byte aligned), `blocks` blocks.
template <typename E>
int launch(const void* x, void* out, int n, int d, int chunks, int vec, int blocks, void* stream) {
  constexpr int W = 16 / sizeof(E);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) launch_chunks<Pack<E, W>>(x, out, n, d / W, chunks, blocks, s);
  else launch_chunks<Pack<E, 1>>(x, out, n, d, chunks, blocks, s);
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

// x (N, D) row-major, N a power of two (the wrapper checks), D >= 1; out (D,).
extern "C" int htree_reduce_f32(const void* x, void* out, int n, int d, int chunks, int vec, int blocks,
                                void* stream) {
  return launch<float>(x, out, n, d, chunks, vec, blocks, stream);
}

extern "C" int htree_reduce_bf16(const void* x, void* out, int n, int d, int chunks, int vec, int blocks,
                                 void* stream) {
  return launch<BF16>(x, out, n, d, chunks, vec, blocks, stream);
}

extern "C" int htree_reduce_i32(const void* x, void* out, int n, int d, int chunks, int vec, int blocks,
                                void* stream) {
  return launch<uint32_t>(x, out, n, d, chunks, vec, blocks, stream);
}
