// H-tree reduction: (N, D) → (D,) summed over N in the H-tree's order,
// adjacent pairs first, then pairs of pairs (N a power of two).
//
// Replaces the Pallas body of src/repro/kernels/htree_reduce.py:
//   _kernel (25, htree_reduce) → htree_reduce_kernel below.
// The Pallas body halves an (N, bd) slab held in VMEM log2(N) times; here a
// thread owns one column and walks its N rows once, in order.
//
// Order: a binary counter of partial sums.  Row i is pushed at level 0 and
// merged with the partial of level l while bit l of i is set, the earlier
// partial on the left — exactly the tree's sums, in its order.  Rows come in
// groups of GROUP (N >= GROUP is a multiple of it): the group's own subtree
// is added with constant indices in registers, and its sum pushed at level
// log2(GROUP), so the counter (at most 32 partials, in local memory) is
// touched once a group.  N < GROUP pushes row by row.
//
// Each partial is rounded to the input's type: float32 adds are IEEE adds
// (nvcc does not reassociate them), bfloat16 partials are added in float32
// and rounded to bfloat16 (round to nearest even), as PyTorch and XLA do,
// and int32 sums wrap mod 2^32 (in uint32_t).
//
// Bound on this card: bytes.  One add per element read, so (256, 65536)
// float32 moves 67.1 MB (20.0 µs at 3.35 TB/s).  Row-major loads coalesce
// across the threads of a warp (neighbouring columns); each thread loads a
// group's GROUP rows before it adds them, since the loads do not depend on
// the sums.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 8;  // rows a thread loads, then adds as one subtree
constexpr int MAX_LEVELS = 32;  // N < 2^31

struct AddF32 {
  using T = float;
  using Acc = float;
  __device__ static Acc load(const T* p) { return __ldg(p); }
  __device__ static Acc add(Acc a, Acc b) { return __fadd_rn(a, b); }
  __device__ static T store(Acc a) { return a; }
};

struct AddBF16 {
  using T = __nv_bfloat16;
  using Acc = __nv_bfloat16;
  __device__ static Acc load(const T* p) { return *p; }
  __device__ static Acc add(Acc a, Acc b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  __device__ static T store(Acc a) { return a; }
};

struct AddI32 {
  using T = int32_t;
  using Acc = uint32_t;
  __device__ static Acc load(const T* p) { return static_cast<uint32_t>(__ldg(p)); }
  __device__ static Acc add(Acc a, Acc b) { return a + b; }
  __device__ static T store(Acc a) { return static_cast<int32_t>(a); }
};

// Push v, the i-th subtree sum of its level, onto the counter (part[l]
// holds a sum of 2^l such subtrees); returns the merged sum, which is the
// root once the last subtree is pushed.
template <typename Op>
__device__ __forceinline__ typename Op::Acc push(typename Op::Acc* part, typename Op::Acc v,
                                                 unsigned int i) {
  for (int l = 0; (i >> l) & 1u; ++l) v = Op::add(part[l], v);
  part[__ffs(~i) - 1] = v;
  return v;
}

template <typename Op>
__global__ void __launch_bounds__(THREADS)
htree_reduce_kernel(const typename Op::T* __restrict__ x, typename Op::T* __restrict__ out,
                    int n, int d) {
  using Acc = typename Op::Acc;
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= d) return;
  const typename Op::T* xc = x + col;
  Acc part[MAX_LEVELS];
  Acc v{};
  if (n < GROUP) {
    for (int i = 0; i < n; ++i)
      v = push<Op>(part, Op::load(xc + static_cast<size_t>(i) * d), static_cast<unsigned int>(i));
  } else {
    for (int g = 0; g < n / GROUP; ++g) {
      Acc b[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) b[j] = Op::load(xc + static_cast<size_t>(g * GROUP + j) * d);
#pragma unroll
      for (int w = 1; w < GROUP; w *= 2)  // the group's levels, adjacent pairs first
#pragma unroll
        for (int j = 0; j < GROUP; j += 2 * w) b[j] = Op::add(b[j], b[j + w]);
      v = push<Op>(part, b[0], static_cast<unsigned int>(g));
    }
  }
  out[col] = Op::store(v);
}

template <typename Op>
int launch(const void* x, void* out, int n, int d, cudaStream_t s) {
  const unsigned int blocks = static_cast<unsigned int>((d + THREADS - 1) / THREADS);
  htree_reduce_kernel<Op><<<blocks, THREADS, 0, s>>>(static_cast<const typename Op::T*>(x),
                                                     static_cast<typename Op::T*>(out), n, d);
  return REPRO_LAUNCH_STATUS();
}

}  // namespace

// x (N, D) row-major, N a power of two (the wrapper checks), D >= 1; out (D,).
extern "C" int htree_reduce_f32(const void* x, void* out, int n, int d, void* stream) {
  return launch<AddF32>(x, out, n, d, static_cast<cudaStream_t>(stream));
}

extern "C" int htree_reduce_bf16(const void* x, void* out, int n, int d, void* stream) {
  return launch<AddBF16>(x, out, n, d, static_cast<cudaStream_t>(stream));
}

extern "C" int htree_reduce_i32(const void* x, void* out, int n, int d, void* stream) {
  return launch<AddI32>(x, out, n, d, static_cast<cudaStream_t>(stream));
}
