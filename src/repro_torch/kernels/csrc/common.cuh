// Shared by the port's CUDA sources.  Each source is built into its own
// shared library with a plain C interface (see ../_build.py); every entry
// point launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define REPRO_LAUNCH_STATUS() static_cast<int>(cudaGetLastError())

// Text for an error code returned by an entry point of this library.
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks for a grid-stride loop over `work` items of `per_block` each,
// capped so a large launch does not queue more blocks than it can use.
static inline unsigned int repro_grid(long long work, int per_block) {
  long long blocks = (work + per_block - 1) / per_block;
  const long long cap = 132LL * 32;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned int>(blocks < 1 ? 1 : blocks);
}

// cp.async (sm_80+): a 16- or 4-byte copy from global to shared memory that
// does not pass through registers; `valid` false writes zeros instead.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
