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
