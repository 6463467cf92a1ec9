// Helpers shared by the hand-written FlashSparse kernels (sm_90a).
//
// Every kernel library exposes a plain C interface: the entry point takes
// device pointers, sizes and the CUDA stream as plain values, launches on
// that stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// Maximum and sum of one value over the 32 lanes of a warp (butterfly);
// every lane gets the result.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

}  // namespace repro

// Defines `extern "C" const char* NAME(int)`: the text of a CUDA error code
// returned by one of the entry points.
#define REPRO_ERROR_STRING(NAME)                                   \
  extern "C" const char* NAME(int err) {                           \
    return cudaGetErrorString(static_cast<cudaError_t>(err));      \
  }
