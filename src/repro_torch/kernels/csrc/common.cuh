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

// Asynchronous copies from global to shared memory (cp.async): 4 bytes
// (through L1), 16 bytes bypassing L1 or through it, a commit of the
// copies issued so far as one group, and waits for all groups or for all
// but the newest N.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace repro

// Defines `extern "C" const char* NAME(int)`: the text of a CUDA error code
// returned by one of the entry points.
#define REPRO_ERROR_STRING(NAME)                                   \
  extern "C" const char* NAME(int err) {                           \
    return cudaGetErrorString(static_cast<cudaError_t>(err));      \
  }
