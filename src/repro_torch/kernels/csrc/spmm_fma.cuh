// The CUDA-core product of the non-coalesced SpMM (spmm_noncoalesced.cu,
// the baseline of the paper's coalescing ablation): one thread, one output
// column, V running sums, one fmaf per value of a vector.  The window and
// balanced SpMMs take their products on the tensor cores instead
// (spmm_window.cuh).
#pragma once

#include <cuda_bf16.h>

namespace repro {

constexpr int kSpmmUnroll = 8;  // B gathers in flight per thread

// acc[c * V + v] += vals[v] * bv[c] for the V values of one vector in
// shared memory and this thread's kCols columns: each value is read once.
template <int V, int kCols>
__device__ __forceinline__ void fma_value(float (&acc)[kCols * V], int v,
                                          float a, const float (&bv)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    acc[c * V + v] = fmaf(a, bv[c], acc[c * V + v]);
  }
}

template <int V, int kCols>
__device__ __forceinline__ void fma_vector(float (&acc)[kCols * V],
                                           const float* vals,
                                           const float (&bv)[kCols]) {
  const float4* a4 = reinterpret_cast<const float4*>(vals);
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 a = a4[q];
    fma_value<V, kCols>(acc, 4 * q, a.x, bv);
    fma_value<V, kCols>(acc, 4 * q + 1, a.y, bv);
    fma_value<V, kCols>(acc, 4 * q + 2, a.z, bv);
    fma_value<V, kCols>(acc, 4 * q + 3, a.w, bv);
  }
}

template <int V, int kCols>
__device__ __forceinline__ void fma_vector(float (&acc)[kCols * V],
                                           const __nv_bfloat16* vals,
                                           const float (&bv)[kCols]) {
  // a bf16 is the top half of the fp32 with the same value
  const uint4* a8 = reinterpret_cast<const uint4*>(vals);
#pragma unroll
  for (int q = 0; q < V / 8; ++q) {
    const uint4 u = a8[q];
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fma_value<V, kCols>(acc, 8 * q + 2 * j, __uint_as_float(w[j] << 16), bv);
      fma_value<V, kCols>(acc, 8 * q + 2 * j + 1,
                          __uint_as_float(w[j] & 0xffff0000u), bv);
    }
  }
}

}  // namespace repro
