// The window-parallel SpMM kernel, shared by spmm.cu (one head) and
// spmm_batched.cu (a grid of H heads):
// C[h] (M, N) = A[h] (M, K) @ B[h] (K, N), fp32.
//
// Design: one thread block per (window, column tile, head), windows on
// gridDim.x (gridDim.y and gridDim.z stop at 65,535 and a graph can have
// more windows), column tiles on gridDim.y, heads on gridDim.z.  Each
// thread owns one output column of the tile and keeps the window's V
// accumulators in registers for the whole window, so C is written once
// and never read.  The window's vectors are contiguous (its K-blocks
// [win_ptr[w], win_ptr[w+1]) are adjacent), so the block walks them in
// chunks: it stages the chunk's column ids and (chunk, V) values in shared
// memory, then every thread reads B[cols[r], col] with neighbouring
// threads on neighbouring columns - one coalesced row segment per vector,
// the paper's memory-efficient thread mapping.  B rows shared by several
// windows (hub columns) are served from L2.
//   * A head reads vals and B at its own offset, h * vals_hstride and
//     h * b_hstride; a stride of 0 makes an operand shared by every head,
//     read from one copy (no H-fold copy is ever made).  The per-thread
//     arithmetic does not depend on the head, so H heads in one launch
//     give bitwise the output of H one-head launches.
//   * Padding vectors carry column 0 and value 0 and are multiplied, not
//     skipped, as in the reference.
//   * An empty window stores zeros; the all-empty dummy block belongs to
//     no window and is never visited.
//   * The ragged last column tile is masked; rows >= M of the last window
//     are not written.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kSpmmChunk = 32;  // vectors staged in shared memory per step

template <int V>
__global__ void spmm_window_kernel(const int* __restrict__ win_ptr,
                                   const int* __restrict__ cols,
                                   const float* __restrict__ vals,
                                   const float* __restrict__ b,
                                   float* __restrict__ c, int m, int n,
                                   int k_blk, int64_t vals_hstride,
                                   int64_t b_hstride) {
  __shared__ int s_cols[kSpmmChunk];
  __shared__ __align__(16) float s_vals[kSpmmChunk * V];

  const int w = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t h = blockIdx.z;
  const bool active = col < n;
  const float* vh = vals + h * vals_hstride;
  const float* bh = b + h * b_hstride;
  float* ch = c + h * static_cast<int64_t>(m) * n;
  const int64_t t_lo = static_cast<int64_t>(win_ptr[w]) * k_blk;
  const int64_t t_hi = static_cast<int64_t>(win_ptr[w + 1]) * k_blk;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  for (int64_t t0 = t_lo; t0 < t_hi; t0 += kSpmmChunk) {
    const int64_t rest = t_hi - t0;
    const int cnt = rest < kSpmmChunk ? static_cast<int>(rest) : kSpmmChunk;
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) s_cols[i] = cols[t0 + i];
    for (int i = threadIdx.x; i < cnt * V; i += blockDim.x) {
      s_vals[i] = vh[t0 * V + i];
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int r = 0; r < cnt; ++r) {
        const float bv = __ldg(bh + static_cast<int64_t>(s_cols[r]) * n + col);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(s_vals[r * V + v], bv, acc[v]);
      }
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int64_t row = static_cast<int64_t>(w) * V + v;
      if (row < m) ch[row * n + col] = acc[v];
    }
  }
}

// Launches the kernel over `heads` heads on `stream`.  win_ptr (W + 1,)
// int32, cols (NNZP,) int32, vals (NNZP, V) f32 per head or shared, b
// (K, N) f32 row-major per head or shared, c (heads, M, N) f32 row-major.
// n_tile threads per block, a multiple of 32 up to 1024.
inline cudaError_t launch_spmm_window(const void* win_ptr, const void* cols,
                                      const void* vals, const void* b, void* c,
                                      int m, int n, int num_windows, int heads,
                                      int v, int k_blk, int n_tile,
                                      int64_t vals_hstride, int64_t b_hstride,
                                      void* stream) {
  const auto* wp = static_cast<const int*>(win_ptr);
  const auto* cl = static_cast<const int*>(cols);
  const auto* vl = static_cast<const float*>(vals);
  const auto* bb = static_cast<const float*>(b);
  auto* cc = static_cast<float*>(c);
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(num_windows, (n + n_tile - 1) / n_tile, heads);
  switch (v) {
    case 8:
      spmm_window_kernel<8><<<grid, n_tile, 0, st>>>(
          wp, cl, vl, bb, cc, m, n, k_blk, vals_hstride, b_hstride);
      break;
    case 16:
      spmm_window_kernel<16><<<grid, n_tile, 0, st>>>(
          wp, cl, vl, bb, cc, m, n, k_blk, vals_hstride, b_hstride);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace repro
