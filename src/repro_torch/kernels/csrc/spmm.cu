// SpMM over the blocked ME-BCRS view: C (M, N) = A (M, K) @ B (K, N), fp32.
//
// Replaces: src/repro/kernels/spmm_pallas.py, _fused_spmm_kernel (launched
// through spmm_pallas), the gather-free window GEMM of FlashSparse §3.3.
//
// Bound on the card: bytes.  Each input read once and the output written
// once is vals (NNZP x V) + cols (NNZP) + win_ptr + B (K x N) + C (M x N);
// the work is 2 * NNZP * V * N flops, far below the fp32 rate for that
// traffic (about 8 flops per byte at V = 8), so device memory bounds it.
//
// Design: one thread block per (window, column tile), windows on
// gridDim.x (gridDim.y stops at 65,535 and a graph can have more windows).
// Each thread owns one output column of the tile and keeps the window's V
// accumulators in registers for the whole window, so C is written once
// and never read.  The window's vectors are contiguous (its K-blocks
// [win_ptr[w], win_ptr[w+1]) are adjacent), so the block walks them in
// chunks: it stages the chunk's column ids and (chunk, V) values in shared
// memory, then every thread reads B[cols[r], col] with neighbouring
// threads on neighbouring columns - one coalesced row segment per vector,
// the paper's memory-efficient thread mapping.  B rows shared by several
// windows (hub columns) are served from L2.
//   * Padding vectors carry column 0 and value 0 and are multiplied, not
//     skipped, as in the reference.
//   * An empty window stores zeros; the all-empty dummy block belongs to
//     no window and is never visited.
//   * The ragged last column tile is masked; rows >= M of the last window
//     are not written.
#include "common.cuh"

namespace {

constexpr int kChunk = 32;  // vectors staged in shared memory per step

template <int V>
__global__ void spmm_kernel(const int* __restrict__ win_ptr,
                            const int* __restrict__ cols,
                            const float* __restrict__ vals,
                            const float* __restrict__ b,
                            float* __restrict__ c, int m, int n, int k_blk) {
  __shared__ int s_cols[kChunk];
  __shared__ __align__(16) float s_vals[kChunk * V];

  const int w = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = col < n;
  const int64_t t_lo = static_cast<int64_t>(win_ptr[w]) * k_blk;
  const int64_t t_hi = static_cast<int64_t>(win_ptr[w + 1]) * k_blk;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  for (int64_t t0 = t_lo; t0 < t_hi; t0 += kChunk) {
    const int64_t rest = t_hi - t0;
    const int cnt = rest < kChunk ? static_cast<int>(rest) : kChunk;
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) s_cols[i] = cols[t0 + i];
    for (int i = threadIdx.x; i < cnt * V; i += blockDim.x) {
      s_vals[i] = vals[t0 * V + i];
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int r = 0; r < cnt; ++r) {
        const float bv = __ldg(b + static_cast<int64_t>(s_cols[r]) * n + col);
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
      if (row < m) c[row * n + col] = acc[v];
    }
  }
}

template <int V>
cudaError_t launch(const int* win_ptr, const int* cols, const float* vals,
                   const float* b, float* c, int m, int n, int num_windows,
                   int k_blk, int n_tile, cudaStream_t stream) {
  const dim3 grid(num_windows, (n + n_tile - 1) / n_tile);
  spmm_kernel<V><<<grid, n_tile, 0, stream>>>(win_ptr, cols, vals, b, c, m,
                                               n, k_blk);
  return cudaGetLastError();
}

}  // namespace

// win_ptr (W + 1,) int32, cols (NNZP,) int32, vals (NNZP, V) f32,
// b (K, N) f32 row-major, c (M, N) f32 row-major.  n_tile threads per
// block, a multiple of 32 up to 1024.
extern "C" int spmm_f32(const void* win_ptr, const void* cols, const void* vals,
                        const void* b, void* c, int m, int n, int num_windows,
                        int v, int k_blk, int n_tile, void* stream) {
  const auto* wp = static_cast<const int*>(win_ptr);
  const auto* cl = static_cast<const int*>(cols);
  const auto* vl = static_cast<const float*>(vals);
  const auto* bb = static_cast<const float*>(b);
  auto* cc = static_cast<float*>(c);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8:
      return launch<8>(wp, cl, vl, bb, cc, m, n, num_windows, k_blk, n_tile, st);
    case 16:
      return launch<16>(wp, cl, vl, bb, cc, m, n, num_windows, k_blk, n_tile, st);
    default:
      return cudaErrorInvalidValue;
  }
}

REPRO_ERROR_STRING(spmm_error_string)
