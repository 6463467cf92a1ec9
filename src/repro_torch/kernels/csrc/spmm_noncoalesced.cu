// SpMM with the non-coalesced thread mapping, the baseline of the paper's
// coalescing ablation (FlashSparse Fig. 15): C (M, N) = A (M, K) @ B (K, N),
// fp32.
//
// Replaces: src/repro/kernels/spmm_pallas.py, _fused_spmm_kernel with
// double_buffer=False (launched through spmm_pallas_noncoalesced), the
// TPU's serialised per-row fetch.
//
// Bound on the card: bytes, as spmm.cu: vals (NNZP x V) + cols (NNZP) +
// win_ptr + B (K x N) + C (M x N) read or written once; 2 * NNZP * V * N
// flops.
//
// Mapping.  The paper's memory-efficient mapping (spmm.cu) puts the 32
// lanes of a warp on 32 neighbouring columns of one window, so the B
// elements a warp reads for one vector are one contiguous row segment: one
// or a few 32-byte sectors per vector.  This kernel uses the mapping that
// one replaces: the 32 lanes of a warp are on 32 neighbouring windows at
// one column, so for one step the lanes read B[cols[t], col] from 32
// different rows of B, 32 separate sectors of which each lane uses 4
// bytes, and write C the same way.  Nothing is staged in shared memory:
// each lane reads its window's column ids and values itself.  Its time
// beside spmm.cu's at the same shapes is the ablation's number.
//
// Design: thread blocks of 32 x 4 threads, threadIdx.x on 32 windows
// (gridDim.x covers the windows), threadIdx.y on 4 columns (gridDim.y
// covers N).  Each thread walks its window's vectors
// [win_ptr[w] * k_blk, win_ptr[w+1] * k_blk) in order with its V sums in
// registers, acc[v] = fma(vals[t, v], B[cols[t], col], acc[v]), the
// per-output order of spmm.cu, so its output is bitwise-equal to
// spmm.cu's, as the reference promises for its ablation variant.  Lanes
// whose windows hold fewer vectors idle while the warp finishes the
// longest one.  Padding vectors are multiplied, empty windows store
// zeros, and rows >= M are not written, as in spmm.cu.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;  // windows per warp
constexpr int kCols = 4;    // columns per thread block, one per warp

template <int V>
__global__ void __launch_bounds__(kLanes * kCols)
spmm_noncoalesced_kernel(const int* __restrict__ win_ptr,
                         const int* __restrict__ cols,
                         const float* __restrict__ vals,
                         const float* __restrict__ b, float* __restrict__ c,
                         int m, int n, int k_blk, int num_windows) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  const int col = blockIdx.y * kCols + threadIdx.y;
  if (w >= num_windows || col >= n) return;
  const int64_t t_lo = static_cast<int64_t>(win_ptr[w]) * k_blk;
  const int64_t t_hi = static_cast<int64_t>(win_ptr[w + 1]) * k_blk;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  for (int64_t t = t_lo; t < t_hi; ++t) {
    const float bv = __ldg(b + static_cast<int64_t>(__ldg(cols + t)) * n + col);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(__ldg(vals + t * V + v), bv, acc[v]);
  }

#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t row = w * V + v;
    if (row < m) c[row * n + col] = acc[v];
  }
}

template <int V>
cudaError_t launch(const int* win_ptr, const int* cols, const float* vals,
                   const float* b, float* c, int m, int n, int num_windows,
                   int k_blk, cudaStream_t stream) {
  const dim3 grid((num_windows + kLanes - 1) / kLanes, (n + kCols - 1) / kCols);
  const dim3 block(kLanes, kCols);
  spmm_noncoalesced_kernel<V><<<grid, block, 0, stream>>>(
      win_ptr, cols, vals, b, c, m, n, k_blk, num_windows);
  return cudaGetLastError();
}

}  // namespace

// win_ptr (W + 1,) int32, cols (NNZP,) int32, vals (NNZP, V) f32,
// b (K, N) f32 row-major, c (M, N) f32 row-major; N / 4 at most 65,535.
extern "C" int spmm_noncoalesced_f32(const void* win_ptr, const void* cols,
                                     const void* vals, const void* b, void* c,
                                     int m, int n, int num_windows, int v,
                                     int k_blk, void* stream) {
  const auto* wp = static_cast<const int*>(win_ptr);
  const auto* cl = static_cast<const int*>(cols);
  const auto* vl = static_cast<const float*>(vals);
  const auto* bb = static_cast<const float*>(b);
  auto* cc = static_cast<float*>(c);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8:
      return launch<8>(wp, cl, vl, bb, cc, m, n, num_windows, k_blk, st);
    case 16:
      return launch<16>(wp, cl, vl, bb, cc, m, n, num_windows, k_blk, st);
    default:
      return cudaErrorInvalidValue;
  }
}

REPRO_ERROR_STRING(spmm_noncoalesced_error_string)
