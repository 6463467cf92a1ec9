// Staged-gather SpMM, the pre-fusion baseline: C (M, N) = A (M, K) @ B
// (K, N), over a gathered copy G = B[cols] (NNZP x N) that the wrapper
// makes in device memory before the launch, with fp32 values and B or
// bf16 values and B (G then bf16, half the bytes of the staged buffer);
// fp32 sums and an fp32 C, which the wrapper rounds to B's type once.
//
// Replaces: src/repro/kernels/spmm_pallas.py, _staged_spmm_kernel
// (launched through spmm_pallas_staged, with its fp32 and bf16 levels; the
// reference has no int8 path there), whose gather is a jnp.take outside
// the kernel and whose unvisited windows are zeroed by the
// _zero_unvisited post-pass before the one cast to B's dtype; all three
// stay plain PyTorch in the wrapper here.
//
// Bound on the card: bytes.  The function's inputs read once and its
// output written once are vals (NNZP x V) + cols (NNZP) + block_win (NB) +
// B (K x N) + C (M x N), as for spmm.cu, each at its stored width; the
// gathered copy, written and read again, is the traffic this baseline
// pays and the fused kernel does not (three passes over the gathered rows
// instead of one).
//
// Design: the reference's block-indexed grid.  One thread block per
// (K-block, column tile): the K-blocks of a window are adjacent in
// block_win, so the block of a window's first K-block walks the run of
// K-blocks that share its window, and the others leave at once.  Each
// thread owns one output column and keeps the window's V sums in
// registers; per vector t it reads G[t, col] (neighbouring threads on
// neighbouring columns: one coalesced row segment) and the vector's V
// values (one address for the whole block), each widened to fp32 as it is
// read, acc[v] = fma(vals[t, v], G[t, col], acc[v]) in the order of t.
// One block owns each window's sums, so the result is deterministic with
// no atomics.  A window with no
// K-block is never visited and its rows are left as they are, for the
// wrapper's post-pass to zero, as in the reference; the dummy block of an
// all-empty matrix is visited and, its values being zero, writes zeros.
#include "spmm_window.cuh"

namespace {

template <int V, typename T>
__global__ void spmm_staged_kernel(const int* __restrict__ block_win,
                                   const T* __restrict__ vals,
                                   const T* __restrict__ gath,
                                   float* __restrict__ c, int m, int n,
                                   int k_blk, int num_blocks) {
  const int blk = blockIdx.x;
  const int w = block_win[blk];
  if (blk > 0 && block_win[blk - 1] == w) return;  // not the run's first
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= n) return;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  for (int bb = blk; bb < num_blocks && block_win[bb] == w; ++bb) {
    for (int r = 0; r < k_blk; ++r) {
      const int64_t t = static_cast<int64_t>(bb) * k_blk + r;
      const float g = repro::load_b(gath + t * n + col);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[v] = fmaf(repro::load_b(vals + t * V + v), g, acc[v]);
      }
    }
  }

#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t row = static_cast<int64_t>(w) * V + v;
    if (row < m) c[row * n + col] = acc[v];
  }
}

template <typename T>
cudaError_t launch(const void* block_win, const void* vals, const void* gath,
                   void* c, int m, int n, int num_blocks, int v, int k_blk,
                   int n_tile, cudaStream_t stream) {
  const dim3 grid(num_blocks, (n + n_tile - 1) / n_tile);
  const auto* bw = static_cast<const int*>(block_win);
  const auto* vl = static_cast<const T*>(vals);
  const auto* gg = static_cast<const T*>(gath);
  auto* cc = static_cast<float*>(c);
  switch (v) {
    case 8:
      spmm_staged_kernel<8, T><<<grid, n_tile, 0, stream>>>(
          bw, vl, gg, cc, m, n, k_blk, num_blocks);
      break;
    case 16:
      spmm_staged_kernel<16, T><<<grid, n_tile, 0, stream>>>(
          bw, vl, gg, cc, m, n, k_blk, num_blocks);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// block_win (NB,) int32 in ascending order, vals (NB * k_blk, V) and
// gath (NB * k_blk, N) row-major (gath[t] = B[cols[t]]) both of dtype (0
// f32, 1 bf16), c (M, N) f32 row-major; rows of windows without a K-block
// are not written.  n_tile threads per block, a multiple of 32 up to 1024.
extern "C" int spmm_staged_launch(const void* block_win, const void* vals,
                                  const void* gath, void* c, int m, int n,
                                  int num_blocks, int v, int k_blk, int n_tile,
                                  int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(block_win, vals, gath, c, m, n, num_blocks, v, k_blk,
                         n_tile, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(block_win, vals, gath, c, m, n, num_blocks,
                                 v, k_blk, n_tile, st);
  }
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(spmm_staged_error_string)
