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
// Design: the window-parallel kernel of spmm_window.cuh launched for one
// head: slice groups of threads, each thread one output column with V
// running sums in registers, the vectors' column ids and values streamed
// through shared memory by cp.async and B read one coalesced row segment
// per vector (the paper's memory-efficient thread mapping); a window of
// more than split_blk K-blocks is cut into slices over the groups of a
// block or of a thread-block cluster, whose sums meet in (distributed)
// shared memory in a fixed order.
#include "spmm_window.cuh"

// win_ptr (W + 1,) int32, cols (NNZP,) int32, vals (NNZP, V) f32,
// b (K, N) f32 row-major, c (M, N) f32 row-major, split_ids the plan's
// long then medium windows (kernels/_window.py).  groups groups of n_tile
// threads per block (n_tile a multiple of 32, at most 512 threads),
// cluster blocks per cluster.
extern "C" int spmm_f32(const void* win_ptr, const void* cols, const void* vals,
                        const void* b, void* c, const void* split_ids, int m,
                        int n, int num_windows, int v, int k_blk, int n_tile,
                        int groups, int cluster, int split_blk, int num_long,
                        int num_medium, void* stream) {
  return repro::launch_spmm_window(win_ptr, cols, vals, b, c, split_ids, m, n,
                                   num_windows, 1, v, k_blk, n_tile, groups,
                                   cluster, split_blk, num_long, num_medium, 0,
                                   0, stream);
}

REPRO_ERROR_STRING(spmm_error_string)
