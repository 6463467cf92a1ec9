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
// head: one thread block per (window, column tile), each thread one output
// column with the window's V accumulators in registers, the window's
// vectors staged in shared memory chunk by chunk and B read one coalesced
// row segment per vector (the paper's memory-efficient thread mapping).
#include "spmm_window.cuh"

// win_ptr (W + 1,) int32, cols (NNZP,) int32, vals (NNZP, V) f32,
// b (K, N) f32 row-major, c (M, N) f32 row-major.  n_tile threads per
// block, a multiple of 32 up to 1024.
extern "C" int spmm_f32(const void* win_ptr, const void* cols, const void* vals,
                        const void* b, void* c, int m, int n, int num_windows,
                        int v, int k_blk, int n_tile, void* stream) {
  return repro::launch_spmm_window(win_ptr, cols, vals, b, c, m, n,
                                   num_windows, 1, v, k_blk, n_tile, 0, 0,
                                   stream);
}

REPRO_ERROR_STRING(spmm_error_string)
