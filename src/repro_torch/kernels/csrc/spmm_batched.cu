// Batched SpMM over the blocked ME-BCRS view, one launch for H heads:
// C[h] (M, N) = A[h] (M, K) @ B[h] (K, N), fp32, where vals and B are each
// either per head or shared by every head.
//
// Replaces: src/repro/kernels/spmm_pallas.py, _batched_spmm_kernel
// (launched through spmm_pallas_batched), the (H, N / N_BLK, W) grid of the
// staged attention's SpMM and of the multi-head backward (dV, dQ, dK).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is vals (NNZP x V per distinct head) + cols (NNZP) + win_ptr +
// B (K x N per distinct head) + C (H x M x N); the work, 2 * H * NNZP * V *
// N flops, is far below the fp32 rate for that traffic.
//
// Design: the window-parallel kernel of spmm.cu (spmm_window.cuh) with the
// heads on gridDim.z.  Windows stay on gridDim.x, which has no 65,535
// limit.  A shared operand is read with a head stride of 0 from its one
// copy, the reference's "(1, ...) slice" rule.  Per (head, window, column)
// the accumulation order is spmm.cu's, so this launch is bitwise-equal to
// H launches of spmm.cu, as the reference promises for its batched grid.
// The pattern (win_ptr, cols) and the window plan are shared by the
// heads.  A window of Aᵀ with thousands of blocks (the global keys of a
// strided attention pattern) is cut into slices over a thread-block
// cluster, as in spmm.cu.
#include "spmm_window.cuh"

// win_ptr (W + 1,) int32, cols (NNZP,) int32, vals (NNZP, V) f32 with
// heads vals_hstride elements apart (0: shared), b (K, N) f32 row-major
// with heads b_hstride apart (0: shared), c (H, M, N) f32, split_ids and
// the block shape as in spmm.cu; H at most 65,535; wide != 0 indexes one
// head's B and vals in 64 bits.  The bf16 and int8 variants of spmm.cu
// are not instantiated here: the multi-head attention path runs fp32.
extern "C" int spmm_batched_launch(const void* win_ptr, const void* cols,
                                   const void* vals, const void* b, void* c,
                                   const void* split_ids, int m, int n,
                                   int num_windows, int heads, int v,
                                   int k_blk, int n_tile, int groups,
                                   int cluster, int split_blk, int num_long,
                                   int num_medium, int64_t vals_hstride,
                                   int64_t b_hstride, int wide, void* stream) {
  auto run = [&](auto idx) {
    return repro::launch_spmm_window<float, float, decltype(idx)>(
        win_ptr, cols, vals, nullptr, b, c, split_ids, m, n, num_windows,
        heads, v, k_blk, n_tile, groups, cluster, split_blk, num_long,
        num_medium, vals_hstride, b_hstride, stream);
  };
  return wide ? run(int64_t{}) : run(int{});
}

REPRO_ERROR_STRING(spmm_batched_error_string)
