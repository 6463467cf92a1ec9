// Batched SpMM over the blocked ME-BCRS view, one launch for H heads:
// C[h] (M, N) = A[h] (M, K) @ B[h] (K, N), where vals and B are each
// either per head or shared by every head, at spmm.cu's precisions: fp32
// values and B, bf16 values and B, or int8 values (shared by every head,
// one fp32 scale per K-block) with fp32 or bf16 B; C in B's type, fp32
// sums.
//
// Replaces: src/repro/kernels/spmm_pallas.py, _batched_spmm_kernel
// (launched through spmm_pallas_batched), the (H, N / N_BLK, W) grid of the
// staged attention's SpMM and of the multi-head backward (dV, dQ, dK),
// with its precision variants (bf16, and int8 through `quantized`, which
// the reference takes for shared 2-D values only, spmm_pallas.py:407).
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
// the order of the products and sums is spmm.cu's, so this launch is
// bitwise-equal to
// H launches of spmm.cu, as the reference promises for its batched grid.
// The pattern (win_ptr, cols) and the window plan are shared by the
// heads.  A window of Aᵀ with thousands of blocks (the global keys of a
// strided attention pattern) is cut into slices over a thread-block
// cluster, as in spmm.cu.  The precision variants are spmm.cu's
// instantiations of the same kernel (spmm_window.cuh): each operand
// widened to fp32 as it is read, C rounded to B's type once.
#include "spmm_window.cuh"

// win_ptr (W + 1,) int32, cols (NNZP,) int32, vals (NNZP, V) of vals_type
// (0 f32, 1 bf16, 2 int8) with heads vals_hstride elements apart (0:
// shared; int8 values are shared), scales (NB,) f32 (int8 values only),
// b (K, N) of b_type (0 f32, 1 bf16) row-major with heads b_hstride apart
// (0: shared), c (H, M, N) of b_type, split_ids and the block shape as in
// spmm.cu; H at most 65,535; wide != 0 indexes one head's B and vals in
// 64 bits.
extern "C" int spmm_batched_launch(const void* win_ptr, const void* cols,
                                   const void* vals, const void* scales,
                                   const void* b, void* c,
                                   const void* split_ids, int m, int n,
                                   int num_windows, int heads, int v,
                                   int k_blk, int n_tile, int groups,
                                   int cluster, int split_blk, int num_long,
                                   int num_medium, int64_t vals_hstride,
                                   int64_t b_hstride, int vals_type,
                                   int b_type, int wide, void* stream) {
  auto run = [&](auto tv, auto tb, auto idx) {
    using Tv = decltype(tv);
    using Tb = decltype(tb);
    using Idx = decltype(idx);
    return repro::launch_spmm_window<Tv, Tb, Idx>(
        win_ptr, cols, vals, scales, b, c, split_ids, m, n, num_windows,
        heads, v, k_blk, n_tile, groups, cluster, split_blk, num_long,
        num_medium, vals_hstride, b_hstride, stream);
  };
  auto by_index = [&](auto tv, auto tb) {
    return wide ? run(tv, tb, int64_t{}) : run(tv, tb, int{});
  };
  if (vals_type == 0 && b_type == 0) return by_index(float{}, float{});
  if (vals_type == 1 && b_type == 1) {
    return by_index(__nv_bfloat16{}, __nv_bfloat16{});
  }
  if (vals_type == 2 && vals_hstride != 0) return cudaErrorInvalidValue;
  if (vals_type == 2 && b_type == 0) return by_index(int8_t{}, float{});
  if (vals_type == 2 && b_type == 1) return by_index(int8_t{}, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(spmm_batched_error_string)
