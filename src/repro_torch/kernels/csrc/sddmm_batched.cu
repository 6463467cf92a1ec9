// Batched SDDMM over the blocked ME-BCRS pattern, one launch for H heads:
// S[h] = mask * (Q[h] @ K[h]^T), (H, NNZP, V), where Q and K are each
// either per head or shared by every head, and Q, K and S are all fp32 or
// all bf16 (fp32 accumulators).
//
// Replaces: src/repro/kernels/sddmm_pallas.py, _batched_sddmm_kernel
// (launched through sddmm_pallas_batched), the (H, NB, F / F_BLK) grid of
// the staged attention's scores and of the multi-head backward (the
// recomputed scores and dProbs).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is Q (M x F per distinct head) + K (Mc x F per distinct head) +
// mask (NNZP x V bytes) + cols (NNZP) + block_win (NB) + S (H x NNZP x V);
// the work, 2 * H * NNZP * V * F flops, is far under the tensor cores'
// rate for that traffic.  bf16 halves the bytes of Q, K and S.  The
// output is most of the bytes at 12 heads.
//
// Design: the tensor-core tile of sddmm.cu (sddmm_rows.cuh) with the heads
// on gridDim.y (tiles stay on gridDim.x, which has no 65,535 limit).  A
// shared operand is read with a head stride of 0 from its one copy; the
// pattern (block_win, cols, mask) is shared by the heads.  A sampled row's
// products do not depend on the head or on the tile that holds it, so this
// launch is bitwise-equal to H launches of sddmm.cu, as the reference
// promises for its batched grid, at fp32 and at bf16.  Like sddmm.cu it
// streams the whole feature dimension in k-steps of 8 through registers:
// the reference's f_blk feature tiles, which bound a TPU cell's VMEM, have
// no counterpart.  A warp walks a run of neighbouring tiles, so a
// window's Q rows stay in its registers from tile to tile and a head's K
// rows that neighbouring windows share (the attention pattern's local
// band and global keys) come from L1.
#include "sddmm_rows.cuh"

// block_win (NB,) int32, cols (NB * k_blk,) int32, q (M, F) and k (Mc, F)
// of qk_type (0 f32, 1 bf16) with heads q_hstride and k_hstride elements
// apart (0: shared), mask (NB * k_blk, V) bool, out (H, NB * k_blk, V) of
// qk_type with 8-byte alignment (a fresh allocation).  H at most 65,535.
extern "C" int sddmm_batched_launch(const void* block_win, const void* cols,
                                    const void* q, const void* k,
                                    const void* mask, void* out, int m, int f,
                                    int num_blocks, int heads, int v,
                                    int k_blk, int64_t q_hstride,
                                    int64_t k_hstride, int qk_type,
                                    void* stream) {
  if (qk_type == 0) {
    return repro::launch_sddmm_rows<float>(block_win, cols, q, k, mask, out,
                                           m, f, num_blocks, heads, v, k_blk,
                                           q_hstride, k_hstride, stream);
  }
  if (qk_type == 1) {
    return repro::launch_sddmm_rows<__nv_bfloat16>(
        block_win, cols, q, k, mask, out, m, f, num_blocks, heads, v, k_blk,
        q_hstride, k_hstride, stream);
  }
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(sddmm_batched_error_string)
