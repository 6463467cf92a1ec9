// SDDMM over the blocked ME-BCRS pattern: S = mask * (Q @ K^T), with Q, K
// and S all fp32 or all bf16 (fp32 accumulators), written in the blocked
// (NNZP, V) layout that the following SpMM reads.
//
// Replaces: src/repro/kernels/sddmm_pallas.py, _fused_sddmm_kernel
// (launched through sddmm_pallas), with its bf16 variant.
//
// Bound on the card: bytes.  Each input read once and the output written
// once is Q (M x F) + K (Mc x F) + mask (NNZP x V bytes) + cols (NNZP) +
// block_win (NB) + S (NNZP x V); the work, 2 * NNZP * V * F flops, is far
// under the tensor cores' rate for that traffic.  bf16 halves the bytes
// of Q, K and S.
//
// Design: the tensor-core tile of sddmm_rows.cuh launched for one head: a
// warp computes 16 sampled rows x V on mma.sync m16n8k8 with the window's
// V rows on the n side (swap-and-transpose), reading the tile's K rows and
// its window's Q rows once, with 16-byte loads that use every sector
// whole, streaming F in k-steps of 8; 3xTF32 for fp32, exact TF32 for
// bf16.
#include "sddmm_rows.cuh"

// block_win (NB,) int32, cols (NB * k_blk,) int32, q (M, F) and k (Mc, F)
// of qk_type (0 f32, 1 bf16), mask (NB * k_blk, V) bool, out
// (NB * k_blk, V) of qk_type with 8-byte alignment (a fresh allocation).
extern "C" int sddmm_launch(const void* block_win, const void* cols,
                            const void* q, const void* k, const void* mask,
                            void* out, int m, int f, int num_blocks, int v,
                            int k_blk, int qk_type, void* stream) {
  if (qk_type == 0) {
    return repro::launch_sddmm_rows<float>(block_win, cols, q, k, mask, out,
                                           m, f, num_blocks, 1, v, k_blk, 0,
                                           0, stream);
  }
  if (qk_type == 1) {
    return repro::launch_sddmm_rows<__nv_bfloat16>(block_win, cols, q, k,
                                                   mask, out, m, f, num_blocks,
                                                   1, v, k_blk, 0, 0, stream);
  }
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(sddmm_error_string)
