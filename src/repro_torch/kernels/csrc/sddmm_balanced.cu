// Schedule-driven SDDMM: S[h] = mask * (Q[h] @ K[h]^T) at the blocked
// ME-BCRS pattern, written in the blocked (NNZP, V) layout, for H heads,
// each of Q and K either per head or shared by all heads; Q, K and S all
// fp32 or all bf16 (fp32 accumulators).
//
// Replaces: src/repro/kernels/sddmm_pallas.py, _balanced_sddmm_kernel
// (launched through sddmm_pallas_balanced), with its bf16 variant.
//
// Bound on the card: bytes.  Each input read once and the output written
// once is Q (M x F per distinct head) + K (Mc x F per distinct head) + mask
// (NNZP x V bytes) + cols (NNZP) + blk_id, blk_win (NSB each) + S
// (H x NNZP x V); the work, 2 * H * NNZP * V * F flops, is far under the
// tensor cores' rate for that traffic.  bf16 halves the bytes of Q, K and
// S.
//
// Design.  SDDMM is block-parallel already: every K-block is the same
// amount of work, so the schedule adds only its block list.  The kernel is
// sddmm.cu's tensor-core tile (sddmm_rows.cuh) over the schedule's rows
// instead of the view's: scheduled row u is row u % k_blk of block
// blk_id[u / k_blk], whose window is blk_win[u / k_blk]; a warp takes 16
// consecutive scheduled rows, one n8 product per distinct window among
// them, and the head is on gridDim.y.  A row's products are those of
// sddmm.cu, so the two give the same bits per sampled row, and the bf16
// variant is bitwise the fp32 kernel on widened operands, rounded once.  A
// schedule with no blocks (the all-empty matrix) is never launched: the
// wrapper returns zeros.
#include "sddmm_rows.cuh"

// blk_id, blk_win (NSB,) int32, cols (NNZP,) int32, q (H or 1, M, F) and
// k (H or 1, Mc, F) of qk_type (0 f32, 1 bf16) with head strides of 0 for
// a shared operand, mask (NNZP, V) bool, out (H, NNZP, V) of qk_type with
// 8-byte alignment (a fresh allocation).  NSB > 0.
extern "C" int sddmm_balanced_launch(const void* blk_id, const void* blk_win,
                                     const void* cols, const void* q,
                                     const void* k, const void* mask,
                                     void* out, int m, int f,
                                     int num_sched_blocks, int heads, int v,
                                     int k_blk, int64_t q_hstride,
                                     int64_t k_hstride, int64_t out_hstride,
                                     int qk_type, void* stream) {
  const repro::ScheduledRows map{static_cast<const int*>(blk_id),
                                 static_cast<const int*>(blk_win), k_blk};
  const int64_t rows = static_cast<int64_t>(num_sched_blocks) * k_blk;
  auto run = [&](auto t) {
    using T = decltype(t);
    return repro::launch_sddmm_tiles<T>(
        map, static_cast<const int*>(cols), static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const uint8_t*>(mask),
        static_cast<T*>(out), m, f, rows, heads, v, q_hstride, k_hstride,
        out_hstride, static_cast<cudaStream_t>(stream));
  };
  if (qk_type == 0) return run(float{});
  if (qk_type == 1) return run(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(sddmm_balanced_error_string)
