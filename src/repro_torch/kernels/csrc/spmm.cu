// SpMM over the blocked ME-BCRS view: C (M, N) = A (M, K) @ B (K, N), with
// fp32 values and B, bf16 values and B, or int8 values (one fp32 scale per
// K-block) and fp32 or bf16 B; C in B's type, fp32 sums.
//
// Replaces: src/repro/kernels/spmm_pallas.py, _fused_spmm_kernel (launched
// through spmm_pallas), the gather-free window GEMM of FlashSparse §3.3,
// with its precision variants (bf16, and int8 through `quantized`).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is vals (NNZP x V) + cols (NNZP) + win_ptr + B (K x N) + C (M x N);
// the work is 2 * NNZP * V * N flops, far below the fp32 rate for that
// traffic (about 8 flops per byte at V = 8), so device memory bounds it.
// bf16 halves the bytes of vals, B and C, int8 quarters those of vals.
//
// Design: the window-parallel kernel of spmm_window.cuh launched for one
// head: FlashSparse's swap and transpose on mma.sync m16n8k8 (TF32; 3xTF32
// for fp32 operands), a warp on 32 output columns of a window with its V
// rows on the mma's n side, the vectors' column ids and values streamed
// through shared memory by cp.async and each B row gathered in whole
// sectors (the paper's memory-efficient thread mapping); a window of more
// than split_blk K-blocks is cut into slices over the groups of a block or
// of a thread-block cluster, whose sums meet in (distributed) shared
// memory in a fixed order.
#include "spmm_window.cuh"

// win_ptr (W + 1,) int32, cols (NNZP,) int32, vals (NNZP, V) of vals_type
// (0 f32, 1 bf16, 2 int8), scales (NB,) f32 (int8 values only), b (K, N)
// of b_type (0 f32, 1 bf16) row-major, c (M, N) of b_type row-major,
// split_ids the plan's long then medium windows (kernels/_window.py).
// groups groups of n_tile threads per block (n_tile a multiple of 32, at
// most 512 threads), cluster blocks per cluster; wide != 0 indexes B and
// vals in 64 bits.
extern "C" int spmm_launch(const void* win_ptr, const void* cols,
                           const void* vals, const void* scales, const void* b,
                           void* c, const void* split_ids, int m, int n,
                           int num_windows, int v, int k_blk, int n_tile,
                           int groups, int cluster, int split_blk, int num_long,
                           int num_medium, int vals_type, int b_type, int wide,
                           void* stream) {
  auto run = [&](auto tv, auto tb, auto idx) {
    using Tv = decltype(tv);
    using Tb = decltype(tb);
    using Idx = decltype(idx);
    return repro::launch_spmm_window<Tv, Tb, Idx>(
        win_ptr, cols, vals, scales, b, c, split_ids, m, n, num_windows, 1, v,
        k_blk, n_tile, groups, cluster, split_blk, num_long, num_medium, 0, 0,
        stream);
  };
  auto by_index = [&](auto tv, auto tb) {
    return wide ? run(tv, tb, int64_t{}) : run(tv, tb, int{});
  };
  if (vals_type == 0 && b_type == 0) return by_index(float{}, float{});
  if (vals_type == 1 && b_type == 1) {
    return by_index(__nv_bfloat16{}, __nv_bfloat16{});
  }
  if (vals_type == 2 && b_type == 0) return by_index(int8_t{}, float{});
  if (vals_type == 2 && b_type == 1) return by_index(int8_t{}, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(spmm_error_string)
