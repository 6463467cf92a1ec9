// Staged-gather SpMM, the pre-fusion baseline: C (M, N) = A (M, K) @ B
// (K, N) in three passes over device memory, with fp32 values and B or
// bf16 values and B (G then bf16, half the bytes of the staged buffer):
//   1. spmm_gather_kernel (spmm_gather.cu) writes the staged copy
//      G = B[cols] (NNZP x N);
//   2. the window-parallel SpMM of spmm_window.cuh reads G back, row t for
//      vector t where spmm.cu reads row cols[t] of B, into an fp32 C;
//   3. the wrapper's post-pass zeroes the rows of windows without a
//      K-block and casts C to B's type once (plain PyTorch, as the
//      reference's are XLA).
//
// Replaces: src/repro/kernels/spmm_pallas.py, _staged_spmm_kernel
// (launched through spmm_pallas_staged, with its fp32 and bf16 levels; the
// reference has no int8 path there), and the jnp.take gather before it
// (XLA there, a kernel here); the reference's _zero_unvisited post-pass
// and its one cast to B's dtype stay plain PyTorch in the wrapper.
//
// Bound on the card: bytes.  The function's inputs read once and its
// output written once are vals (NNZP x V) + cols (NNZP) + block_win (NB) +
// B (K x N) + C (M x N), as for spmm.cu, each at its stored width.  The
// design's own floor adds what its passes must move: G written by the
// gather and read by the SpMM, the fp32 C written and read back by the
// post-pass, and for bf16 the cast's pass; that traffic is what this
// baseline exists to show against the fused kernel.
//
// Design.  spmm.cu's kernel with a gathered B (kGathered) and an fp32 C,
// on the same window plan (kernels/_window.py): slices of the windows of
// more than split_blk K-blocks over a block or a cluster, the values
// staged by cp.async, the products on the tensor cores, a lane reading
// four neighbouring columns of a G row where it reads them of a B row.
// So this baseline and spmm.cu differ in the staged copy and its passes
// alone: every sum is taken in the same order, and on every window C is
// spmm.cu's, bit for bit, before the cast (fp32), and after it (bf16: one
// rounding of the same fp32 sum).  The kernel stores every window, empty
// ones as zeros; the post-pass still runs, as in the reference's pipeline.
#include "spmm_window.cuh"

// win_ptr (W + 1,) int32, vals (NNZP, V) and gath (NNZP, N) row-major
// (gath[t] = B[cols[t]]) both of dtype (0 f32, 1 bf16), c (M, N) f32
// row-major, split_ids the plan's long then medium windows
// (kernels/_window.py); groups groups of n_tile threads per block,
// cluster blocks per cluster, as spmm_launch; wide != 0 indexes G and vals
// in 64 bits.
extern "C" int spmm_staged_launch(const void* win_ptr, const void* vals,
                                  const void* gath, void* c,
                                  const void* split_ids, int m, int n,
                                  int num_windows, int v, int k_blk,
                                  int n_tile, int groups, int cluster,
                                  int split_blk, int num_long, int num_medium,
                                  int dtype, int wide, void* stream) {
  auto run = [&](auto t, auto idx) {
    using T = decltype(t);
    return repro::launch_spmm_window<T, T, decltype(idx), float, true>(
        win_ptr, nullptr, vals, nullptr, gath, c, split_ids, m, n,
        num_windows, 1, v, k_blk, n_tile, groups, cluster, split_blk,
        num_long, num_medium, 0, 0, stream);
  };
  auto by_index = [&](auto t) {
    return wide ? run(t, int64_t{}) : run(t, int{});
  };
  if (dtype == 0) return by_index(float{});
  if (dtype == 1) return by_index(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(spmm_staged_error_string)
