// SpMM with the non-coalesced thread mapping, the baseline of the paper's
// coalescing ablation (FlashSparse Fig. 15): C (M, N) = A (M, K) @ B (K, N),
// with fp32 values and B, bf16 values and B, or int8 values (one fp32 scale
// per K-block) and fp32 or bf16 B; C in B's type, fp32 sums.
//
// Replaces: src/repro/kernels/spmm_pallas.py, _fused_spmm_kernel with
// double_buffer=False (launched through spmm_pallas_noncoalesced), the
// TPU's serialised per-row fetch, with its precision variants
// (_apply_precision: bf16, and int8 through `quantized`).
//
// Bound on the card: bytes, as spmm.cu: vals (NNZP x V) + cols (NNZP) +
// win_ptr + B (K x N) + C (M x N) read or written once, each at its stored
// width (int8 values with a 4-byte scale a K-block); 2 * NNZP * V * N
// flops.
//
// Mapping.  The paper's memory-efficient mapping (spmm.cu) puts the 32
// lanes of a warp on 32 neighbouring columns of one window, so the B
// elements a warp reads for one vector are one contiguous row segment: one
// or a few 32-byte sectors per vector.  This kernel uses the mapping that
// one replaces: the 32 lanes of a warp are on 32 neighbouring windows at
// one column, so for one step the lanes read B[cols[t], col] from 32
// different rows of B, 32 separate sectors of which each lane uses 4 (or,
// for bf16 B, 2) bytes, and write C the same way.  Narrow types narrow the
// bytes of each access and keep the mapping: a lane still reads one
// element of a B row a step.  Nothing is staged in shared memory: each
// lane reads its window's column ids and values itself.  Its time beside
// spmm.cu's at the same shapes is the ablation's number.
//
// Design: thread blocks of 32 x 4 threads, threadIdx.x on 32 windows
// (gridDim.x covers the windows), threadIdx.y on 4 columns (gridDim.y
// covers N).  Each thread walks its window's vectors
// [win_ptr[w] * k_blk, win_ptr[w+1] * k_blk) in order with its V sums in
// registers, acc[v] = fma(a[t, v], B[cols[t], col], acc[v]), every operand
// widened to fp32 as it is read (an int8 value to q * scale[t / k_blk],
// rounded to fp32, as spmm_window.cuh dequantizes it), and rounds each sum
// to B's type once, at the store.  That is spmm.cu's per-output order and
// arithmetic on windows it does not split, so there the outputs are the
// same bits, as the reference promises for its ablation variant.  Lanes
// whose windows hold fewer vectors idle while the warp finishes the
// longest one.  Padding vectors are multiplied, empty windows store zeros,
// and rows >= M are not written, as in spmm.cu.
#include "spmm_window.cuh"

namespace {

constexpr int kLanes = 32;  // windows per warp
constexpr int kCols = 4;    // columns per thread block, one per warp

// Value t * V + v of the view widened to fp32 (int8: q * its K-block's
// scale, one fp32 rounding).
__device__ __forceinline__ float load_val(const float* vals, const float*,
                                          int64_t i, int64_t, int) {
  return __ldg(vals + i);
}
__device__ __forceinline__ float load_val(const __nv_bfloat16* vals,
                                          const float*, int64_t i, int64_t,
                                          int) {
  return repro::load_b(vals + i);
}
__device__ __forceinline__ float load_val(const int8_t* vals,
                                          const float* scales, int64_t i,
                                          int64_t t, int k_blk) {
  return __fmul_rn(static_cast<float>(__ldg(vals + i)),
                   __ldg(scales + t / k_blk));
}

template <int V, typename Tv, typename Tb>
__global__ void __launch_bounds__(kLanes * kCols)
spmm_noncoalesced_kernel(const int* __restrict__ win_ptr,
                         const int* __restrict__ cols,
                         const Tv* __restrict__ vals,
                         const float* __restrict__ scales,
                         const Tb* __restrict__ b, Tb* __restrict__ c, int m,
                         int n, int k_blk, int num_windows) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  const int col = blockIdx.y * kCols + threadIdx.y;
  if (w >= num_windows || col >= n) return;
  const int64_t t_lo = static_cast<int64_t>(win_ptr[w]) * k_blk;
  const int64_t t_hi = static_cast<int64_t>(win_ptr[w + 1]) * k_blk;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  for (int64_t t = t_lo; t < t_hi; ++t) {
    const float bv =
        repro::load_b(b + static_cast<int64_t>(__ldg(cols + t)) * n + col);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc[v] = fmaf(load_val(vals, scales, t * V + v, t, k_blk), bv, acc[v]);
    }
  }

#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t row = w * V + v;
    if (row < m) c[row * n + col] = repro::from_f32<Tb>(acc[v]);
  }
}

template <typename Tv, typename Tb>
cudaError_t launch(const void* win_ptr, const void* cols, const void* vals,
                   const void* scales, const void* b, void* c, int m, int n,
                   int num_windows, int v, int k_blk, cudaStream_t stream) {
  if (std::is_same<Tv, int8_t>::value && scales == nullptr) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((num_windows + kLanes - 1) / kLanes, (n + kCols - 1) / kCols);
  const dim3 block(kLanes, kCols);
  const auto* wp = static_cast<const int*>(win_ptr);
  const auto* cl = static_cast<const int*>(cols);
  const auto* vl = static_cast<const Tv*>(vals);
  const auto* sc = static_cast<const float*>(scales);
  const auto* bb = static_cast<const Tb*>(b);
  auto* cc = static_cast<Tb*>(c);
  switch (v) {
    case 8:
      spmm_noncoalesced_kernel<8, Tv, Tb><<<grid, block, 0, stream>>>(
          wp, cl, vl, sc, bb, cc, m, n, k_blk, num_windows);
      break;
    case 16:
      spmm_noncoalesced_kernel<16, Tv, Tb><<<grid, block, 0, stream>>>(
          wp, cl, vl, sc, bb, cc, m, n, k_blk, num_windows);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// win_ptr (W + 1,) int32, cols (NNZP,) int32, vals (NNZP, V) of vals_type
// (0 f32, 1 bf16, 2 int8), scales (NB,) f32 (int8 values only, else null),
// b (K, N) of b_type (0 f32, 1 bf16) row-major, c (M, N) of b_type
// row-major; N / 4 at most 65,535.
extern "C" int spmm_noncoalesced_launch(const void* win_ptr, const void* cols,
                                        const void* vals, const void* scales,
                                        const void* b, void* c, int m, int n,
                                        int num_windows, int v, int k_blk,
                                        int vals_type, int b_type,
                                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tv, auto tb) {
    return launch<decltype(tv), decltype(tb)>(win_ptr, cols, vals, scales, b,
                                              c, m, n, num_windows, v, k_blk,
                                              st);
  };
  if (vals_type == 0 && b_type == 0) return run(float{}, float{});
  if (vals_type == 1 && b_type == 1) {
    return run(__nv_bfloat16{}, __nv_bfloat16{});
  }
  if (vals_type == 2 && b_type == 0) return run(int8_t{}, float{});
  if (vals_type == 2 && b_type == 1) return run(int8_t{}, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(spmm_noncoalesced_error_string)
