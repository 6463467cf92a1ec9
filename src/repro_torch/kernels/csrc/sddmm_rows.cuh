// The row-parallel SDDMM kernel, shared by sddmm.cu (one head) and
// sddmm_batched.cu (a grid of H heads): S[h] = mask * (Q[h] @ K[h]^T),
// fp32, written in the blocked (NNZP, V) layout that the following SpMM
// reads.
//
// Design: one thread per sampled row t (a nonzero vector of the blocked
// view), 128 rows per thread block, rows on gridDim.x and heads on
// gridDim.y.  The work per row is small (V dot products of length F), so
// what bounds a simple kernel is the latency of the dependent loads it
// waits on: block_win -> cols -> the K row.  Each thread therefore issues
// the whole K row and the V rows of Q's window block_win[t / k_blk] as
// independent 16-byte loads (when F is a multiple of 4 and the rows are
// 16-byte aligned; one float at a time otherwise, in the same order) and
// keeps its V sums in registers: no shared memory, no shuffles, no
// barriers.  It walks the whole feature dimension in one pass, so the
// reference's feature tile f_blk has no counterpart.  The threads of a
// warp cover consecutive rows, which share a handful of Q windows, so the
// Q rows come from L1.  Each thread writes its V results as one
// contiguous run, S[t, :] = acc * mask.
//   * A head reads Q and K at its own offsets, h * q_hstride and
//     h * k_hstride (0: shared by every head, one copy), and writes its
//     own (NNZP, V) slice.  The per-thread arithmetic does not depend on
//     the head, so H heads in one launch give bitwise the output of H
//     one-head launches.
//   * Q rows past M read as zero, as the reference's zero-padded Q does.
//   * The dummy block of an all-empty matrix is covered; its mask is all
//     False, so it writes zeros.
// The mask arrives as one byte per element (torch.bool), a quarter of the
// reference's f32 copy; the arithmetic is the same.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kSddmmThreads = 128;

template <int V, bool kVec4>
__global__ void __launch_bounds__(kSddmmThreads)
sddmm_rows_kernel(const int* __restrict__ block_win, const int* __restrict__ cols,
                  const float* __restrict__ q, const float* __restrict__ k,
                  const uint8_t* __restrict__ mask, float* __restrict__ out,
                  int m, int f, int k_blk, int64_t nnzp, int64_t q_hstride,
                  int64_t k_hstride) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kSddmmThreads + threadIdx.x;
  if (t >= nnzp) return;
  const int64_t h = blockIdx.y;
  const float* qh = q + h * q_hstride;
  const int64_t row0 = static_cast<int64_t>(block_win[t / k_blk]) * V;
  const float* krow = k + h * k_hstride + static_cast<int64_t>(cols[t]) * f;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  if constexpr (kVec4) {
#pragma unroll 2
    for (int d = 0; d < f; d += 4) {
      const float4 kv = __ldg(reinterpret_cast<const float4*>(krow + d));
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (row0 + v < m) {
          const float4 qv =
              __ldg(reinterpret_cast<const float4*>(qh + (row0 + v) * f + d));
          acc[v] = fmaf(kv.x, qv.x, acc[v]);
          acc[v] = fmaf(kv.y, qv.y, acc[v]);
          acc[v] = fmaf(kv.z, qv.z, acc[v]);
          acc[v] = fmaf(kv.w, qv.w, acc[v]);
        }
      }
    }
  } else {
    for (int d = 0; d < f; ++d) {
      const float kv = __ldg(krow + d);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (row0 + v < m) acc[v] = fmaf(kv, __ldg(qh + (row0 + v) * f + d), acc[v]);
      }
    }
  }

  const uint8_t* mk = mask + t * V;
  float* o = out + h * nnzp * V + t * V;
#pragma unroll
  for (int v = 0; v < V; v += 4) {
    const float4 r = make_float4(acc[v] * (mk[v] ? 1.f : 0.f),
                                 acc[v + 1] * (mk[v + 1] ? 1.f : 0.f),
                                 acc[v + 2] * (mk[v + 2] ? 1.f : 0.f),
                                 acc[v + 3] * (mk[v + 3] ? 1.f : 0.f));
    *reinterpret_cast<float4*>(o + v) = r;
  }
}

template <int V>
cudaError_t launch_sddmm_rows_v(const int* block_win, const int* cols,
                                const float* q, const float* k,
                                const uint8_t* mask, float* out, int m, int f,
                                int num_blocks, int heads, int k_blk,
                                int64_t q_hstride, int64_t k_hstride,
                                cudaStream_t stream) {
  const int64_t nnzp = static_cast<int64_t>(num_blocks) * k_blk;
  const dim3 grid(static_cast<unsigned>((nnzp + kSddmmThreads - 1) / kSddmmThreads),
                  heads);
  // 16-byte loads need every head's rows 16-byte aligned: F a multiple of
  // 4 makes every row and every head stride so once the base pointers are.
  const bool vec4 = f % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k) % 16 == 0;
  if (vec4) {
    sddmm_rows_kernel<V, true><<<grid, kSddmmThreads, 0, stream>>>(
        block_win, cols, q, k, mask, out, m, f, k_blk, nnzp, q_hstride,
        k_hstride);
  } else {
    sddmm_rows_kernel<V, false><<<grid, kSddmmThreads, 0, stream>>>(
        block_win, cols, q, k, mask, out, m, f, k_blk, nnzp, q_hstride,
        k_hstride);
  }
  return cudaGetLastError();
}

// block_win (NB,) int32, cols (NB * k_blk,) int32, q (M, F) f32 with heads
// q_hstride elements apart (0: shared), k (Mc, F) f32 with heads k_hstride
// apart (0: shared), mask (NB * k_blk, V) bool, out (heads, NB * k_blk, V)
// f32 with 16-byte alignment (a fresh allocation).  heads at most 65,535.
inline cudaError_t launch_sddmm_rows(const void* block_win, const void* cols,
                                     const void* q, const void* k,
                                     const void* mask, void* out, int m, int f,
                                     int num_blocks, int heads, int v,
                                     int k_blk, int64_t q_hstride,
                                     int64_t k_hstride, void* stream) {
  const auto* bw = static_cast<const int*>(block_win);
  const auto* cl = static_cast<const int*>(cols);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8:
      return launch_sddmm_rows_v<8>(bw, cl, qq, kk, mk, o, m, f, num_blocks,
                                    heads, k_blk, q_hstride, k_hstride, st);
    case 16:
      return launch_sddmm_rows_v<16>(bw, cl, qq, kk, mk, o, m, f, num_blocks,
                                     heads, k_blk, q_hstride, k_hstride, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro
