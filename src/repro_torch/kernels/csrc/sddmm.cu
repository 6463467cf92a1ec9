// SDDMM over the blocked ME-BCRS pattern: S = mask * (Q @ K^T), fp32,
// written in the blocked (NNZP, V) layout that the following SpMM reads.
//
// Replaces: src/repro/kernels/sddmm_pallas.py, _fused_sddmm_kernel
// (launched through sddmm_pallas).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is Q (M x F) + K (Mc x F) + mask (NNZP x V bytes) + cols (NNZP) +
// block_win (NB) + S (NNZP x V); the work, 2 * NNZP * V * F flops, is
// well under the fp32 rate for that traffic.
//
// Design: one thread per sampled row t (a nonzero vector of the blocked
// view), 128 rows per thread block.  The work per row is small (V dot
// products of length F), so what bounds a simple kernel is the latency of
// the dependent loads it waits on: block_win -> cols -> the K row.  Each
// thread therefore issues the whole K row and the V rows of Q's window
// block_win[t / k_blk] as independent 16-byte loads (when F is a multiple
// of 4 and the rows are 16-byte aligned; one float at a time otherwise)
// and keeps its V sums in registers: no shared memory, no shuffles, no
// barriers.  The threads of a warp cover consecutive rows, which share a
// handful of Q windows, so the Q rows come from L1.  Each thread writes
// its V results as one contiguous run, S[t, :] = acc * mask.
//   * Q rows past M read as zero, as the reference's zero-padded Q does.
//   * The dummy block of an all-empty matrix is covered; its mask is all
//     False, so it writes zeros.
// The mask arrives as one byte per element (torch.bool), a quarter of the
// reference's f32 copy; the arithmetic is the same.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int V, bool kVec4>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int* __restrict__ block_win, const int* __restrict__ cols,
             const float* __restrict__ q, const float* __restrict__ k,
             const uint8_t* __restrict__ mask, float* __restrict__ out,
             int m, int f, int k_blk, int64_t nnzp) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= nnzp) return;
  const int64_t row0 = static_cast<int64_t>(block_win[t / k_blk]) * V;
  const float* krow = k + static_cast<int64_t>(cols[t]) * f;

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
              __ldg(reinterpret_cast<const float4*>(q + (row0 + v) * f + d));
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
        if (row0 + v < m) acc[v] = fmaf(kv, __ldg(q + (row0 + v) * f + d), acc[v]);
      }
    }
  }

  const uint8_t* mk = mask + t * V;
  float* o = out + t * V;
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
cudaError_t launch(const int* block_win, const int* cols, const float* q,
                   const float* k, const uint8_t* mask, float* out, int m,
                   int f, int num_blocks, int k_blk, cudaStream_t stream) {
  const int64_t nnzp = static_cast<int64_t>(num_blocks) * k_blk;
  const auto grid = static_cast<unsigned>((nnzp + kThreads - 1) / kThreads);
  const bool vec4 = f % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k) % 16 == 0;
  if (vec4) {
    sddmm_kernel<V, true><<<grid, kThreads, 0, stream>>>(
        block_win, cols, q, k, mask, out, m, f, k_blk, nnzp);
  } else {
    sddmm_kernel<V, false><<<grid, kThreads, 0, stream>>>(
        block_win, cols, q, k, mask, out, m, f, k_blk, nnzp);
  }
  return cudaGetLastError();
}

}  // namespace

// block_win (NB,) int32, cols (NB * k_blk,) int32, q (M, F) f32,
// k (Mc, F) f32, mask (NB * k_blk, V) bool, out (NB * k_blk, V) f32 with
// 16-byte alignment (a fresh allocation).
extern "C" int sddmm_f32(const void* block_win, const void* cols, const void* q,
                         const void* k, const void* mask, void* out, int m,
                         int f, int num_blocks, int v, int k_blk,
                         void* stream) {
  const auto* bw = static_cast<const int*>(block_win);
  const auto* cl = static_cast<const int*>(cols);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8:
      return launch<8>(bw, cl, qq, kk, mk, o, m, f, num_blocks, k_blk, st);
    case 16:
      return launch<16>(bw, cl, qq, kk, mk, o, m, f, num_blocks, k_blk, st);
    default:
      return cudaErrorInvalidValue;
  }
}

REPRO_ERROR_STRING(sddmm_error_string)
