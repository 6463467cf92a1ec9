// Schedule-driven SDDMM: S[h] = mask * (Q[h] @ K[h]^T) at the blocked
// ME-BCRS pattern, fp32, written in the blocked (NNZP, V) layout, for H
// heads, each of Q and K either per head or shared by all heads.
//
// Replaces: src/repro/kernels/sddmm_pallas.py, _balanced_sddmm_kernel
// (launched through sddmm_pallas_balanced).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is Q (M x F per distinct head) + K (Mc x F per distinct head) + mask
// (NNZP x V bytes) + cols (NNZP) + blk_id, blk_win (NSB each) + S
// (H x NNZP x V); the work, 2 * H * NNZP * V * F flops, is well under the
// fp32 rate for that traffic.
//
// Design.  SDDMM is block-parallel already: every K-block is the same
// amount of work, so the schedule adds only its block list.  The kernel is
// sddmm.cu's one thread per sampled row, walking the schedule's blocks
// instead of all blocks: thread t takes row t % k_blk of scheduled block
// blk_id[t / k_blk], whose window is blk_win[t / k_blk], and the head on
// gridDim.y.  What bounds such a simple kernel is the latency of dependent
// loads (blk_id -> cols -> the K row), so each thread issues the whole K
// row and its window's V query rows as independent 16-byte loads (when F
// is a multiple of 4 and the rows are aligned) and keeps its V sums in
// registers: no shared memory, no shuffles, no barriers.  Q rows past M
// read as zero.  A schedule with no blocks (the all-empty matrix) is never
// launched: the wrapper returns zeros.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int V, bool kVec4>
__global__ void __launch_bounds__(kThreads)
sddmm_balanced_kernel(const int* __restrict__ blk_id,
                      const int* __restrict__ blk_win,
                      const int* __restrict__ cols, const float* __restrict__ q,
                      const float* __restrict__ k,
                      const uint8_t* __restrict__ mask, float* __restrict__ out,
                      int m, int f, int k_blk, int64_t rows,
                      int64_t q_hstride, int64_t k_hstride,
                      int64_t out_hstride) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= rows) return;
  const int h = blockIdx.y;
  const int64_t i = t / k_blk;
  const int64_t row = static_cast<int64_t>(blk_id[i]) * k_blk + (t - i * k_blk);
  const int64_t row0 = static_cast<int64_t>(blk_win[i]) * V;
  const float* qh = q + h * q_hstride;
  const float* krow = k + h * k_hstride + static_cast<int64_t>(cols[row]) * f;

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

  const uint8_t* mk = mask + row * V;
  float* o = out + h * out_hstride + row * V;
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
cudaError_t launch(const int* blk_id, const int* blk_win, const int* cols,
                   const float* q, const float* k, const uint8_t* mask,
                   float* out, int m, int f, int num_sched_blocks,
                   int heads, int k_blk, int64_t q_hstride,
                   int64_t k_hstride, int64_t out_hstride,
                   cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(num_sched_blocks) * k_blk;
  const dim3 grid(static_cast<unsigned>((rows + kThreads - 1) / kThreads),
                  heads);
  // 16-byte loads need F % 4 == 0 and every head's base aligned too.
  const bool vec4 = f % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    q_hstride % 4 == 0 && k_hstride % 4 == 0;
  if (vec4) {
    sddmm_balanced_kernel<V, true><<<grid, kThreads, 0, stream>>>(
        blk_id, blk_win, cols, q, k, mask, out, m, f, k_blk, rows, q_hstride,
        k_hstride, out_hstride);
  } else {
    sddmm_balanced_kernel<V, false><<<grid, kThreads, 0, stream>>>(
        blk_id, blk_win, cols, q, k, mask, out, m, f, k_blk, rows, q_hstride,
        k_hstride, out_hstride);
  }
  return cudaGetLastError();
}

}  // namespace

// blk_id, blk_win (NSB,) int32, cols (NNZP,) int32, q (H or 1, M, F) f32,
// k (H or 1, Mc, F) f32 with head strides of 0 for a shared operand,
// mask (NNZP, V) bool, out (H, NNZP, V) f32 with 16-byte alignment (a
// fresh allocation).  NSB > 0.
extern "C" int sddmm_balanced_f32(const void* blk_id, const void* blk_win,
                                  const void* cols, const void* q,
                                  const void* k, const void* mask, void* out,
                                  int m, int f, int num_sched_blocks,
                                  int heads, int v, int k_blk,
                                  int64_t q_hstride, int64_t k_hstride,
                                  int64_t out_hstride, void* stream) {
  const auto* bi = static_cast<const int*>(blk_id);
  const auto* bw = static_cast<const int*>(blk_win);
  const auto* cl = static_cast<const int*>(cols);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8:
      return launch<8>(bi, bw, cl, qq, kk, mk, o, m, f, num_sched_blocks, heads,
                       k_blk, q_hstride, k_hstride, out_hstride, st);
    case 16:
      return launch<16>(bi, bw, cl, qq, kk, mk, o, m, f, num_sched_blocks,
                        heads, k_blk, q_hstride, k_hstride, out_hstride, st);
    default:
      return cudaErrorInvalidValue;
  }
}

REPRO_ERROR_STRING(sddmm_balanced_error_string)
