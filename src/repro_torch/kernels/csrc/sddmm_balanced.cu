// Schedule-driven SDDMM: S[h] = mask * (Q[h] @ K[h]^T) at the blocked
// ME-BCRS pattern, written in the blocked (NNZP, V) layout, for H heads,
// each of Q and K either per head or shared by all heads; Q, K and S all
// fp32 or all bf16 (fp32 dots).
//
// Replaces: src/repro/kernels/sddmm_pallas.py, _balanced_sddmm_kernel
// (launched through sddmm_pallas_balanced), with its bf16 variant.
//
// Bound on the card: bytes.  Each input read once and the output written
// once is Q (M x F per distinct head) + K (Mc x F per distinct head) + mask
// (NNZP x V bytes) + cols (NNZP) + blk_id, blk_win (NSB each) + S
// (H x NNZP x V); the work, 2 * H * NNZP * V * F flops, is well under the
// fp32 rate for that traffic.  bf16 halves the bytes of Q, K and S.
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
// bf16 (the reference's bf16 path, as sddmm_rows.cuh): Q and K widened to
// fp32 as they are read, 8 features a 16-byte load when F is a multiple of
// 8 and the rows are aligned (one at a time otherwise, in the same order),
// fp32 dots, S rounded to bf16 once, at the store.
#include "sddmm_rows.cuh"

namespace {

constexpr int kThreads = 128;

using repro::widen;
using repro::widen8;

template <int V, bool kVec, typename T>
__global__ void __launch_bounds__(kThreads)
sddmm_balanced_kernel(const int* __restrict__ blk_id,
                      const int* __restrict__ blk_win,
                      const int* __restrict__ cols, const T* __restrict__ q,
                      const T* __restrict__ k,
                      const uint8_t* __restrict__ mask, T* __restrict__ out,
                      int m, int f, int k_blk, int64_t rows,
                      int64_t q_hstride, int64_t k_hstride,
                      int64_t out_hstride) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= rows) return;
  const int h = blockIdx.y;
  const int64_t i = t / k_blk;
  const int64_t row = static_cast<int64_t>(blk_id[i]) * k_blk + (t - i * k_blk);
  const int64_t row0 = static_cast<int64_t>(blk_win[i]) * V;
  const T* qh = q + h * q_hstride;
  const T* krow = k + h * k_hstride + static_cast<int64_t>(cols[row]) * f;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  if constexpr (kVec && !std::is_same<T, float>::value) {
    // 8 bf16 features per 16-byte load, in feature order
    for (int d = 0; d < f; d += 8) {
      float kv[8];
      widen8(__ldg(reinterpret_cast<const uint4*>(krow + d)), kv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (row0 + v < m) {
          float qv[8];
          widen8(__ldg(reinterpret_cast<const uint4*>(qh + (row0 + v) * f + d)),
                 qv);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[v] = fmaf(kv[j], qv[j], acc[v]);
        }
      }
    }
  } else if constexpr (kVec) {
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
      const float kv = widen(krow[d]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (row0 + v < m) {
          acc[v] = fmaf(kv, widen(qh[(row0 + v) * f + d]), acc[v]);
        }
      }
    }
  }

  const uint8_t* mk = mask + row * V;
  T* o = out + h * out_hstride + row * V;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int v = 0; v < V; v += 4) {
      const float4 r = make_float4(acc[v] * (mk[v] ? 1.f : 0.f),
                                   acc[v + 1] * (mk[v + 1] ? 1.f : 0.f),
                                   acc[v + 2] * (mk[v + 2] ? 1.f : 0.f),
                                   acc[v + 3] * (mk[v + 3] ? 1.f : 0.f));
      *reinterpret_cast<float4*>(o + v) = r;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      o[v] = __float2bfloat16_rn(acc[v] * (mk[v] ? 1.f : 0.f));
    }
  }
}

template <int V, typename T>
cudaError_t launch(const int* blk_id, const int* blk_win, const int* cols,
                   const void* qv, const void* kv, const uint8_t* mask,
                   void* outv, int m, int f, int num_sched_blocks, int heads,
                   int k_blk, int64_t q_hstride, int64_t k_hstride,
                   int64_t out_hstride, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  T* out = static_cast<T*>(outv);
  const int64_t rows = static_cast<int64_t>(num_sched_blocks) * k_blk;
  const dim3 grid(static_cast<unsigned>((rows + kThreads - 1) / kThreads),
                  heads);
  // 16-byte loads need F a multiple of 16 / sizeof(T) and every head's
  // base aligned too.
  constexpr int kPer16 = 16 / sizeof(T);
  const bool vec = f % kPer16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   q_hstride % kPer16 == 0 && k_hstride % kPer16 == 0;
  if (vec) {
    sddmm_balanced_kernel<V, true, T><<<grid, kThreads, 0, stream>>>(
        blk_id, blk_win, cols, q, k, mask, out, m, f, k_blk, rows, q_hstride,
        k_hstride, out_hstride);
  } else {
    sddmm_balanced_kernel<V, false, T><<<grid, kThreads, 0, stream>>>(
        blk_id, blk_win, cols, q, k, mask, out, m, f, k_blk, rows, q_hstride,
        k_hstride, out_hstride);
  }
  return cudaGetLastError();
}

}  // namespace

// blk_id, blk_win (NSB,) int32, cols (NNZP,) int32, q (H or 1, M, F) and
// k (H or 1, Mc, F) of qk_type (0 f32, 1 bf16) with head strides of 0 for
// a shared operand, mask (NNZP, V) bool, out (H, NNZP, V) of qk_type with
// 16-byte alignment (a fresh allocation).  NSB > 0.
extern "C" int sddmm_balanced_launch(const void* blk_id, const void* blk_win,
                                     const void* cols, const void* q,
                                     const void* k, const void* mask,
                                     void* out, int m, int f,
                                     int num_sched_blocks, int heads, int v,
                                     int k_blk, int64_t q_hstride,
                                     int64_t k_hstride, int64_t out_hstride,
                                     int qk_type, void* stream) {
  auto run = [&](auto vt, auto tt) {
    return launch<decltype(vt)::value, decltype(tt)>(
        static_cast<const int*>(blk_id), static_cast<const int*>(blk_win),
        static_cast<const int*>(cols), q, k, static_cast<const uint8_t*>(mask),
        out, m, f, num_sched_blocks, heads, k_blk, q_hstride, k_hstride,
        out_hstride, static_cast<cudaStream_t>(stream));
  };
  auto by_type = [&](auto vt) {
    if (qk_type == 0) return run(vt, float{});
    if (qk_type == 1) return run(vt, __nv_bfloat16{});
    return cudaErrorInvalidValue;
  };
  if (v == 8) return by_type(std::integral_constant<int, 8>{});
  if (v == 16) return by_type(std::integral_constant<int, 16>{});
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(sddmm_balanced_error_string)
