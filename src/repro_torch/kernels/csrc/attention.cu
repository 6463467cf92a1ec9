// Single-pass fused sparse attention over the blocked ME-BCRS pattern:
// out[h] = softmax_rows(mask * (Q_s[h] @ K[h]^T)) @ Vmat[h], fp32, for H
// heads in one launch, with Q_s = scale * Q folded in before the launch
// (one scale for every head).  Q, K and Vmat are each either per head or
// shared by every head.
//
// Replaces: src/repro/kernels/attention_pallas.py, _fused_attn_kernel
// (launched through attention_pallas).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is Q (M x D) + K, Vmat (Mc x D, Mc x DV), each per distinct head, +
// mask (NNZP x V bytes) + cols (NNZP) + win_ptr + out (H x M x DV); scores
// and probabilities never reach device memory.  The work, about
// 2 * H * NNZP * V * (D + DV) flops plus one exp per score, is well under
// the fp32 rate for that traffic.
//
// Design: one warp per (window, head), four windows per thread block,
// windows on gridDim.x and heads on gridDim.y, and no synchronisation
// wider than the warp.  A head reads Q, K and Vmat at its own offsets
// (h * q_hstride, h * k_hstride, h * v_hstride; a stride of 0 shares the
// operand's one copy) and writes its own (M, DV) slice; the pattern
// (win_ptr, cols, mask) is shared, and the per-warp arithmetic does not
// depend on the head, so H heads in one launch give bitwise the output of
// H one-head launches.  The warp stages the window's V
// scaled query rows in shared memory and walks the window's vectors
// [win_ptr[w] * k_blk, win_ptr[w+1] * k_blk) in chunks of 32, one vector
// per lane, so every lane issues its own K-row loads (16 bytes at a time
// when D is a multiple of 4) without waiting on the others.  Per chunk:
//   1. lane r forms the V scores of its vector against the queries; a
//      masked score is -FLT_MAX, not -inf;
//   2. the online softmax folds the chunk in, per window row v:
//      m_new = max(m, max_r s), alpha = exp(m - m_new),
//      p = exp(s - m_new) * maskf (multiplied after the exp, so a fully
//      masked chunk adds 0 and alpha stays 1), l = alpha * l + sum_r p;
//      the maxima and sums are warp reductions;
//   3. acc = alpha * acc + p^T @ Vmat[cols], with lanes on neighbouring
//      output columns, so each Vmat row is one coalesced read.
// The reference updates m and l once per K-block; here they are updated
// once per 32 vectors.  The online softmax is exact under any grouping,
// so only the rounding differs.  The epilogue divides by max(l, 1e-20),
// so empty windows and rows give 0, and does not write rows >= M.  The
// mask arrives as one byte per element (torch.bool), a quarter of the
// reference's f32 copy; the semantics are the same.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // windows per thread block
constexpr int kChunk = 32;  // vectors per online-softmax step, one per lane

// Floats of shared memory per warp: queries (V, d), accumulator (V, dv),
// probabilities (V, kChunk), row sums (V), column ids (kChunk ints),
// rounded up to keep every warp's region 16-byte aligned.  A width whose
// total exceeds the card's per-block limit fails in cudaFuncSetAttribute.
int warp_floats(int v, int d, int dv) {
  return (v * d + v * dv + v * (kChunk + 1) + kChunk + 3) / 4 * 4;
}

template <int V, bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const int* __restrict__ win_ptr, const int* __restrict__ cols,
                 const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ vmat,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int m, int d, int dv, int k_blk, int num_windows,
                 int per_warp, int64_t q_hstride, int64_t k_hstride,
                 int64_t v_hstride) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= num_windows) return;  // the whole warp leaves together
  const int64_t h = blockIdx.y;
  q += h * q_hstride;
  k += h * k_hstride;
  vmat += h * v_hstride;
  out += h * static_cast<int64_t>(m) * dv;

  float* s_q = smem + static_cast<size_t>(warp) * per_warp;  // (V, d)
  float* s_acc = s_q + V * d;                                 // (V, dv)
  float* s_p = s_acc + V * dv;                                // (V, kChunk)
  float* s_l = s_p + V * kChunk;                              // (V,)
  int* s_cols = reinterpret_cast<int*>(s_l + V);              // (kChunk,)

  const int64_t row0 = static_cast<int64_t>(w) * V;
  for (int i = lane; i < V * d; i += 32) {
    const int64_t row = row0 + i / d;
    s_q[i] = row < m ? q[row * d + i % d] : 0.f;
  }
  for (int i = lane; i < V * dv; i += 32) s_acc[i] = 0.f;
  float m_run[V], l_run[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m_run[v] = -FLT_MAX;
    l_run[v] = 0.f;
  }
  __syncwarp();

  const int64_t t_lo = static_cast<int64_t>(win_ptr[w]) * k_blk;
  const int64_t t_hi = static_cast<int64_t>(win_ptr[w + 1]) * k_blk;
  for (int64_t t0 = t_lo; t0 < t_hi; t0 += kChunk) {
    const int64_t t = t0 + lane;
    const bool in = t < t_hi;
    const int col = in ? cols[t] : 0;

    // 1. this lane's V scores
    float s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = 0.f;
    if (in) {
      const float* krow = k + static_cast<int64_t>(col) * d;
      if constexpr (kVec4) {
        for (int dd = 0; dd < d; dd += 4) {
          const float4 kv = __ldg(reinterpret_cast<const float4*>(krow + dd));
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float4 qv = *reinterpret_cast<const float4*>(s_q + v * d + dd);
            s[v] = fmaf(kv.x, qv.x, s[v]);
            s[v] = fmaf(kv.y, qv.y, s[v]);
            s[v] = fmaf(kv.z, qv.z, s[v]);
            s[v] = fmaf(kv.w, qv.w, s[v]);
          }
        }
      } else {
        for (int dd = 0; dd < d; ++dd) {
          const float kv = __ldg(krow + dd);
#pragma unroll
          for (int v = 0; v < V; ++v) s[v] = fmaf(kv, s_q[v * d + dd], s[v]);
        }
      }
    }

    // 2. online softmax statistics over the chunk
    float alpha[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float maskf = (in && mask[t * V + v]) ? 1.f : 0.f;
      const float sv = maskf > 0.f ? s[v] : -FLT_MAX;
      const float m_new = fmaxf(m_run[v], repro::warp_max(sv));
      alpha[v] = expf(m_run[v] - m_new);
      const float p = expf(sv - m_new) * maskf;
      l_run[v] = l_run[v] * alpha[v] + repro::warp_sum(p);
      m_run[v] = m_new;
      s_p[v * kChunk + lane] = p;
    }
    s_cols[lane] = col;
    __syncwarp();

    // 3. acc = alpha * acc + p^T @ Vmat rows, lanes on output columns
    const int nr = t_hi - t0 < kChunk ? static_cast<int>(t_hi - t0) : kChunk;
    for (int c = lane; c < dv; c += 32) {
      float a[V];
#pragma unroll
      for (int v = 0; v < V; ++v) a[v] = s_acc[v * dv + c] * alpha[v];
      for (int r = 0; r < nr; ++r) {
        const float vr = __ldg(vmat + static_cast<int64_t>(s_cols[r]) * dv + c);
#pragma unroll
        for (int v = 0; v < V; ++v) a[v] = fmaf(s_p[v * kChunk + r], vr, a[v]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) s_acc[v * dv + c] = a[v];
    }
    __syncwarp();  // s_p and s_cols are rewritten by the next chunk
  }

  if (lane == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) s_l[v] = l_run[v];
  }
  __syncwarp();
  for (int i = lane; i < V * dv; i += 32) {
    const int v = i / dv;
    const int64_t row = row0 + v;
    if (row < m) out[row * dv + (i - v * dv)] = s_acc[i] / fmaxf(s_l[v], 1e-20f);
  }
}

template <int V>
cudaError_t launch(const int* win_ptr, const int* cols, const float* q,
                   const float* k, const float* vmat, const uint8_t* mask,
                   float* out, int m, int d, int dv, int num_windows,
                   int heads, int k_blk, int64_t q_hstride, int64_t k_hstride,
                   int64_t v_hstride, cudaStream_t stream) {
  const int per_warp = warp_floats(V, d, dv);
  const size_t smem = sizeof(float) * static_cast<size_t>(per_warp) * kWarps;
  // D a multiple of 4 keeps every K row and every head's K 16-byte
  // aligned once the base pointer is.
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  const void* fn = vec4 ? reinterpret_cast<const void*>(attention_kernel<V, true>)
                        : reinterpret_cast<const void*>(attention_kernel<V, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return err;
    }
  }
  const dim3 grid((num_windows + kWarps - 1) / kWarps, heads);
  if (vec4) {
    attention_kernel<V, true><<<grid, kWarps * 32, smem, stream>>>(
        win_ptr, cols, q, k, vmat, mask, out, m, d, dv, k_blk, num_windows,
        per_warp, q_hstride, k_hstride, v_hstride);
  } else {
    attention_kernel<V, false><<<grid, kWarps * 32, smem, stream>>>(
        win_ptr, cols, q, k, vmat, mask, out, m, d, dv, k_blk, num_windows,
        per_warp, q_hstride, k_hstride, v_hstride);
  }
  return cudaGetLastError();
}

}  // namespace

// win_ptr (W + 1,) int32, cols (NNZP,) int32, q (M, D) f32 already scaled,
// k (Mc, D) f32, vmat (Mc, DV) f32, each with heads q_hstride, k_hstride,
// v_hstride elements apart (0: shared by every head), mask (NNZP, V) bool,
// out (H, M, DV) f32.  H at most 65,535.
extern "C" int attention_f32(const void* win_ptr, const void* cols,
                             const void* q, const void* k, const void* vmat,
                             const void* mask, void* out, int m, int d, int dv,
                             int num_windows, int heads, int v, int k_blk,
                             int64_t q_hstride, int64_t k_hstride,
                             int64_t v_hstride, void* stream) {
  const auto* wp = static_cast<const int*>(win_ptr);
  const auto* cl = static_cast<const int*>(cols);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(vmat);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8:
      return launch<8>(wp, cl, qq, kk, vv, mk, o, m, d, dv, num_windows, heads,
                       k_blk, q_hstride, k_hstride, v_hstride, st);
    case 16:
      return launch<16>(wp, cl, qq, kk, vv, mk, o, m, d, dv, num_windows, heads,
                        k_blk, q_hstride, k_hstride, v_hstride, st);
    default:
      return cudaErrorInvalidValue;
  }
}

REPRO_ERROR_STRING(attention_error_string)
