// Load-balanced single-pass sparse attention over a block-parallel
// Schedule cut into runs: out[h] = softmax_rows(mask * (Q_s[h] @ K[h]^T))
// @ Vmat[h], fp32, for H heads, each of Q, K and Vmat either per head or
// shared, with Q_s = scale * Q folded in before the launch.
//
// Replaces: src/repro/kernels/attention_pallas.py, _balanced_attn_kernel
// (launched through attention_pallas_balanced).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is Q (M x D), K (Mc x D), Vmat (Mc x DV), each per distinct head,
// + mask (NNZP x V bytes) + cols (NNZP) + the run plan (run_ptr, pieces)
// + out (H x M x DV); scores and probabilities never reach device memory.
// On the Amazon replica's A at D = DV = 32 (Q = K), 181 MB, 0.054 ms at
// 3.35 TB/s, against about 2 * nnz * (D + DV) = 0.43 GFLOP plus one exp
// per score, 0.006 ms at the 67 TFLOP/s fp32 rate.
//
// Design.  The TPU kernel carries the online-softmax state (m, l, acc) of
// a window across its split segments on a sequential grid.  CUDA blocks
// run in no order, so the carry lives inside a warp:
//   1. run pass: kernels/_combine.py cuts the schedule's segments, in
//      order, into runs of about run_blk K-blocks (cut only at segment
//      boundaries, near a window boundary where one is close); a run is a
//      list of pieces, one per window it touches.  One warp per (run,
//      head), four per thread block, walks the run's pieces in order.  Per
//      piece it stages the window's V scaled query rows in shared memory,
//      where they stay for the whole piece, and runs attention.cu's
//      warp-per-window online softmax over the piece's vectors: chunks of
//      32, one vector per lane, that span the piece's segments, so a window
//      of 36 vectors takes 2 chunks whatever split_blk cut it into (a
//      masked score is -FLT_MAX, and p = exp(s - m) * maskf after the exp,
//      so a fully masked chunk adds 0).  When the run holds the whole
//      window, the warp normalises and stores its rows; otherwise it
//      writes the unnormalised acc (V, DV), the row maxima m (V) and the
//      row sums l (V) to the piece's edge entry.  A run leaves partials
//      for at most two windows, the one cut at its start and the one cut
//      at its end.
//   2. combine tree: the edge entries of each window that runs cut are
//      merged by a tree of groups (tree_meta, from kernels/_combine.py),
//      one level per launch (a hub window of a power-law graph's transpose
//      is cut into thousands of runs).
//      One warp per (group, head) merges the group's up to 32 entries in
//      order by log-sum-exp, M = max_e m_e, L = sum_e l_e exp(m_e - M),
//      A = sum_e acc_e exp(m_e - M), with L and A summed and kept in fp64,
//      and writes (M, L, A) as one entry of the next level or, for the
//      window's last group, A / max(L, 1e-20) as its rows of out.
// No atomics: the result is the same bits from run to run.  The merge is
// exact in exact arithmetic; only the rounding differs from the
// sequential carry.  A pass with one warp per segment would, at
// split_blk = 1, give a warp one K-block (8 of its 32 lanes busy in the
// score step), reload the window's queries per segment and write 1,088
// bytes of (m, l, acc) for every segment of a split window: at DV = 32 on
// the Amazon replica, 0.25 GB written and read back on A (227,197
// segments) and 0.42 GB on Aᵀ (388,828).  Runs of 16 K-blocks leave none
// on A and 22,899 entries on Aᵀ (25 MB, 17x fewer); phase 5 of
// chip_smoke.py prints them for every plan.  An entry with no unmasked
// score has m = -FLT_MAX, l = 0 and acc = 0, so it weighs nothing; an
// empty window (a zero-length piece) and an empty row store 0, not NaN.
// Rows >= M are not written.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // runs per thread block
constexpr int kChunk = 32;  // vectors per online-softmax step, one per lane

// Floats of shared memory per warp: queries (V, d), accumulator (V, dv),
// probabilities (V, kChunk), row sums (V), column ids (kChunk ints),
// rounded up to keep every warp's region 16-byte aligned.
int warp_floats(int v, int d, int dv) {
  return (v * d + v * dv + v * (kChunk + 1) + kChunk + 3) / 4 * 4;
}

template <int V, bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
attention_run_kernel(
               const int* __restrict__ run_ptr, const int* __restrict__ pieces,
               int num_runs, const int* __restrict__ cols,
               const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ vmat,
               const uint8_t* __restrict__ mask, float* __restrict__ out,
               float* __restrict__ part_acc, float* __restrict__ part_m,
               float* __restrict__ part_l, int m, int d, int dv, int k_blk,
               int64_t entries, int per_warp, int64_t q_hstride,
               int64_t k_hstride, int64_t v_hstride) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  const int64_t h = blockIdx.y;
  if (r >= num_runs) return;  // the whole warp leaves together

  float* s_q = smem + static_cast<size_t>(warp) * per_warp;  // (V, d)
  float* s_acc = s_q + V * d;                                 // (V, dv)
  float* s_p = s_acc + V * dv;                                // (V, kChunk)
  float* s_l = s_p + V * kChunk;                              // (V,)
  int* s_cols = reinterpret_cast<int*>(s_l + V);              // (kChunk,)

  const float* qh = q + h * q_hstride;
  const float* kh = k + h * k_hstride;
  const float* vh = vmat + h * v_hstride;
  for (int pi = run_ptr[r]; pi < run_ptr[r + 1]; ++pi) {
    // One piece: the run's K-blocks of one window, online softmax carried
    // across its segments.
    const int* pm = pieces + 4 * static_cast<int64_t>(pi);
    const int64_t row0 = static_cast<int64_t>(pm[0]) * V;
    __syncwarp();  // the last piece's reads of s_q, s_acc and s_l are done
    for (int i = lane; i < V * d; i += 32) {
      const int64_t row = row0 + i / d;
      s_q[i] = row < m ? qh[row * d + i % d] : 0.f;
    }
    for (int i = lane; i < V * dv; i += 32) s_acc[i] = 0.f;
    float m_run[V], l_run[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      m_run[v] = -FLT_MAX;
      l_run[v] = 0.f;
    }
    __syncwarp();

    const int64_t t_lo = static_cast<int64_t>(pm[1]) * k_blk;
    const int64_t t_hi = t_lo + static_cast<int64_t>(pm[2]) * k_blk;
    for (int64_t t0 = t_lo; t0 < t_hi; t0 += kChunk) {
      const int64_t t = t0 + lane;
      const bool in = t < t_hi;
      const int col = in ? cols[t] : 0;

      // 1. this lane's V scores
      float sc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) sc[v] = 0.f;
      if (in) {
        const float* krow = kh + static_cast<int64_t>(col) * d;
        if constexpr (kVec4) {
          for (int dd = 0; dd < d; dd += 4) {
            const float4 kv = __ldg(reinterpret_cast<const float4*>(krow + dd));
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(s_q + v * d + dd);
              sc[v] = fmaf(kv.x, qv.x, sc[v]);
              sc[v] = fmaf(kv.y, qv.y, sc[v]);
              sc[v] = fmaf(kv.z, qv.z, sc[v]);
              sc[v] = fmaf(kv.w, qv.w, sc[v]);
            }
          }
        } else {
          for (int dd = 0; dd < d; ++dd) {
            const float kv = __ldg(krow + dd);
#pragma unroll
            for (int v = 0; v < V; ++v) sc[v] = fmaf(kv, s_q[v * d + dd], sc[v]);
          }
        }
      }

      // 2. online softmax statistics over the chunk
      float alpha[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float maskf = (in && mask[t * V + v]) ? 1.f : 0.f;
        const float sv = maskf > 0.f ? sc[v] : -FLT_MAX;
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
        for (int j = 0; j < nr; ++j) {
          const float vr = __ldg(vh + static_cast<int64_t>(s_cols[j]) * dv + c);
#pragma unroll
          for (int v = 0; v < V; ++v) a[v] = fmaf(s_p[v * kChunk + j], vr, a[v]);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) s_acc[v * dv + c] = a[v];
      }
      __syncwarp();  // s_p and s_cols are rewritten by the next chunk
    }

    if (pm[3] < 0) {  // the run holds the whole window: normalise, store
      if (lane == 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) s_l[v] = l_run[v];
      }
      __syncwarp();
      float* oh = out + h * m * dv;
      for (int i = lane; i < V * dv; i += 32) {
        const int v = i / dv;
        const int64_t row = row0 + v;
        if (row < m) {
          oh[row * dv + (i - v * dv)] = s_acc[i] / fmaxf(s_l[v], 1e-20f);
        }
      }
    } else {  // a run edge: (m, l, acc) to the piece's edge entry
      const int64_t slot = h * entries + pm[3];
      if (lane == 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          part_m[slot * V + v] = m_run[v];
          part_l[slot * V + v] = l_run[v];
        }
      }
      float* pa = part_acc + slot * V * dv;
      for (int i = lane; i < V * dv; i += 32) pa[i] = s_acc[i];
    }
  }
}

template <int V, typename Acc>
__global__ void __launch_bounds__(kWarps * 32)
attention_tree_kernel(
            const int* __restrict__ tree_meta, int group0, int num_groups,
            const Acc* __restrict__ src_acc, const float* __restrict__ src_m,
            const Acc* __restrict__ src_l, int64_t src_entries,
            double* __restrict__ dst_acc, float* __restrict__ dst_m,
            double* __restrict__ dst_l, int64_t tree_entries,
            float* __restrict__ out, int m, int dv) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = blockIdx.x * kWarps + warp;
  const int h = blockIdx.y;
  if (gi >= num_groups) return;
  const int* g = tree_meta + static_cast<int64_t>(group0 + gi) * 4;
  const int64_t lo = h * src_entries + g[0], hi = lo + g[1];
  const int64_t row0 = static_cast<int64_t>(g[2]) * V;
  const int64_t dst = h * tree_entries + g[3];
  for (int i = lane; i < V * dv; i += 32) {
    const int v = i / dv;
    float mx = -FLT_MAX;
    for (int64_t e = lo; e < hi; ++e) mx = fmaxf(mx, src_m[e * V + v]);
    double l = 0.0, a = 0.0;
    for (int64_t e = lo; e < hi; ++e) {
      const double w = expf(src_m[e * V + v] - mx);
      l += src_l[e * V + v] * w;
      a += src_acc[e * V * dv + i] * w;
    }
    if (g[3] < 0) {  // the window's last group: normalise, store
      if (row0 + v < m) {
        out[(static_cast<int64_t>(h) * m + row0 + v) * dv + (i - v * dv)] =
            static_cast<float>(a) / fmaxf(static_cast<float>(l), 1e-20f);
      }
    } else {
      dst_acc[dst * V * dv + i] = a;
      if (i - v * dv == 0) {
        dst_m[dst * V + v] = mx;
        dst_l[dst * V + v] = l;
      }
    }
  }
}

template <int V>
cudaError_t launch(const int* run_ptr, const int* pieces,
                   const int* tree_meta, const int* cols, const float* q,
                   const float* k, const float* vmat, const uint8_t* mask,
                   float* out, float* part_acc, float* part_m, float* part_l,
                   double* tree_acc, float* tree_m, double* tree_l, int m,
                   int d, int dv, int num_runs, int heads, int k_blk,
                   int64_t q_hstride, int64_t k_hstride, int64_t v_hstride,
                   const int* levels, int num_levels, int64_t entries,
                   int64_t tree_entries, cudaStream_t stream) {
  const int per_warp = warp_floats(V, d, dv);
  const size_t smem = sizeof(float) * static_cast<size_t>(per_warp) * kWarps;
  // 16-byte K-row loads need D % 4 == 0 and every head's base aligned too.
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    k_hstride % 4 == 0;
  const void* fn =
      vec4 ? reinterpret_cast<const void*>(attention_run_kernel<V, true>)
           : reinterpret_cast<const void*>(attention_run_kernel<V, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return err;
    }
  }
  const dim3 grid((num_runs + kWarps - 1) / kWarps, heads);
  if (vec4) {
    attention_run_kernel<V, true><<<grid, kWarps * 32, smem, stream>>>(
        run_ptr, pieces, num_runs, cols, q, k, vmat, mask, out, part_acc,
        part_m, part_l, m, d, dv, k_blk, entries, per_warp, q_hstride,
        k_hstride, v_hstride);
  } else {
    attention_run_kernel<V, false><<<grid, kWarps * 32, smem, stream>>>(
        run_ptr, pieces, num_runs, cols, q, k, vmat, mask, out, part_acc,
        part_m, part_l, m, d, dv, k_blk, entries, per_warp, q_hstride,
        k_hstride, v_hstride);
  }
  cudaError_t err = cudaGetLastError();
  for (int l = 0; l < num_levels && err == cudaSuccess; ++l) {
    const int g0 = levels[2 * l], ng = levels[2 * l + 1];
    const dim3 tgrid((ng + kWarps - 1) / kWarps, heads);
    if (l == 0) {
      attention_tree_kernel<V, float><<<tgrid, kWarps * 32, 0, stream>>>(
          tree_meta, g0, ng, part_acc, part_m, part_l, entries, tree_acc,
          tree_m, tree_l, tree_entries, out, m, dv);
    } else {
      attention_tree_kernel<V, double><<<tgrid, kWarps * 32, 0, stream>>>(
          tree_meta, g0, ng, tree_acc, tree_m, tree_l, tree_entries, tree_acc,
          tree_m, tree_l, tree_entries, out, m, dv);
    }
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// run_ptr (NR + 1,), pieces (P, 4), tree_meta (G, 4), cols (NNZP,) int32;
// q (H or 1, M, D) f32 already scaled, k (H or 1, Mc, D) f32, vmat (H or 1,
// Mc, DV) f32, with head strides of 0 for a shared operand; mask (NNZP, V)
// bool; out (H, M, DV) f32; scratch, null when unused: part_acc
// (H, entries, V, DV), part_m and part_l (H, entries, V) f32; tree_acc
// (H, tree_entries, V, DV) f64, tree_m (H, tree_entries, V) f32, tree_l
// (H, tree_entries, V) f64.  levels: host array of (first group, group
// count) per tree level.
extern "C" int attention_balanced_f32(
    const void* run_ptr, const void* pieces, const void* tree_meta,
    const void* cols, const void* q, const void* k, const void* vmat,
    const void* mask, void* out, void* part_acc, void* part_m, void* part_l,
    void* tree_acc, void* tree_m, void* tree_l, int m, int d, int dv,
    int num_runs, int heads, int v, int k_blk, int64_t q_hstride,
    int64_t k_hstride, int64_t v_hstride, const void* levels, int num_levels,
    int64_t entries, int64_t tree_entries, void* stream) {
  const auto* rp = static_cast<const int*>(run_ptr);
  const auto* pc = static_cast<const int*>(pieces);
  const auto* tm = static_cast<const int*>(tree_meta);
  const auto* cl = static_cast<const int*>(cols);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(vmat);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* ta = static_cast<double*>(tree_acc);
  auto* tmx = static_cast<float*>(tree_m);
  auto* tl = static_cast<double*>(tree_l);
  const auto* lv = static_cast<const int*>(levels);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8:
      return launch<8>(rp, pc, tm, cl, qq, kk, vv, mk, o, pa, pm, pl, ta, tmx,
                       tl, m, d, dv, num_runs, heads, k_blk, q_hstride,
                       k_hstride, v_hstride, lv, num_levels, entries,
                       tree_entries, st);
    case 16:
      return launch<16>(rp, pc, tm, cl, qq, kk, vv, mk, o, pa, pm, pl, ta,
                        tmx, tl, m, d, dv, num_runs, heads, k_blk, q_hstride,
                        k_hstride, v_hstride, lv, num_levels, entries,
                        tree_entries, st);
    default:
      return cudaErrorInvalidValue;
  }
}

REPRO_ERROR_STRING(attention_balanced_error_string)
