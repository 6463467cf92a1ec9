// Load-balanced single-pass sparse attention over a block-parallel
// Schedule cut into runs: out[h] = softmax_rows(mask * (Q_s[h] @ K[h]^T))
// @ Vmat[h] for H heads, each of Q, K and Vmat either per head or shared,
// with Q_s = scale * Q folded in before the launch; Q, K, Vmat and out all
// fp32 or all bf16.
//
// Replaces: src/repro/kernels/attention_pallas.py, _balanced_attn_kernel
// (launched through attention_pallas_balanced), with its bf16 variant
// (attention_pallas.py:392, :401: Q scaled in fp32 and rounded to bf16,
// fp32 scores, softmax and sums, one cast of the output, :324).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is Q (M x D), K (Mc x D), Vmat (Mc x DV), each per distinct head,
// + mask (NNZP x V bytes) + cols (NNZP) + the run plan (run_ptr, pieces)
// + out (H x M x DV); scores and probabilities never reach device memory.
// On the Amazon replica's A at D = DV = 32 (Q = K), 181 MB, 0.054 ms at
// 3.35 TB/s, against about 2 * nnz * (D + DV) = 0.43 GFLOP plus one exp
// per score, 0.006 ms at the 67 TFLOP/s fp32 rate.  bf16 halves the bytes
// of Q, K, Vmat and out.
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
// bf16: the warp stages its window's queries in shared memory as bf16 (the
// scaled, rounded Q_s the wrapper passes), reads K rows 8 features a
// 16-byte load when D is a multiple of 8 and they are aligned (one at a
// time otherwise, in the same order) and Vmat one bf16 at a time, each
// widened to fp32; (m, l, acc), the edge entries and the tree stay fp32
// (fp64 sums), and the output is rounded to bf16 once, from the fp32 value
// the fp32 kernel stores.  Every sum is taken in the fp32 kernel's order,
// so the bf16 result is the fp32 kernel's on the widened operands,
// rounded, bit for bit.
#include "spmm_window.cuh"
#include "tf32.cuh"

namespace {

constexpr int kWarps = 4;   // runs per thread block
constexpr int kChunk = 32;  // vectors per online-softmax step, one per lane

using repro::from_f32;
using repro::load_b;
using repro::widen;
using repro::widen8;

// Bytes of shared memory per warp: queries (V, d) of T, then in floats the
// accumulator (V, dv), probabilities (V, kChunk), row sums (V) and column
// ids (kChunk ints), each part rounded up to keep every warp's region and
// its float part 16-byte aligned.
size_t warp_bytes(int v, int d, int dv, size_t elt) {
  const size_t q = (v * d * elt + 15) / 16 * 16;
  return q + (sizeof(float) * (v * dv + v * (kChunk + 1) + kChunk) + 15) /
                 16 * 16;
}

template <int V, bool kVec, typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_run_kernel(
               const int* __restrict__ run_ptr, const int* __restrict__ pieces,
               int num_runs, const int* __restrict__ cols,
               const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ vmat,
               const uint8_t* __restrict__ mask, T* __restrict__ out,
               float* __restrict__ part_acc, float* __restrict__ part_m,
               float* __restrict__ part_l, int m, int d, int dv, int k_blk,
               int64_t entries, int per_warp, int64_t q_hstride,
               int64_t k_hstride, int64_t v_hstride) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  const int64_t h = blockIdx.y;
  if (r >= num_runs) return;  // the whole warp leaves together

  unsigned char* region = smem_bytes + static_cast<size_t>(warp) * per_warp;
  T* s_q = reinterpret_cast<T*>(region);                      // (V, d)
  float* s_acc = reinterpret_cast<float*>(
      region + (V * d * sizeof(T) + 15) / 16 * 16);           // (V, dv)
  float* s_p = s_acc + V * dv;                                // (V, kChunk)
  float* s_l = s_p + V * kChunk;                              // (V,)
  int* s_cols = reinterpret_cast<int*>(s_l + V);              // (kChunk,)

  const T* qh = q + h * q_hstride;
  const T* kh = k + h * k_hstride;
  const T* vh = vmat + h * v_hstride;
  for (int pi = run_ptr[r]; pi < run_ptr[r + 1]; ++pi) {
    // One piece: the run's K-blocks of one window, online softmax carried
    // across its segments.
    const int* pm = pieces + 4 * static_cast<int64_t>(pi);
    const int64_t row0 = static_cast<int64_t>(pm[0]) * V;
    __syncwarp();  // the last piece's reads of s_q, s_acc and s_l are done
    for (int i = lane; i < V * d; i += 32) {
      const int64_t row = row0 + i / d;
      s_q[i] = row < m ? qh[row * d + i % d] : from_f32<T>(0.f);
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
        const T* krow = kh + static_cast<int64_t>(col) * d;
        if constexpr (kVec && !std::is_same<T, float>::value) {
          // 8 bf16 features per 16-byte load, in feature order
          for (int dd = 0; dd < d; dd += 8) {
            float kv[8];
            widen8(__ldg(reinterpret_cast<const uint4*>(krow + dd)), kv);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              float qv[8];
              widen8(*reinterpret_cast<const uint4*>(s_q + v * d + dd), qv);
#pragma unroll
              for (int j = 0; j < 8; ++j) sc[v] = fmaf(kv[j], qv[j], sc[v]);
            }
          }
        } else if constexpr (kVec) {
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
            const float kv = load_b(krow + dd);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              sc[v] = fmaf(kv, widen(s_q[v * d + dd]), sc[v]);
            }
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
          const float vr = load_b(vh + static_cast<int64_t>(s_cols[j]) * dv + c);
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
      T* oh = out + h * m * dv;
      for (int i = lane; i < V * dv; i += 32) {
        const int v = i / dv;
        const int64_t row = row0 + v;
        if (row < m) {
          oh[row * dv + (i - v * dv)] =
              from_f32<T>(s_acc[i] / fmaxf(s_l[v], 1e-20f));
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

template <int V, typename Acc, typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_tree_kernel(
            const int* __restrict__ tree_meta, int group0, int num_groups,
            const Acc* __restrict__ src_acc, const float* __restrict__ src_m,
            const Acc* __restrict__ src_l, int64_t src_entries,
            double* __restrict__ dst_acc, float* __restrict__ dst_m,
            double* __restrict__ dst_l, int64_t tree_entries,
            T* __restrict__ out, int m, int dv) {
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
            from_f32<T>(static_cast<float>(a) /
                        fmaxf(static_cast<float>(l), 1e-20f));
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

template <int V, typename T>
cudaError_t launch(const int* run_ptr, const int* pieces,
                   const int* tree_meta, const int* cols, const void* qv,
                   const void* kv, const void* vv, const uint8_t* mask,
                   void* outv, float* part_acc, float* part_m, float* part_l,
                   double* tree_acc, float* tree_m, double* tree_l, int m,
                   int d, int dv, int num_runs, int heads, int k_blk,
                   int64_t q_hstride, int64_t k_hstride, int64_t v_hstride,
                   const int* levels, int num_levels, int64_t entries,
                   int64_t tree_entries, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  const T* vmat = static_cast<const T*>(vv);
  T* out = static_cast<T*>(outv);
  const size_t per_warp = warp_bytes(V, d, dv, sizeof(T));
  const size_t smem = per_warp * kWarps;
  // 16-byte K-row loads need D a multiple of 16 / sizeof(T) and every
  // head's base aligned too (the staged queries then are).
  constexpr int kPer16 = 16 / sizeof(T);
  const bool vec = d % kPer16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   k_hstride % kPer16 == 0;
  const void* fn =
      vec ? reinterpret_cast<const void*>(attention_run_kernel<V, true, T>)
          : reinterpret_cast<const void*>(attention_run_kernel<V, false, T>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return err;
    }
  }
  const dim3 grid((num_runs + kWarps - 1) / kWarps, heads);
  const int per_warp_i = static_cast<int>(per_warp);
  if (vec) {
    attention_run_kernel<V, true, T><<<grid, kWarps * 32, smem, stream>>>(
        run_ptr, pieces, num_runs, cols, q, k, vmat, mask, out, part_acc,
        part_m, part_l, m, d, dv, k_blk, entries, per_warp_i, q_hstride,
        k_hstride, v_hstride);
  } else {
    attention_run_kernel<V, false, T><<<grid, kWarps * 32, smem, stream>>>(
        run_ptr, pieces, num_runs, cols, q, k, vmat, mask, out, part_acc,
        part_m, part_l, m, d, dv, k_blk, entries, per_warp_i, q_hstride,
        k_hstride, v_hstride);
  }
  cudaError_t err = cudaGetLastError();
  for (int l = 0; l < num_levels && err == cudaSuccess; ++l) {
    const int g0 = levels[2 * l], ng = levels[2 * l + 1];
    const dim3 tgrid((ng + kWarps - 1) / kWarps, heads);
    if (l == 0) {
      attention_tree_kernel<V, float, T><<<tgrid, kWarps * 32, 0, stream>>>(
          tree_meta, g0, ng, part_acc, part_m, part_l, entries, tree_acc,
          tree_m, tree_l, tree_entries, out, m, dv);
    } else {
      attention_tree_kernel<V, double, T><<<tgrid, kWarps * 32, 0, stream>>>(
          tree_meta, g0, ng, tree_acc, tree_m, tree_l, tree_entries, tree_acc,
          tree_m, tree_l, tree_entries, out, m, dv);
    }
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// run_ptr (NR + 1,), pieces (P, 4), tree_meta (G, 4), cols (NNZP,) int32;
// q (H or 1, M, D) already scaled, k (H or 1, Mc, D), vmat (H or 1, Mc,
// DV) and out (H, M, DV), all of qk_type (0 f32, 1 bf16), with head
// strides of 0 for a shared operand; mask (NNZP, V) bool; scratch, null
// when unused: part_acc (H, entries, V, DV), part_m and part_l
// (H, entries, V) f32; tree_acc (H, tree_entries, V, DV) f64, tree_m
// (H, tree_entries, V) f32, tree_l (H, tree_entries, V) f64.  levels: host
// array of (first group, group count) per tree level.
extern "C" int attention_balanced_launch(
    const void* run_ptr, const void* pieces, const void* tree_meta,
    const void* cols, const void* q, const void* k, const void* vmat,
    const void* mask, void* out, void* part_acc, void* part_m, void* part_l,
    void* tree_acc, void* tree_m, void* tree_l, int m, int d, int dv,
    int num_runs, int heads, int v, int k_blk, int64_t q_hstride,
    int64_t k_hstride, int64_t v_hstride, const void* levels, int num_levels,
    int64_t entries, int64_t tree_entries, int qk_type, void* stream) {
  auto run = [&](auto vt, auto tt) {
    return launch<decltype(vt)::value, decltype(tt)>(
        static_cast<const int*>(run_ptr), static_cast<const int*>(pieces),
        static_cast<const int*>(tree_meta), static_cast<const int*>(cols), q,
        k, vmat, static_cast<const uint8_t*>(mask), out,
        static_cast<float*>(part_acc), static_cast<float*>(part_m),
        static_cast<float*>(part_l), static_cast<double*>(tree_acc),
        static_cast<float*>(tree_m), static_cast<double*>(tree_l), m, d, dv,
        num_runs, heads, k_blk, q_hstride, k_hstride, v_hstride,
        static_cast<const int*>(levels), num_levels, entries, tree_entries,
        static_cast<cudaStream_t>(stream));
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

REPRO_ERROR_STRING(attention_balanced_error_string)
