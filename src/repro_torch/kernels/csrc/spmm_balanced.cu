// Load-balanced SpMM over a block-parallel Schedule:
// C[h] (M, N) = A[h] (M, K) @ B[h] (K, N), fp32, for H heads, each of vals
// and B either per head or shared by all heads.
//
// Replaces: src/repro/kernels/spmm_pallas.py, _balanced_spmm_kernel
// (launched through spmm_pallas_balanced).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is vals (NNZP x V per distinct head) + cols (NNZP) + B (K x N per
// distinct head) + the schedule (seg_win, seg_meta) + C (H x M x N); the
// work, 2 * H * NNZP * V * N flops, is far below the fp32 rate for that
// traffic.
//
// Design.  The TPU kernel runs the schedule's segments on a sequential
// grid and carries a window's accumulator from one segment to the next in
// VMEM.  CUDA blocks run in no order, so a window that is split over
// several segments is summed in two passes, in a fixed order (no atomics,
// so the result does not change from run to run):
//   1. segment pass: one thread block per (segment, column tile, head),
//      the inner loop of spmm.cu over the segment's K-blocks only.  A
//      window with a single segment (first and last) stores its rows of C
//      directly; a segment of a split window writes its (V, N) partial sum
//      to scratch that the wrapper allocates, at its segment index.
//   2. combine tree: the segments of each split window are summed by a
//      tree of groups (tree_meta, from kernels/_combine.py), one level
//      per launch: one thread block per (group, column tile, head) adds the
//      group's up to 32 entries in order and writes one entry of the next
//      level,
//      or, for the window's last group, its rows of C.  A hub window of a
//      power-law graph's transpose owns tens of thousands of segments; a
//      single block summing them alone would serialise the card again
//      (123 ms on the Amazon replica's transpose at split_blk = 1), the
//      tree spreads that sum over the card in about log32(count) levels.
//      The tree sums in fp64 and keeps its upper levels in fp64, since an
//      fp32 running sum over so many segments drifts by sqrt(count) *
//      2^-24 of its size; the levels are bound by reading the partials.
// The partials are extra traffic the TPU kernel does not have: at
// split_blk = 1 every segment is one K-block, and each (V, N) partial is
// written once and read once.  A zero-length segment (an empty window)
// stores zeros; the dummy block of an all-empty matrix is never visited.
#include "common.cuh"

namespace {

constexpr int kChunk = 32;  // vectors staged in shared memory per step

template <int V>
__global__ void spmm_segment_kernel(const int* __restrict__ seg_win,
                                    const int* __restrict__ seg_meta,
                                    const int* __restrict__ cols,
                                    const float* __restrict__ vals,
                                    const float* __restrict__ b,
                                    float* __restrict__ c,
                                    float* __restrict__ part, int m, int n,
                                    int k_blk, int64_t vals_hstride,
                                    int64_t b_hstride, int64_t num_segments) {
  __shared__ int s_cols[kChunk];
  __shared__ __align__(16) float s_vals[kChunk * V];

  const int64_t s = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int h = blockIdx.z;
  const bool active = col < n;
  const int* meta = seg_meta + s * 4;  // [first block, count, first, last]
  const int64_t t_lo = static_cast<int64_t>(meta[0]) * k_blk;
  const int64_t t_hi = t_lo + static_cast<int64_t>(meta[1]) * k_blk;
  const float* vh = vals + h * vals_hstride;
  const float* bh = b + h * b_hstride;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  for (int64_t t0 = t_lo; t0 < t_hi; t0 += kChunk) {
    const int64_t rest = t_hi - t0;
    const int cnt = rest < kChunk ? static_cast<int>(rest) : kChunk;
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) s_cols[i] = cols[t0 + i];
    for (int i = threadIdx.x; i < cnt * V; i += blockDim.x) {
      s_vals[i] = vh[t0 * V + i];
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int r = 0; r < cnt; ++r) {
        const float bv = __ldg(bh + static_cast<int64_t>(s_cols[r]) * n + col);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(s_vals[r * V + v], bv, acc[v]);
      }
    }
    __syncthreads();
  }

  if (!active) return;
  if (meta[2] && meta[3]) {  // the window's only segment: store C directly
    const int64_t row0 = static_cast<int64_t>(seg_win[s]) * V;
    float* ch = c + static_cast<int64_t>(h) * m * n;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (row0 + v < m) ch[(row0 + v) * n + col] = acc[v];
    }
  } else {
    float* p = part + ((h * num_segments + s) * V) * n + col;
#pragma unroll
    for (int v = 0; v < V; ++v) p[static_cast<int64_t>(v) * n] = acc[v];
  }
}

template <int V, typename Src>
__global__ void spmm_tree_kernel(const int* __restrict__ tree_meta,
                                 int group0, const Src* __restrict__ src,
                                 int64_t src_entries,
                                 double* __restrict__ part2,
                                 int64_t tree_entries, float* __restrict__ c,
                                 int m, int n) {
  const int* g = tree_meta + static_cast<int64_t>(group0 + blockIdx.x) * 4;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int h = blockIdx.z;
  if (col >= n) return;
  const int64_t lo = g[0], hi = lo + g[1];

  double acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0;
#pragma unroll 4
  for (int64_t e = lo; e < hi; ++e) {
    const Src* p = src + ((h * src_entries + e) * V) * n + col;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += p[static_cast<int64_t>(v) * n];
  }
  if (g[3] < 0) {  // the window's last group: its rows of C
    const int64_t row0 = static_cast<int64_t>(g[2]) * V;
    float* ch = c + static_cast<int64_t>(h) * m * n;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (row0 + v < m) ch[(row0 + v) * n + col] = static_cast<float>(acc[v]);
    }
  } else {
    double* q = part2 + ((h * tree_entries + g[3]) * V) * n + col;
#pragma unroll
    for (int v = 0; v < V; ++v) q[static_cast<int64_t>(v) * n] = acc[v];
  }
}

template <int V>
cudaError_t launch(const int* seg_win, const int* seg_meta,
                   const int* tree_meta, const int* cols, const float* vals,
                   const float* b, float* c, float* part, double* part2, int m,
                   int n, int num_segments, int heads, int k_blk, int n_tile,
                   int64_t vals_hstride, int64_t b_hstride,
                   const int* levels, int num_levels, int64_t tree_entries,
                   cudaStream_t stream) {
  const unsigned tiles = (n + n_tile - 1) / n_tile;
  spmm_segment_kernel<V>
      <<<dim3(num_segments, tiles, heads), n_tile, 0, stream>>>(
      seg_win, seg_meta, cols, vals, b, c, part, m, n, k_blk, vals_hstride,
      b_hstride, num_segments);
  cudaError_t err = cudaGetLastError();
  for (int l = 0; l < num_levels && err == cudaSuccess; ++l) {
    const dim3 grid(levels[2 * l + 1], tiles, heads);
    if (l == 0) {
      spmm_tree_kernel<V, float><<<grid, n_tile, 0, stream>>>(
          tree_meta, levels[0], part, num_segments, part2, tree_entries, c, m,
          n);
    } else {
      spmm_tree_kernel<V, double><<<grid, n_tile, 0, stream>>>(
          tree_meta, levels[2 * l], part2, tree_entries, part2, tree_entries,
          c, m, n);
    }
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// seg_win (NS,), seg_meta (NS, 4), tree_meta (G, 4), cols (NNZP,) int32;
// vals (H or 1, NNZP, V) f32, b (H or 1, K, N) f32 row-major, with head
// strides of 0 for a shared operand; c (H, M, N) f32; part (H, NS, V, N)
// f32 and part2 (H, tree_entries, V, N) f64 scratch, null when unused.
// levels: host array of (first group, group count) per tree level.
// n_tile threads per block, a multiple of 32 up to 1024.
extern "C" int spmm_balanced_f32(const void* seg_win, const void* seg_meta,
                                 const void* tree_meta, const void* cols,
                                 const void* vals, const void* b, void* c,
                                 void* part, void* part2, int m, int n,
                                 int num_segments, int heads, int v, int k_blk,
                                 int n_tile, int64_t vals_hstride,
                                 int64_t b_hstride, const void* levels,
                                 int num_levels, int64_t tree_entries,
                                 void* stream) {
  const auto* sw = static_cast<const int*>(seg_win);
  const auto* sm = static_cast<const int*>(seg_meta);
  const auto* tm = static_cast<const int*>(tree_meta);
  const auto* cl = static_cast<const int*>(cols);
  const auto* vl = static_cast<const float*>(vals);
  const auto* bb = static_cast<const float*>(b);
  auto* cc = static_cast<float*>(c);
  auto* pp = static_cast<float*>(part);
  auto* p2 = static_cast<double*>(part2);
  const auto* lv = static_cast<const int*>(levels);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8:
      return launch<8>(sw, sm, tm, cl, vl, bb, cc, pp, p2, m, n, num_segments,
                       heads, k_blk, n_tile, vals_hstride, b_hstride, lv,
                       num_levels, tree_entries, st);
    case 16:
      return launch<16>(sw, sm, tm, cl, vl, bb, cc, pp, p2, m, n,
                        num_segments, heads, k_blk, n_tile, vals_hstride,
                        b_hstride, lv, num_levels, tree_entries, st);
    default:
      return cudaErrorInvalidValue;
  }
}

REPRO_ERROR_STRING(spmm_balanced_error_string)
