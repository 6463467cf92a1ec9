// Load-balanced SpMM over a block-parallel Schedule cut into runs:
// C[h] (M, N) = A[h] (M, K) @ B[h] (K, N), fp32, for H heads, each of vals
// and B either per head or shared by all heads.
//
// Replaces: src/repro/kernels/spmm_pallas.py, _balanced_spmm_kernel
// (launched through spmm_pallas_balanced).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is vals (NNZP x V per distinct head) + cols (NNZP) + B (K x N per
// distinct head) + the run plan (run_ptr, pieces) + C (H x M x N): on the
// Amazon replica's A at N = 128, 483 MB, 0.144 ms at 3.35 TB/s, against
// 2 * nnz * N = 0.87 GFLOP, 0.013 ms at the 67 TFLOP/s fp32 rate.
//
// Design.  The TPU kernel runs the schedule's segments on a sequential
// grid and carries a window's accumulator from one segment to the next in
// VMEM.  CUDA blocks run in no order, so the carry lives inside a block:
//   1. run pass: kernels/_combine.py cuts the schedule's segments, in
//      order, into runs of about run_blk K-blocks (cut only at segment
//      boundaries, near a window boundary where one is close).  One thread
//      block per (run, column tile, head) walks its run's K-blocks in
//      order, each thread on one output column with the V accumulators in
//      registers.  A run is a list of pieces, one per window it touches;
//      at the end of a piece the block stores the window's rows of C when
//      the run holds the whole window, and otherwise writes one fp32
//      (V, N) partial to the piece's edge entry.  So a run leaves partials
//      for at most two windows, the one cut at its start and the one cut
//      at its end.  The run's (cols, vals) stream through a ring of three
//      chunks of 32 vectors in shared memory, each copied by cp.async two
//      chunks ahead, so a chunk costs one barrier and no synchronous
//      load; each thread gathers its column of the chunk's
//      B rows with loads unrolled 8 deep.  (Staging the gathered B rows
//      through shared memory by cp.async one chunk ahead was slower on the
//      card, and an L2 prefetch of the next chunk's lines gained nothing.)
//      Each chunk's fp32 sum of at most 32 products is folded into fp64
//      accumulators: a run of 32 K-blocks, or an unsplit hub window of
//      400,000 vectors, then drifts no more than one chunk does (an fp32
//      running sum over a run drifts by about sqrt(length) * 2^-24 of the
//      run's size, beyond the kernel tolerance on the hub rows of a
//      power-law graph's transpose).
//   2. combine tree: the edge entries of each window that runs cut are
//      summed by a tree of groups (tree_meta, from kernels/_combine.py),
//      one level per launch: one thread block per (group, column tile,
//      head) adds the group's up to 32 entries in order and writes one
//      entry of the next level, or, for the window's last group, its rows
//      of C.  The tree sums in fp64 and keeps its upper levels in fp64: a
//      hub window of a power-law graph's transpose is cut into thousands
//      of runs, and an fp32 sum over so many entries drifts by
//      sqrt(count) * 2^-24 of its size.
// No atomics: every sum is taken in a fixed order, so the result is the
// same bits from run to run.  The partials are the traffic the TPU kernel
// does not have.  A pass per segment would write one for every segment of
// a split window: at split_blk = 1 on the Amazon replica and N = 128, one
// (8, 128) fp32 partial for each of A's 227,197 such segments (0.93 GB
// written and read back) and of Aᵀ's 388,828 (1.59 GB).  Runs of 32
// K-blocks leave none on A (its windows hold at most 7 K-blocks, and runs
// end at window boundaries) and 11,366 on Aᵀ (47 MB, 34x fewer); phase 5
// of chip_smoke.py prints them for every plan.  A zero-length piece (an
// empty window) stores zeros; the dummy block of an all-empty matrix is
// never visited.
#include "common.cuh"

namespace {

constexpr int kChunk = 32;     // vectors per pipeline step
constexpr int kThreads = 256;  // most threads per block (column tile)

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The state of a run: the current piece, where it ends (in vectors), and
// the V accumulators of this thread's column (fp64: each step's fp32 sum of
// at most 32 products is folded in, so a long run does not drift).
template <int V>
struct Run {
  const int* pieces;
  int p, p_hi;
  int64_t p_end;
  double acc[V];
};

__device__ __forceinline__ int64_t piece_end(const int* pieces, int p,
                                             int k_blk) {
  return (static_cast<int64_t>(pieces[4 * p + 1]) + pieces[4 * p + 2]) * k_blk;
}

// Vectors of the chunk that starts at t0 (at most kChunk, the run ends at
// t_hi).
__device__ __forceinline__ int chunk_len(int64_t t0, int64_t t_hi) {
  return t_hi - t0 < kChunk ? static_cast<int>(t_hi - t0) : kChunk;
}

// Stores every piece that ends at or before vector t: the window's rows of
// C when the run holds the whole window, else its edge entry of part; and
// zeroes the accumulators for the next.
template <int V>
__device__ __forceinline__ void flush_upto(Run<V>& run, int64_t t, int k_blk,
                                           bool active, float* c, float* part,
                                           int64_t h, int m, int n, int col,
                                           int64_t entries) {
  while (run.p < run.p_hi && run.p_end <= t) {
    const int* pm = run.pieces + 4 * run.p;
    if (active) {
      if (pm[3] < 0) {
        const int64_t row0 = static_cast<int64_t>(pm[0]) * V;
        float* ch = c + (h * m + row0) * n + col;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (row0 + v < m) {
            ch[v * static_cast<int64_t>(n)] = static_cast<float>(run.acc[v]);
          }
        }
      } else {
        float* q = part + ((h * entries + pm[3]) * V) * n + col;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          q[v * static_cast<int64_t>(n)] = static_cast<float>(run.acc[v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) run.acc[v] = 0.0;
    if (++run.p < run.p_hi) run.p_end = piece_end(run.pieces, run.p, k_blk);
  }
}

// cp.async of chunk ci's column ids and values (16 bytes at a time when
// vals is 16-byte aligned; V is 8 or 16, so every chunk then is).
template <int V>
__device__ __forceinline__ void issue_index(int ci, int64_t t_lo,
                                            int64_t t_hi, const int* cols,
                                            const float* vh, bool vec16,
                                            int* sc, float* sv) {
  const int64_t t0 = t_lo + static_cast<int64_t>(ci) * kChunk;
  const int cnt = chunk_len(t0, t_hi);
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    cp_async4(sc + i, cols + t0 + i);
  }
  const float* src = vh + t0 * V;
  if (vec16) {
    for (int i = threadIdx.x; i < cnt * (V / 4); i += blockDim.x) {
      cp_async16(sv + 4 * i, src + 4 * i);
    }
  } else {
    for (int i = threadIdx.x; i < cnt * V; i += blockDim.x) {
      cp_async4(sv + i, src + i);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
spmm_run_kernel(const int* __restrict__ run_ptr, const int* __restrict__ pieces,
                const int* __restrict__ cols, const float* __restrict__ vals,
                const float* __restrict__ b, float* __restrict__ c,
                float* __restrict__ part, int m, int n, int k_blk,
                int64_t vals_hstride, int64_t b_hstride, int64_t entries) {
  // Column ids and values of three chunks: the one being summed, the next
  // (landed) and the one after (in flight).
  __shared__ __align__(16) float s_vals[3][kChunk * V];
  __shared__ int s_cols[3][kChunk];

  const int nt = blockDim.x, tid = threadIdx.x;
  const int col = blockIdx.y * nt + tid;
  const int64_t h = blockIdx.z;
  const bool active = col < n;
  const float* vh = vals + h * vals_hstride;
  const float* bh = b + h * b_hstride;
  Run<V> run;
  run.pieces = pieces;
  run.p = run_ptr[blockIdx.x];
  run.p_hi = run_ptr[blockIdx.x + 1];
  const int64_t t_lo = static_cast<int64_t>(pieces[4 * run.p + 1]) * k_blk;
  const int64_t t_hi = piece_end(pieces, run.p_hi - 1, k_blk);
  const int nchunks = static_cast<int>((t_hi - t_lo + kChunk - 1) / kChunk);
  run.p_end = piece_end(pieces, run.p, k_blk);
#pragma unroll
  for (int v = 0; v < V; ++v) run.acc[v] = 0.0;
  const bool vec16 = (reinterpret_cast<uintptr_t>(vh) & 15) == 0;

  auto issue = [&](int ci) {
    issue_index<V>(ci, t_lo, t_hi, cols, vh, vec16, s_cols[ci % 3],
                   s_vals[ci % 3]);
  };
  if (nchunks > 0) issue(0);
  if (nchunks > 1) issue(1);
  cp_async_commit();
  flush_upto<V>(run, t_lo, k_blk, active, c, part, h, m, n, col, entries);
  for (int ci = 0; ci < nchunks; ++ci) {
    // Chunks ci and ci + 1 have landed and every thread is done with chunk
    // ci - 1: refill its slot with chunk ci + 2, which stays in flight
    // while chunk ci is summed.
    cp_async_wait_all();
    __syncthreads();
    if (ci + 2 < nchunks) issue(ci + 2);
    cp_async_commit();

    const int64_t t0 = t_lo + static_cast<int64_t>(ci) * kChunk;
    const int cnt = chunk_len(t0, t_hi);
    const float* sv = s_vals[ci % 3];
    const int* sc = s_cols[ci % 3];
    int r0 = 0;
    while (r0 < cnt && run.p < run.p_hi) {
      const int64_t to_end = run.p_end - t0;
      const int r1 = to_end < cnt ? static_cast<int>(to_end) : cnt;
      if (active) {
        float cs[V];
#pragma unroll
        for (int v = 0; v < V; ++v) cs[v] = 0.f;
#pragma unroll 8
        for (int r = r0; r < r1; ++r) {
          const float bv = __ldg(bh + static_cast<int64_t>(sc[r]) * n + col);
          const float4* a4 = reinterpret_cast<const float4*>(sv + r * V);
#pragma unroll
          for (int q = 0; q < V / 4; ++q) {
            const float4 a = a4[q];
            cs[4 * q] = fmaf(a.x, bv, cs[4 * q]);
            cs[4 * q + 1] = fmaf(a.y, bv, cs[4 * q + 1]);
            cs[4 * q + 2] = fmaf(a.z, bv, cs[4 * q + 2]);
            cs[4 * q + 3] = fmaf(a.w, bv, cs[4 * q + 3]);
          }
        }
#pragma unroll
        for (int v = 0; v < V; ++v) run.acc[v] += cs[v];
      }
      r0 = r1;
      flush_upto<V>(run, t0 + r1, k_blk, active, c, part, h, m, n, col,
                    entries);
    }
  }
  flush_upto<V>(run, t_hi, k_blk, active, c, part, h, m, n, col, entries);
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
cudaError_t launch(const int* run_ptr, const int* pieces, const int* tree_meta,
                   const int* cols, const float* vals, const float* b,
                   float* c, float* part, double* part2, int m, int n,
                   int num_runs, int heads, int k_blk, int n_tile,
                   int64_t vals_hstride, int64_t b_hstride, const int* levels,
                   int num_levels, int64_t entries, int64_t tree_entries,
                   cudaStream_t stream) {
  if (n_tile > kThreads) return cudaErrorInvalidValue;
  const unsigned tiles = (n + n_tile - 1) / n_tile;
  spmm_run_kernel<V><<<dim3(num_runs, tiles, heads), n_tile, 0, stream>>>(
      run_ptr, pieces, cols, vals, b, c, part, m, n, k_blk, vals_hstride,
      b_hstride, entries);
  cudaError_t err = cudaGetLastError();
  for (int l = 0; l < num_levels && err == cudaSuccess; ++l) {
    const dim3 grid(levels[2 * l + 1], tiles, heads);
    if (l == 0) {
      spmm_tree_kernel<V, float><<<grid, n_tile, 0, stream>>>(
          tree_meta, levels[0], part, entries, part2, tree_entries, c, m, n);
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

// run_ptr (NR + 1,), pieces (P, 4), tree_meta (G, 4), cols (NNZP,) int32;
// vals (H or 1, NNZP, V) f32, b (H or 1, K, N) f32 row-major, with head
// strides of 0 for a shared operand; c (H, M, N) f32; part (H, entries, V,
// N) f32 and part2 (H, tree_entries, V, N) f64 scratch, null when unused.
// levels: host array of (first group, group count) per tree level.
// n_tile threads per block, a multiple of 32 up to 256.
extern "C" int spmm_balanced_f32(const void* run_ptr, const void* pieces,
                                 const void* tree_meta, const void* cols,
                                 const void* vals, const void* b, void* c,
                                 void* part, void* part2, int m, int n,
                                 int num_runs, int heads, int v, int k_blk,
                                 int n_tile, int64_t vals_hstride,
                                 int64_t b_hstride, const void* levels,
                                 int num_levels, int64_t entries,
                                 int64_t tree_entries, void* stream) {
  const auto* rp = static_cast<const int*>(run_ptr);
  const auto* pc = static_cast<const int*>(pieces);
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
      return launch<8>(rp, pc, tm, cl, vl, bb, cc, pp, p2, m, n, num_runs,
                       heads, k_blk, n_tile, vals_hstride, b_hstride, lv,
                       num_levels, entries, tree_entries, st);
    case 16:
      return launch<16>(rp, pc, tm, cl, vl, bb, cc, pp, p2, m, n, num_runs,
                        heads, k_blk, n_tile, vals_hstride, b_hstride, lv,
                        num_levels, entries, tree_entries, st);
    default:
      return cudaErrorInvalidValue;
  }
}

REPRO_ERROR_STRING(spmm_balanced_error_string)
