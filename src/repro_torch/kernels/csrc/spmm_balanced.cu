// Load-balanced SpMM over a block-parallel Schedule cut into runs:
// C[h] (M, N) = A[h] (M, K) @ B[h] (K, N) for H heads, each of vals and B
// either per head or shared by all heads, with fp32 values and B, bf16
// values and B, or int8 values (shared by the heads, one fp32 scale per
// K-block) with fp32 or bf16 B; C in B's type.
//
// Replaces: src/repro/kernels/spmm_pallas.py, _balanced_spmm_kernel
// (launched through spmm_pallas_balanced), with its precision variants
// (bf16, and int8 through `quantized`, spmm_pallas.py:511).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is vals (NNZP x V per distinct head) + cols (NNZP) + B (K x N per
// distinct head) + the run plan (run_ptr, pieces) + C (H x M x N): on the
// Amazon replica's A at N = 128, 483 MB, 0.144 ms at 3.35 TB/s, against
// 2 * nnz * N = 0.87 GFLOP, 0.013 ms at the 67 TFLOP/s fp32 rate.  bf16
// halves the bytes of vals, B and C (243 MB, 0.073 ms there), int8
// quarters those of vals and adds a 4-byte scale per K-block.
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
// Precision: every operand is widened to fp32 as it is read (the ring and
// the B loads of spmm_window.cuh), the products and the chunk sums are
// fp32 and the folds, partials and tree those of the fp32 kernel, and C is
// rounded to B's type once, from the fp32 value the fp32 kernel stores:
// the bf16 result is the fp32 kernel's on the widened operands, rounded,
// bit for bit.  int8 values and their K-block scales land by cp.async and
// each landed chunk is dequantized once, q * scale in fp32, into an fp32
// slot of the ring (WindowRing, as in the window SpMM: a conversion by
// every column thread ran that kernel 2.1x slower and spilled), so the
// int8 result is the fp32 kernel's on the q * scale values.  16-byte
// copies need k_blk * V * sizeof(value) % 16 == 0 (every chunk then starts
// and ends on 16 bytes); otherwise 4-byte copies (fp32) or plain loads.
#include "spmm_window.cuh"

namespace {

constexpr int kChunk = repro::kSpmmChunk;  // vectors per pipeline step
constexpr int kThreads = 256;  // most threads per block (column tile)

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::from_f32;
using repro::load_b;
using repro::WindowRing;

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
// C when the run holds the whole window (the fp32 sum, rounded to Tb), else
// its fp32 edge entry of part; and zeroes the accumulators for the next.
template <int V, typename Tb>
__device__ __forceinline__ void flush_upto(Run<V>& run, int64_t t, int k_blk,
                                           bool active, Tb* c, float* part,
                                           int64_t h, int m, int n, int col,
                                           int64_t entries) {
  while (run.p < run.p_hi && run.p_end <= t) {
    const int* pm = run.pieces + 4 * run.p;
    if (active) {
      if (pm[3] < 0) {
        const int64_t row0 = static_cast<int64_t>(pm[0]) * V;
        Tb* ch = c + (h * m + row0) * n + col;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (row0 + v < m) {
            ch[v * static_cast<int64_t>(n)] =
                from_f32<Tb>(static_cast<float>(run.acc[v]));
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

// Copies of chunk ci's column ids, values (16 bytes at a time when vec16)
// and, for int8 values, each vector's K-block scale into one ring slot.
template <int V, typename Tv>
__device__ __forceinline__ void issue_index(int ci, int64_t t_lo,
                                            int64_t t_hi, int k_blk,
                                            const int* cols, const Tv* vh,
                                            const float* scales, bool vec16,
                                            WindowRing<V, Tv>& ring) {
  const int64_t t0 = t_lo + static_cast<int64_t>(ci) * kChunk;
  const int cnt = chunk_len(t0, t_hi);
  int* sc = ring.cols[ci % 3];
  Tv* sv = ring.vals[ci % 3];
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    cp_async4(sc + i, cols + t0 + i);
  }
  const Tv* src = vh + t0 * V;
  constexpr int kPer16 = 16 / sizeof(Tv);
  if (vec16) {  // cnt * V is then a multiple of kPer16
    for (int i = threadIdx.x; i < cnt * V / kPer16; i += blockDim.x) {
      cp_async16(sv + kPer16 * i, src + kPer16 * i);
    }
  } else if constexpr (sizeof(Tv) == 4) {
    for (int i = threadIdx.x; i < cnt * V; i += blockDim.x) {
      cp_async4(sv + i, src + i);
    }
  } else {  // ordered by the barrier before the chunk is summed
    for (int i = threadIdx.x; i < cnt * V; i += blockDim.x) sv[i] = src[i];
  }
  if constexpr (std::is_same<Tv, int8_t>::value) {
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      cp_async4(ring.scl[ci % 3] + i, scales + (t0 + i) / k_blk);
    }
  }
}

template <int V, typename Tv, typename Tb>
__global__ void __launch_bounds__(kThreads)
spmm_run_kernel(const int* __restrict__ run_ptr, const int* __restrict__ pieces,
                const int* __restrict__ cols, const Tv* __restrict__ vals,
                const float* __restrict__ scales, const Tb* __restrict__ b,
                Tb* __restrict__ c, float* __restrict__ part, int m, int n,
                int k_blk, int64_t vals_hstride, int64_t b_hstride,
                int64_t entries) {
  // Column ids and values of three chunks: the one being summed, the next
  // (landed) and the one after (in flight); int8 values also their scales
  // and the fp32 values of the first two.
  __shared__ __align__(16) WindowRing<V, Tv> ring;
  constexpr bool kInt8 = std::is_same<Tv, int8_t>::value;

  const int nt = blockDim.x, tid = threadIdx.x;
  const int col = blockIdx.y * nt + tid;
  const int64_t h = blockIdx.z;
  const bool active = col < n;
  const Tv* vh = vals + h * vals_hstride;
  const Tb* bh = b + h * b_hstride;
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
  // chunks start at K-block boundaries (or 32 vectors after one), so every
  // chunk's values are 16-byte aligned when a K-block's are
  const bool vec16 = (reinterpret_cast<uintptr_t>(vh) & 15) == 0 &&
                     (k_blk * V * sizeof(Tv)) % 16 == 0;

  auto issue = [&](int ci) {
    issue_index<V, Tv>(ci, t_lo, t_hi, k_blk, cols, vh, scales, vec16, ring);
  };
  if (nchunks > 0) issue(0);
  if (nchunks > 1) issue(1);
  cp_async_commit();
  if constexpr (kInt8) {  // chunk 0 in fp32 before the loop
    if (nchunks > 0) {
      cp_async_wait_all();
      __syncthreads();
      ring.dequantize(0, chunk_len(t_lo, t_hi), tid, nt);
    }
  }
  flush_upto<V>(run, t_lo, k_blk, active, c, part, h, m, n, col, entries);
  for (int ci = 0; ci < nchunks; ++ci) {
    // Chunks ci and ci + 1 have landed and every thread is done with chunk
    // ci - 1: refill its slot with chunk ci + 2, which stays in flight
    // while chunk ci is summed.  (int8: chunk ci's fp32 values, written
    // before the barrier, are visible; chunk ci + 1 is dequantized into the
    // other fp32 slot, read last before the barrier.)
    cp_async_wait_all();
    __syncthreads();
    if (ci + 2 < nchunks) issue(ci + 2);
    cp_async_commit();

    const int64_t t0 = t_lo + static_cast<int64_t>(ci) * kChunk;
    if constexpr (kInt8) {
      if (ci + 1 < nchunks) {
        ring.dequantize(ci + 1, chunk_len(t0 + kChunk, t_hi), tid, nt);
      }
    }
    const int cnt = chunk_len(t0, t_hi);
    const auto* sv = ring.chunk(ci);
    const int* sc = ring.cols[ci % 3];
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
          const float bv[1] = {load_b(bh + static_cast<int64_t>(sc[r]) * n + col)};
          repro::fma_vector<V, 1>(cs, sv + r * V, bv);
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

template <int V, typename Src, typename Tb>
__global__ void spmm_tree_kernel(const int* __restrict__ tree_meta,
                                 int group0, const Src* __restrict__ src,
                                 int64_t src_entries,
                                 double* __restrict__ part2,
                                 int64_t tree_entries, Tb* __restrict__ c,
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
    Tb* ch = c + static_cast<int64_t>(h) * m * n;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (row0 + v < m) {
        ch[(row0 + v) * n + col] = from_f32<Tb>(static_cast<float>(acc[v]));
      }
    }
  } else {
    double* q = part2 + ((h * tree_entries + g[3]) * V) * n + col;
#pragma unroll
    for (int v = 0; v < V; ++v) q[static_cast<int64_t>(v) * n] = acc[v];
  }
}

template <int V, typename Tv, typename Tb>
cudaError_t launch(const int* run_ptr, const int* pieces, const int* tree_meta,
                   const int* cols, const void* vals, const float* scales,
                   const void* b, void* c, float* part, double* part2, int m,
                   int n, int num_runs, int heads, int k_blk, int n_tile,
                   int64_t vals_hstride, int64_t b_hstride, const int* levels,
                   int num_levels, int64_t entries, int64_t tree_entries,
                   cudaStream_t stream) {
  if (n_tile > kThreads) return cudaErrorInvalidValue;
  if (std::is_same<Tv, int8_t>::value && (scales == nullptr || vals_hstride)) {
    return cudaErrorInvalidValue;  // int8 values: shared, with scales
  }
  const unsigned tiles = (n + n_tile - 1) / n_tile;
  Tb* cc = static_cast<Tb*>(c);
  spmm_run_kernel<V, Tv, Tb><<<dim3(num_runs, tiles, heads), n_tile, 0,
                               stream>>>(
      run_ptr, pieces, cols, static_cast<const Tv*>(vals), scales,
      static_cast<const Tb*>(b), cc, part, m, n, k_blk, vals_hstride,
      b_hstride, entries);
  cudaError_t err = cudaGetLastError();
  for (int l = 0; l < num_levels && err == cudaSuccess; ++l) {
    const dim3 grid(levels[2 * l + 1], tiles, heads);
    if (l == 0) {
      spmm_tree_kernel<V, float, Tb><<<grid, n_tile, 0, stream>>>(
          tree_meta, levels[0], part, entries, part2, tree_entries, cc, m, n);
    } else {
      spmm_tree_kernel<V, double, Tb><<<grid, n_tile, 0, stream>>>(
          tree_meta, levels[2 * l], part2, tree_entries, part2, tree_entries,
          cc, m, n);
    }
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// run_ptr (NR + 1,), pieces (P, 4), tree_meta (G, 4), cols (NNZP,) int32;
// vals (H or 1, NNZP, V) of vals_type (0 f32, 1 bf16, 2 int8; int8 shared
// by the heads), scales (NB,) f32 (int8 values only), b (H or 1, K, N) of
// b_type (0 f32, 1 bf16) row-major, with head strides of 0 for a shared
// operand; c (H, M, N) of b_type; part (H, entries, V, N) f32 and part2
// (H, tree_entries, V, N) f64 scratch, null when unused.  levels: host
// array of (first group, group count) per tree level.  n_tile threads per
// block, a multiple of 32 up to 256.
extern "C" int spmm_balanced_launch(const void* run_ptr, const void* pieces,
                                    const void* tree_meta, const void* cols,
                                    const void* vals, const void* scales,
                                    const void* b, void* c, void* part,
                                    void* part2, int m, int n, int num_runs,
                                    int heads, int v, int k_blk, int n_tile,
                                    int64_t vals_hstride, int64_t b_hstride,
                                    const void* levels, int num_levels,
                                    int64_t entries, int64_t tree_entries,
                                    int vals_type, int b_type, void* stream) {
  auto run = [&](auto vt, auto tv, auto tb) {
    constexpr int V = decltype(vt)::value;
    return launch<V, decltype(tv), decltype(tb)>(
        static_cast<const int*>(run_ptr), static_cast<const int*>(pieces),
        static_cast<const int*>(tree_meta), static_cast<const int*>(cols),
        vals, static_cast<const float*>(scales), b, c,
        static_cast<float*>(part), static_cast<double*>(part2), m, n,
        num_runs, heads, k_blk, n_tile, vals_hstride, b_hstride,
        static_cast<const int*>(levels), num_levels, entries, tree_entries,
        static_cast<cudaStream_t>(stream));
  };
  auto by_type = [&](auto vt) {
    if (vals_type == 0 && b_type == 0) return run(vt, float{}, float{});
    if (vals_type == 1 && b_type == 1) {
      return run(vt, __nv_bfloat16{}, __nv_bfloat16{});
    }
    if (vals_type == 2 && b_type == 0) return run(vt, int8_t{}, float{});
    if (vals_type == 2 && b_type == 1) {
      return run(vt, int8_t{}, __nv_bfloat16{});
    }
    return cudaErrorInvalidValue;
  };
  if (v == 8) return by_type(std::integral_constant<int, 8>{});
  if (v == 16) return by_type(std::integral_constant<int, 16>{});
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(spmm_balanced_error_string)
