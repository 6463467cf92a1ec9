// The window-parallel SpMM kernel, shared by spmm.cu (one head) and
// spmm_batched.cu (a grid of H heads):
// C[h] (M, N) = A[h] (M, K) @ B[h] (K, N), fp32.
//
// Design.  A thread block is G slice groups of n_tile threads; each thread
// owns one output column of the tile and keeps V running sums in
// registers, so C is written once and never read.  A group walks a range
// of one window's vectors in chunks of 32: each of its warps streams the
// chunks' column ids and (32, V) values through a ring of three chunks in
// shared memory of its own, each copied by cp.async through L1 two chunks
// ahead (a chunk costs one warp barrier and no synchronous load; a
// group-wide barrier would need a named barrier per group, which costs
// the SM resident blocks), and each thread reads B[cols[r], col] with
// neighbouring threads on neighbouring columns - one coalesced row
// segment per vector, the paper's memory-efficient thread mapping - with
// the loads unrolled 8 deep.  B rows shared by several windows (hub
// columns) are served from L2.
//
// On the TPU the grid runs in order on one core, so a hub window costs
// only its share of the work.  Here one window on one SM would be a
// serial chain long after every other window is done (the largest window
// of the Amazon replica's transpose holds 50,424 of its 430,067 K-blocks),
// so a host plan (kernels/_window.py) cuts every window of more than
// split_blk K-blocks into ns = ceil(blocks / split_blk) slices of equal
// size (slice i: blocks [i * L / ns, (i + 1) * L / ns) of the window's L)
// and hands them out in a fixed order.  Work item ("task") t of the plan
// is one thread-block cluster of C blocks, C the plan's cluster size (1,
// 2, 4, 8 or 16):
//   * a long window (more than G * split_blk blocks): its slices go to the
//     C * G groups of the cluster, group j = rank * G + g taking slices
//     [j * ns / (C G), (j + 1) * ns / (C G)) in order;
//   * C medium windows (more than split_blk, at most G * split_blk
//     blocks), one per block, its slices on the block's G groups;
//   * a pack of C * G consecutive windows, one per group; a group skips a
//     window of more than split_blk blocks (it has a task of its own).
// Each slice is one fp32 running sum, vector by vector, added into the
// group's sum at the slice's end; the groups' sums of a window meet in
// shared memory and are added in group order, and for a long window the
// blocks' sums meet in distributed shared memory (the cluster's blocks
// read each other's shared memory) and are added by rank 0 in rank order.
// No atomics and no scratch in device memory: every sum is taken in the
// same order on every launch, so two launches give the same bits.  A
// window of at most split_blk K-blocks is one slice walked by one group:
// one running sum in vector order, the arithmetic of the unsplit kernel
// and of spmm_noncoalesced.cu bit for bit.  A plan without split windows
// (every window of the Amazon replica's A) launches a variant without the
// split path in fewer registers: one window per block of a column tile
// wider than a warp, whose warps then share one ring (block barriers), or
// four one-warp windows per block.
//   * A head reads vals and B at its own offset, h * vals_hstride and
//     h * b_hstride; a stride of 0 makes an operand shared by every head,
//     read from one copy.  The per-thread arithmetic does not depend on
//     the head, so H heads in one launch give bitwise the output of H
//     one-head launches.
//   * Padding vectors carry column 0 and value 0 and are multiplied, not
//     skipped, as in the reference.
//   * An empty window stores zeros; the all-empty dummy block belongs to
//     no window and is never visited.
//   * The ragged last column tile is masked; rows >= M of the last window
//     are not written.  One head's B (K x N) and vals (NNZP x V) are
//     indexed in 32 bits (the wrappers check both below 2^31), which
//     keeps the 8 gathers in flight in fewer registers.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {

constexpr int kSpmmChunk = 32;        // vectors per pipeline step
constexpr int kSpmmMaxThreads = 512;  // G * n_tile
constexpr int kSpmmMaxCluster = 16;   // non-portable above 8
constexpr int kSpmmUnroll = 8;        // B gathers in flight per thread

// A ring of three chunks, one per warp (or one per block, see
// kBlockRing): the one being summed, the next (landed) and the one after
// (in flight).
template <int V>
struct WindowRing {
  float vals[3][kSpmmChunk * V];
  int cols[3][kSpmmChunk];
};

// First K-block of slice s of a window of `len` blocks from k_lo, cut
// into ns slices.
__device__ __forceinline__ int slice_start(int k_lo, int len, int ns, int s) {
  return k_lo + static_cast<int>((static_cast<int64_t>(s) * len) / ns);
}

// cp.async of the column ids and values of the chunk of `cnt` vectors at
// t0 into one ring slot, by the `nthr` threads of the ring (thread tid),
// through L1.
template <int V>
__device__ __forceinline__ void issue_chunk(int t0, int cnt, int tid,
                                            int nthr, const int* cols,
                                            const float* vh, bool vec16,
                                            int* sc, float* sv) {
  for (int i = tid; i < cnt; i += nthr) cp_async4(sc + i, cols + t0 + i);
  const float* src = vh + t0 * V;
  if (vec16) {
    for (int i = tid; i < cnt * (V / 4); i += nthr) {
      cp_async16_ca(sv + 4 * i, src + 4 * i);
    }
  } else {
    for (int i = tid; i < cnt * V; i += nthr) cp_async4(sv + i, src + i);
  }
}

// acc[v] += vals[v] * bv for the V values of one vector in shared memory.
template <int V>
__device__ __forceinline__ void fma_vector(float (&acc)[V], const float* vals,
                                           float bv) {
  const float4* a4 = reinterpret_cast<const float4*>(vals);
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 a = a4[q];
    acc[4 * q] = fmaf(a.x, bv, acc[4 * q]);
    acc[4 * q + 1] = fmaf(a.y, bv, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(a.z, bv, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(a.w, bv, acc[4 * q + 3]);
  }
}

// A group walks slices [s_lo, s_hi) of the window of `len` K-blocks at
// k_lo cut into ns slices and adds each slice's running sums into part
// (kFold; without it, one slice whose sum becomes part); this thread takes
// its column, the chunks through its warp's ring, or with kBlockRing (a
// block of one group) through the block's.
template <int V, bool kFold, bool kBlockRing>
__device__ __forceinline__ void walk_slices(
    int k_lo, int len, int ns, int s_lo, int s_hi, int k_blk,
    const int* __restrict__ cols, const float* __restrict__ vh,
    const float* __restrict__ bh, int n, int col, bool active,
    WindowRing<V>& ring, float (&part)[V]) {
  const int tid = kBlockRing ? threadIdx.x : threadIdx.x & 31;
  const int nthr = kBlockRing ? blockDim.x : 32;
  const int t_lo = slice_start(k_lo, len, ns, s_lo) * k_blk;
  const int t_hi = slice_start(k_lo, len, ns, s_hi) * k_blk;
  const int nchunks = (t_hi - t_lo + kSpmmChunk - 1) / kSpmmChunk;
  const bool vec16 = (reinterpret_cast<uintptr_t>(vh) & 15) == 0;
  auto chunk_len = [&](int t0) { return min(t_hi - t0, kSpmmChunk); };
  auto issue = [&](int ci) {
    const int t0 = t_lo + ci * kSpmmChunk;
    issue_chunk<V>(t0, chunk_len(t0), tid, nthr, cols, vh, vec16,
                   ring.cols[ci % 3], ring.vals[ci % 3]);
  };
  if (nchunks > 0) issue(0);
  if (nchunks > 1) issue(1);
  cp_async_commit();

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  int s = s_lo;
  int fold_at = slice_start(k_lo, len, ns, s + 1) * k_blk;
  for (int ci = 0; ci < nchunks; ++ci) {
    // Chunks ci and ci + 1 have landed and the ring's threads are done
    // with chunk ci - 1: its slot takes chunk ci + 2, in flight while ci
    // is summed.
    cp_async_wait_all();
    if (kBlockRing) {
      __syncthreads();
    } else {
      __syncwarp();
    }
    if (ci + 2 < nchunks) issue(ci + 2);
    cp_async_commit();

    const int t0 = t_lo + ci * kSpmmChunk;
    const int cnt = chunk_len(t0);
    const float* sv = ring.vals[ci % 3];
    const int* sc = ring.cols[ci % 3];
    int r0 = 0;
    while (r0 < cnt) {
      const int r1 = kFold ? min(fold_at - t0, cnt) : cnt;
      if (active) {
        int r = r0;
        // 8 gathers in flight, then their products in vector order (the
        // values are read from shared memory one vector at a time, so the
        // registers hold 8 B values, not 8 vectors)
        for (; r + kSpmmUnroll <= r1; r += kSpmmUnroll) {
          float bv[kSpmmUnroll];
#pragma unroll
          for (int u = 0; u < kSpmmUnroll; ++u) {
            bv[u] = __ldg(bh + (sc[r + u] * n + col));
          }
#pragma unroll
          for (int u = 0; u < kSpmmUnroll; ++u) {
            fma_vector<V>(acc, sv + (r + u) * V, bv[u]);
          }
        }
        for (; r < r1; ++r) {
          fma_vector<V>(acc, sv + r * V, __ldg(bh + (sc[r] * n + col)));
        }
      }
      r0 = r1;
      if (kFold && t0 + r1 == fold_at) {  // slice s ends: fold it
#pragma unroll
        for (int v = 0; v < V; ++v) {
          part[v] += acc[v];
          acc[v] = 0.f;
        }
        ++s;
        fold_at = slice_start(k_lo, len, ns, s + 1) * k_blk;
      }
    }
  }
  if (!kFold) {  // one slice: its running sum is the result
#pragma unroll
    for (int v = 0; v < V; ++v) part[v] = acc[v];
  }
}

// Stores the V rows of window w at column col of C (rows < m).
template <int V>
__device__ __forceinline__ void store_rows(float* ch, int w, int m, int n,
                                           int col, const float (&x)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int row = w * V + v;
    if (row < m) ch[static_cast<int64_t>(row) * n + col] = x[v];
  }
}

// Arguments of both variants of the kernel.
struct WindowArgs {
  const int* win_ptr;
  const int* cols;
  const float* vals;
  const float* b;
  float* c;
  const int* split_ids;  // the plan's long windows, then its medium ones
  int m, n, num_windows, k_blk, n_tile, groups, cluster, split_blk;
  int num_long, num_medium;
  int64_t vals_hstride, b_hstride;
};

// One block of G groups of n_tile threads per (task rank, column tile,
// head); the grid's x is tasks * cluster, clusters along x.  kSplit false:
// a plan without split windows, every task a pack, in fewer registers;
// kBlockRing: its block is one group that shares one ring.
template <int V, bool kSplit, bool kBlockRing>
__global__ void __launch_bounds__(kSpmmMaxThreads,
                                  kSplit || V == 16 ? 2 : 3)
spmm_window_kernel(const WindowArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int g = threadIdx.x / a.n_tile;
  const int gt = threadIdx.x - g * a.n_tile;
  const int col = blockIdx.y * a.n_tile + gt;
  const int64_t h = blockIdx.z;
  const bool active = col < a.n;
  const float* vh = a.vals + h * a.vals_hstride;
  const float* bh = a.b + h * a.b_hstride;
  float* ch = a.c + h * static_cast<int64_t>(a.m) * a.n;
  const int nwarps = blockDim.x >> 5;
  auto* rings = reinterpret_cast<WindowRing<V>*>(smem);
  WindowRing<V>& ring = rings[kBlockRing ? 0 : threadIdx.x >> 5];
  const int cluster = kSplit ? a.cluster : 1;
  const int task = blockIdx.x / cluster;
  const int rank = blockIdx.x - task * cluster;
  const int num_long = kSplit ? a.num_long : 0;
  const int medium_tasks = kSplit ? (a.num_medium + cluster - 1) / cluster : 0;

  float part[V];
#pragma unroll
  for (int v = 0; v < V; ++v) part[v] = 0.f;

  if (task >= num_long + medium_tasks) {  // a pack: one window per group
    const int w =
        ((task - num_long - medium_tasks) * cluster + rank) * a.groups + g;
    if (w >= a.num_windows) return;  // the group leaves; no barrier follows
    const int k_lo = a.win_ptr[w];
    const int len = a.win_ptr[w + 1] - k_lo;
    if (kSplit && len > a.split_blk) return;  // its own task
    walk_slices<V, false, kBlockRing>(k_lo, len, 1, 0, 1, a.k_blk, a.cols,
                                      vh, bh, a.n, col, active, ring, part);
    if (active) store_rows<V>(ch, w, a.m, a.n, col, part);
    return;
  }
  if constexpr (kSplit) {
    const bool is_long = task < num_long;
    int idx = task;
    if (!is_long) {
      idx = num_long + (task - num_long) * cluster + rank;
      if (idx >= num_long + a.num_medium) return;  // the whole block leaves
    }
    const int w = a.split_ids[idx];
    const int k_lo = a.win_ptr[w];
    const int len = a.win_ptr[w + 1] - k_lo;
    const int ns = (len + a.split_blk - 1) / a.split_blk;
    const int tg = is_long ? cluster * a.groups : a.groups;
    const int j = is_long ? rank * a.groups + g : g;
    walk_slices<V, true, false>(k_lo, len, ns,
                                static_cast<int>((int64_t(j) * ns) / tg),
                                static_cast<int>((int64_t(j + 1) * ns) / tg),
                                a.k_blk, a.cols, vh, bh, a.n, col, active,
                                ring, part);

    // The block's sum, in group order: thread (g, gt) adds rows v = g,
    // g + G, ... of its column over the groups.
    float* red = reinterpret_cast<float*>(rings + nwarps);  // (G, V, n_tile)
    const int nt = a.n_tile;
#pragma unroll
    for (int v = 0; v < V; ++v) red[(g * V + v) * nt + gt] = part[v];
    __syncthreads();
    for (int v = g; v < V; v += a.groups) {
      float s = red[v * nt + gt];
      for (int g2 = 1; g2 < a.groups; ++g2) s += red[(g2 * V + v) * nt + gt];
      if (!is_long) {
        const int row = w * V + v;
        if (active && row < a.m) {
          ch[static_cast<int64_t>(row) * a.n + col] = s;
        }
      } else {
        red[v * nt + gt] = s;
      }
    }
    if (!is_long) return;

    // A long window: rank 0 adds the blocks' sums in rank order, reading
    // them from the other blocks' shared memory.  The second barrier keeps
    // every block's shared memory alive until rank 0 has read it.
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (rank == 0) {
      for (int v = g; v < V; v += a.groups) {
        float s = red[v * nt + gt];
        for (int r = 1; r < cluster; ++r) {
          s += cl.map_shared_rank(red, r)[v * nt + gt];
        }
        const int row = w * V + v;
        if (active && row < a.m) {
          ch[static_cast<int64_t>(row) * a.n + col] = s;
        }
      }
    }
    cl.sync();
  }
}

// Launches the kernel over `heads` heads on `stream`.  win_ptr (W + 1,)
// int32, cols (NNZP,) int32, vals (NNZP, V) f32 per head or shared, b
// (K, N) f32 row-major per head or shared, c (heads, M, N) f32 row-major,
// split_ids (num_long + num_medium,) int32 or null when both are 0.  A
// block is `groups` groups of n_tile threads (n_tile a multiple of 32,
// groups * n_tile at most 512); `cluster` blocks form one cluster.  A
// cluster size or shared-memory size the card refuses is returned as the
// launch's error.
inline cudaError_t launch_spmm_window(
    const void* win_ptr, const void* cols, const void* vals, const void* b,
    void* c, const void* split_ids, int m, int n, int num_windows, int heads,
    int v, int k_blk, int n_tile, int groups, int cluster, int split_blk,
    int num_long, int num_medium, int64_t vals_hstride, int64_t b_hstride,
    void* stream) {
  if (n_tile % 32 != 0 || groups < 1 || groups * n_tile > kSpmmMaxThreads ||
      cluster < 1 || cluster > kSpmmMaxCluster || split_blk < 1 ||
      (num_long > 0 && cluster < 2)) {
    return cudaErrorInvalidValue;
  }
  const bool split = num_long + num_medium > 0;
  // a plan without split windows and a block of one group of several
  // warps: one ring for the block
  const bool block_ring = !split && n_tile > 32;
  if (block_ring && groups != 1) return cudaErrorInvalidValue;
  const int64_t medium_tasks = (num_medium + cluster - 1) / cluster;
  const int64_t pack = static_cast<int64_t>(cluster) * groups;
  const int64_t tasks =
      num_long + medium_tasks + (num_windows + pack - 1) / pack;
  if (tasks * cluster > 0x7fffffff) return cudaErrorInvalidValue;

  const WindowArgs args{static_cast<const int*>(win_ptr),
                        static_cast<const int*>(cols),
                        static_cast<const float*>(vals),
                        static_cast<const float*>(b),
                        static_cast<float*>(c),
                        static_cast<const int*>(split_ids),
                        m, n, num_windows, k_blk, n_tile, groups, cluster,
                        split_blk, num_long, num_medium, vals_hstride,
                        b_hstride};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tasks * cluster),
                     (n + n_tile - 1) / n_tile, heads);
  cfg.blockDim = dim3(groups * n_tile);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  }
  auto run = [&](auto kernel, size_t ring_bytes) {
    // a ring per warp (or one for the block), and for split windows the
    // groups' sums
    cfg.dynamicSmemBytes = (block_ring ? 1 : groups * n_tile / 32) *
                               ring_bytes +
                           (split ? sizeof(float) * groups * v * n_tile : 0);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(cfg.dynamicSmemBytes));
    if (err == cudaSuccess && cluster > 8) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args);
    if (err != cudaSuccess) cudaGetLastError();  // leave no sticky error
    return err;
  };
  if (v == 8) {
    constexpr size_t ring = sizeof(WindowRing<8>);
    if (split) return run(spmm_window_kernel<8, true, false>, ring);
    if (block_ring) return run(spmm_window_kernel<8, false, true>, ring);
    return run(spmm_window_kernel<8, false, false>, ring);
  }
  if (v == 16) {
    constexpr size_t ring = sizeof(WindowRing<16>);
    if (split) return run(spmm_window_kernel<16, true, false>, ring);
    if (block_ring) return run(spmm_window_kernel<16, false, true>, ring);
    return run(spmm_window_kernel<16, false, false>, ring);
  }
  return cudaErrorInvalidValue;
}

}  // namespace repro
