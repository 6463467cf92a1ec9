// The window-parallel SpMM kernel, shared by spmm.cu (one head) and
// spmm_batched.cu (a grid of H heads):
// C[h] (M, N) = A[h] (M, K) @ B[h] (K, N), templated on the value type Tv
// (float, bf16, or int8 with one fp32 scale per K-block), B's type Tb
// (float or bf16, also C's) and the index type of one head's B and vals.
//
// Design.  A thread block is G slice groups, each one column tile of
// n_tile columns; each thread owns kCols adjacent output columns of the
// tile (kCols = 2 for bf16 B, see below, else 1) and keeps kCols * V
// running sums in registers, so C is written once and never read.  A group walks a range
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
//     indexed in 32 bits (Idx = int), which keeps the 8 gathers in flight
//     in fewer registers; the wrappers choose the 64-bit instantiation
//     (Idx = int64_t) only when one of them reaches 2^31 elements.
//   * Two columns a thread (bf16 B, a plan without split windows and a
//     tile of at least 64 columns): a thread reads its two columns of a B
//     row with one 32-bit load (two 16-bit loads where a pair is not
//     4-byte aligned: odd N, or the last column of a ragged tile), so a
//     warp still reads a 128-byte row segment with one instruction, and
//     each value read from the ring (and each bf16 value unpacked) serves
//     two products.  Every column's running sum takes the same products in
//     the same order as with one column a thread, so the results are the
//     same bits.  A split plan keeps one column a thread: half the threads
//     would walk each hub window's slices, twice the chain each (on an
//     H100, Amazon's transpose at N = 128 took 2.6 ms against 1.0).
//   * Precision (the reference's bf16 and int8 paths): every operand is
//     widened to fp32 as it is read, the products and every sum are fp32,
//     and C is rounded to Tb once, at the store (round to nearest even).
//     An int8 value is dequantized to q * scale[t / k_blk] in fp32 (t its
//     vector) once a chunk lands, by the ring's threads into an fp32 slot
//     of the ring: each vector's scale is copied into the ring beside its
//     values.  bf16 and int8 values fill the ring's chunks at 2 and 1
//     bytes per value.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kSpmmChunk = 32;        // vectors per pipeline step
constexpr int kSpmmMaxThreads = 512;  // G * n_tile
constexpr int kSpmmMaxCluster = 16;   // non-portable above 8
constexpr int kSpmmUnroll = 8;        // B gathers in flight per thread

// A ring of three chunks, one per warp (or one per block, see
// kBlockRing): the one being summed, the next (landed) and the one after
// (in flight).  vals comes first and is a multiple of 16 bytes; chunk(ci)
// is what the products of chunk ci read.
template <int V, typename Tv>
struct WindowRing {
  Tv vals[3][kSpmmChunk * V];
  int cols[3][kSpmmChunk];
  __device__ __forceinline__ const Tv* chunk(int ci) const {
    return vals[ci % 3];
  }
};
// int8 values: each vector's K-block scale rides the ring beside it, and
// a landed chunk is dequantized once, by the ring's threads, into fp32
// (two chunks' worth: the one being summed and the next), so the products
// read fp32 as for float values instead of every thread converting.
template <int V>
struct WindowRing<V, int8_t> {
  int8_t vals[3][kSpmmChunk * V];
  int cols[3][kSpmmChunk];
  float scl[3][kSpmmChunk];
  float deq[2][kSpmmChunk * V];
  __device__ __forceinline__ const float* chunk(int ci) const {
    return deq[ci % 2];
  }
  // q * scale in fp32 for the `cnt` vectors of landed chunk ci
  __device__ __forceinline__ void dequantize(int ci, int cnt, int tid,
                                             int nthr) {
    for (int i = tid; i < cnt * V; i += nthr) {
      deq[ci % 2][i] = static_cast<float>(vals[ci % 3][i]) * scl[ci % 3][i / V];
    }
  }
};

// An element of B (or C) widened to fp32, and an fp32 sum rounded to Tb.
__device__ __forceinline__ float load_b(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_b(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// This thread's kCols elements of one B row at p, widened to fp32: for two
// bf16 columns one 32-bit load when `pair` (the pair is 4-byte aligned and
// both columns exist), else a 16-bit load per column that exists (`has2`
// for the second).
template <int kCols, typename Tb>
__device__ __forceinline__ void load_cols(const Tb* p, bool pair, bool has2,
                                          float (&x)[kCols]) {
  if constexpr (kCols == 1) {
    x[0] = load_b(p);
  } else {
    static_assert(kCols == 2 && std::is_same<Tb, __nv_bfloat16>::value,
                  "two columns a thread are for bf16 B");
    if (pair) {  // a bf16 is the top half of the fp32 with the same value
      const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
      x[0] = __uint_as_float(u << 16);
      x[1] = __uint_as_float(u & 0xffff0000u);
    } else {
      x[0] = load_b(p);
      x[1] = has2 ? load_b(p + 1) : 0.f;
    }
  }
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// First K-block of slice s of a window of `len` blocks from k_lo, cut
// into ns slices.
__device__ __forceinline__ int slice_start(int k_lo, int len, int ns, int s) {
  return k_lo + static_cast<int>((static_cast<int64_t>(s) * len) / ns);
}

// cp.async of the column ids and values of the chunk of `cnt` vectors at
// t0 into one ring slot, by the `nthr` threads of the ring (thread tid),
// through L1: the values 16 bytes at a time when vec16 (every chunk's
// values then start and end on 16 bytes), else a float at a time, or for
// narrower values by plain loads (the barrier before the chunk is summed
// orders them as it orders the copies).
template <int V, typename Tv, typename Idx>
__device__ __forceinline__ void issue_chunk(int t0, int cnt, int tid,
                                            int nthr, const int* cols,
                                            const Tv* vh, bool vec16,
                                            int* sc, Tv* sv) {
  for (int i = tid; i < cnt; i += nthr) cp_async4(sc + i, cols + t0 + i);
  const Tv* src = vh + static_cast<Idx>(t0) * V;
  constexpr int kPer16 = 16 / sizeof(Tv);
  if (vec16) {  // cnt * V is then a multiple of kPer16
    for (int i = tid; i < cnt * V / kPer16; i += nthr) {
      cp_async16_ca(sv + kPer16 * i, src + kPer16 * i);
    }
  } else if constexpr (sizeof(Tv) == 4) {
    for (int i = tid; i < cnt * V; i += nthr) cp_async4(sv + i, src + i);
  } else {
    for (int i = tid; i < cnt * V; i += nthr) sv[i] = src[i];
  }
}

// acc[c * V + v] += vals[v] * bv[c] for the V values of one vector in
// shared memory and this thread's kCols columns: each value is read once.
template <int V, int kCols>
__device__ __forceinline__ void fma_value(float (&acc)[kCols * V], int v,
                                          float a, const float (&bv)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    acc[c * V + v] = fmaf(a, bv[c], acc[c * V + v]);
  }
}

template <int V, int kCols>
__device__ __forceinline__ void fma_vector(float (&acc)[kCols * V],
                                           const float* vals,
                                           const float (&bv)[kCols]) {
  const float4* a4 = reinterpret_cast<const float4*>(vals);
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 a = a4[q];
    fma_value<V, kCols>(acc, 4 * q, a.x, bv);
    fma_value<V, kCols>(acc, 4 * q + 1, a.y, bv);
    fma_value<V, kCols>(acc, 4 * q + 2, a.z, bv);
    fma_value<V, kCols>(acc, 4 * q + 3, a.w, bv);
  }
}

template <int V, int kCols>
__device__ __forceinline__ void fma_vector(float (&acc)[kCols * V],
                                           const __nv_bfloat16* vals,
                                           const float (&bv)[kCols]) {
  // a bf16 is the top half of the fp32 with the same value
  const uint4* a8 = reinterpret_cast<const uint4*>(vals);
#pragma unroll
  for (int q = 0; q < V / 8; ++q) {
    const uint4 u = a8[q];
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fma_value<V, kCols>(acc, 8 * q + 2 * j, __uint_as_float(w[j] << 16), bv);
      fma_value<V, kCols>(acc, 8 * q + 2 * j + 1,
                          __uint_as_float(w[j] & 0xffff0000u), bv);
    }
  }
}

// cp.async of the K-block scale of each of the chunk's `cnt` vectors at t0
// (int8 values) into the ring slot's scales.
__device__ __forceinline__ void issue_scales(int t0, int cnt, int tid,
                                             int nthr, int k_blk,
                                             const float* scales, float* ss) {
  for (int i = tid; i < cnt; i += nthr) {
    cp_async4(ss + i, scales + (t0 + i) / k_blk);
  }
}

// A group walks slices [s_lo, s_hi) of the window of `len` K-blocks at
// k_lo cut into ns slices and adds each slice's running sums into part
// (kFold; without it, one slice whose sum becomes part); this thread takes
// its kCols columns from col (pair, has2: see load_cols), the chunks
// through its warp's ring, or with kBlockRing (a block of one group)
// through the block's.
template <int V, bool kFold, bool kBlockRing, int kCols, typename Tv,
          typename Tb, typename Idx>
__device__ __forceinline__ void walk_slices(
    int k_lo, int len, int ns, int s_lo, int s_hi, int k_blk,
    const int* __restrict__ cols, const Tv* __restrict__ vh,
    const float* __restrict__ scales, const Tb* __restrict__ bh, int n,
    int col, bool active, bool pair, bool has2, WindowRing<V, Tv>& ring,
    float (&part)[kCols * V]) {
  const int tid = kBlockRing ? threadIdx.x : threadIdx.x & 31;
  const int nthr = kBlockRing ? blockDim.x : 32;
  const int t_lo = slice_start(k_lo, len, ns, s_lo) * k_blk;
  const int t_hi = slice_start(k_lo, len, ns, s_hi) * k_blk;
  const int nchunks = (t_hi - t_lo + kSpmmChunk - 1) / kSpmmChunk;
  // chunks start at K-block boundaries (or 32 vectors after one), so the
  // values of every chunk are 16-byte aligned when a K-block's are
  const bool vec16 = (reinterpret_cast<uintptr_t>(vh) & 15) == 0 &&
                     (k_blk * V * sizeof(Tv)) % 16 == 0;
  auto chunk_len = [&](int t0) { return min(t_hi - t0, kSpmmChunk); };
  auto issue = [&](int ci) {
    const int t0 = t_lo + ci * kSpmmChunk;
    issue_chunk<V, Tv, Idx>(t0, chunk_len(t0), tid, nthr, cols, vh, vec16,
                            ring.cols[ci % 3], ring.vals[ci % 3]);
    if constexpr (std::is_same<Tv, int8_t>::value) {
      issue_scales(t0, chunk_len(t0), tid, nthr, k_blk, scales,
                   ring.scl[ci % 3]);
    }
  };
  auto ring_sync = [] {
    if (kBlockRing) {
      __syncthreads();
    } else {
      __syncwarp();
    }
  };
  constexpr bool kInt8 = std::is_same<Tv, int8_t>::value;
  if (nchunks > 0) issue(0);
  if (nchunks > 1) issue(1);
  cp_async_commit();
  if constexpr (kInt8) {  // chunk 0 in fp32 before the loop
    if (nchunks > 0) {
      cp_async_wait_all();
      ring_sync();
      ring.dequantize(0, chunk_len(t_lo), tid, nthr);
    }
  }

  constexpr int kSums = kCols * V;
  float acc[kSums];
#pragma unroll
  for (int v = 0; v < kSums; ++v) acc[v] = 0.f;
  int s = s_lo;
  int fold_at = slice_start(k_lo, len, ns, s + 1) * k_blk;
  for (int ci = 0; ci < nchunks; ++ci) {
    // Chunks ci and ci + 1 have landed and the ring's threads are done
    // with chunk ci - 1: its slot takes chunk ci + 2, in flight while ci
    // is summed.
    // (int8: chunk ci's fp32 values, written before the barrier, are
    // visible; chunk ci + 1 is dequantized into the other fp32 slot, read
    // last before the barrier.)
    cp_async_wait_all();
    ring_sync();
    if (ci + 2 < nchunks) issue(ci + 2);
    cp_async_commit();
    if constexpr (kInt8) {
      if (ci + 1 < nchunks) {
        ring.dequantize(ci + 1, chunk_len(t_lo + (ci + 1) * kSpmmChunk), tid,
                        nthr);
      }
    }

    const int t0 = t_lo + ci * kSpmmChunk;
    const int cnt = chunk_len(t0);
    const auto* sv = ring.chunk(ci);
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
          float bv[kSpmmUnroll][kCols];
#pragma unroll
          for (int u = 0; u < kSpmmUnroll; ++u) {
            load_cols<kCols>(bh + (static_cast<Idx>(sc[r + u]) * n + col),
                             pair, has2, bv[u]);
          }
#pragma unroll
          for (int u = 0; u < kSpmmUnroll; ++u) {
            fma_vector<V, kCols>(acc, sv + (r + u) * V, bv[u]);
          }
        }
        for (; r < r1; ++r) {
          float bv[kCols];
          load_cols<kCols>(bh + (static_cast<Idx>(sc[r]) * n + col), pair,
                           has2, bv);
          fma_vector<V, kCols>(acc, sv + r * V, bv);
        }
      }
      r0 = r1;
      if (kFold && t0 + r1 == fold_at) {  // slice s ends: fold it
#pragma unroll
        for (int v = 0; v < kSums; ++v) {
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
    for (int v = 0; v < kSums; ++v) part[v] = acc[v];
  }
}

// Stores the V rows of window w at the kCols columns from col of C (rows
// < m, columns < n).
template <int V, int kCols, typename Tb>
__device__ __forceinline__ void store_rows(Tb* ch, int w, int m, int n,
                                           int col,
                                           const float (&x)[kCols * V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int row = w * V + v;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (row < m && col + c < n) {
        ch[static_cast<int64_t>(row) * n + col + c] = from_f32<Tb>(x[c * V + v]);
      }
    }
  }
}

// Arguments of both variants of the kernel.
template <typename Tv, typename Tb>
struct WindowArgs {
  const int* win_ptr;
  const int* cols;
  const Tv* vals;
  const float* scales;   // (NB,) per-K-block scales of int8 values, else null
  const Tb* b;
  Tb* c;
  const int* split_ids;  // the plan's long windows, then its medium ones
  int m, n, num_windows, k_blk, n_tile, groups, cluster, split_blk;
  int num_long, num_medium;
  int64_t vals_hstride, b_hstride;
};

// One block of G groups of n_tile / kCols threads per (task rank, column
// tile, head); the grid's x is tasks * cluster, clusters along x.  kSplit
// false: a plan without split windows, every task a pack, in fewer
// registers; kBlockRing: its block is one group that shares one ring.
// Two columns a thread (kCols = 2, never with kSplit) hold twice the sums
// in half the threads: the register budget a thread doubles where V = 8.
template <int V, bool kSplit, bool kBlockRing, int kCols, typename Tv,
          typename Tb, typename Idx>
__global__ void __launch_bounds__(kSpmmMaxThreads / kCols,
                                  kCols == 2 ? (V == 16 ? 2 : 4)
                                             : (kSplit || V == 16 ? 2 : 3))
spmm_window_kernel(const WindowArgs<Tv, Tb> a) {
  extern __shared__ __align__(16) float smem[];
  static_assert(kCols == 1 || !kSplit, "a split plan: a column a thread");
  constexpr int kSums = kCols * V;
  const int tpg = a.n_tile / kCols;  // threads a group
  const int g = threadIdx.x / tpg;
  const int lc = (threadIdx.x - g * tpg) * kCols;  // first column in tile
  const int col = blockIdx.y * a.n_tile + lc;
  const int64_t h = blockIdx.z;
  const bool active = col < a.n;
  const Tv* vh = a.vals + h * a.vals_hstride;
  const Tb* bh = a.b + h * a.b_hstride;
  const bool has2 = col + 1 < a.n;
  const bool pair = kCols == 2 && has2 && a.n % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(bh) & 3) == 0;
  Tb* ch = a.c + h * static_cast<int64_t>(a.m) * a.n;
  const int nwarps = blockDim.x >> 5;
  auto* rings = reinterpret_cast<WindowRing<V, Tv>*>(smem);
  WindowRing<V, Tv>& ring = rings[kBlockRing ? 0 : threadIdx.x >> 5];
  const int cluster = kSplit ? a.cluster : 1;
  const int task = blockIdx.x / cluster;
  const int rank = blockIdx.x - task * cluster;
  const int num_long = kSplit ? a.num_long : 0;
  const int medium_tasks = kSplit ? (a.num_medium + cluster - 1) / cluster : 0;

  float part[kSums];
#pragma unroll
  for (int v = 0; v < kSums; ++v) part[v] = 0.f;

  if (task >= num_long + medium_tasks) {  // a pack: one window per group
    const int w =
        ((task - num_long - medium_tasks) * cluster + rank) * a.groups + g;
    if (w >= a.num_windows) return;  // the group leaves; no barrier follows
    const int k_lo = a.win_ptr[w];
    const int len = a.win_ptr[w + 1] - k_lo;
    if (kSplit && len > a.split_blk) return;  // its own task
    walk_slices<V, false, kBlockRing, kCols, Tv, Tb, Idx>(
        k_lo, len, 1, 0, 1, a.k_blk, a.cols, vh, a.scales, bh, a.n, col,
        active, pair, has2, ring, part);
    if (active) store_rows<V, kCols>(ch, w, a.m, a.n, col, part);
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
    walk_slices<V, true, false, kCols, Tv, Tb, Idx>(
        k_lo, len, ns, static_cast<int>((int64_t(j) * ns) / tg),
        static_cast<int>((int64_t(j + 1) * ns) / tg), a.k_blk, a.cols, vh,
        a.scales, bh, a.n, col, active, pair, has2, ring, part);

    // The block's sum, in group order: thread (g, lc) adds rows v = g,
    // g + G, ... of its column over the groups.
    float* red = reinterpret_cast<float*>(rings + nwarps);  // (G, V, n_tile)
    const int nt = a.n_tile;
#pragma unroll
    for (int v = 0; v < V; ++v) red[(g * V + v) * nt + lc] = part[v];
    __syncthreads();
    for (int v = g; v < V; v += a.groups) {
      float s = red[v * nt + lc];
      for (int g2 = 1; g2 < a.groups; ++g2) s += red[(g2 * V + v) * nt + lc];
      if (!is_long) {
        const int row = w * V + v;
        if (active && row < a.m) {
          ch[static_cast<int64_t>(row) * a.n + col] = from_f32<Tb>(s);
        }
      } else {
        red[v * nt + lc] = s;
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
        float s = red[v * nt + lc];
        for (int r = 1; r < cluster; ++r) {
          s += cl.map_shared_rank(red, r)[v * nt + lc];
        }
        const int row = w * V + v;
        if (active && row < a.m) {
          ch[static_cast<int64_t>(row) * a.n + col] = from_f32<Tb>(s);
        }
      }
    }
    cl.sync();
  }
}

// Launches the kernel over `heads` heads on `stream`.  win_ptr (W + 1,)
// int32, cols (NNZP,) int32, vals (NNZP, V) Tv per head or shared, scales
// (NB,) fp32 for int8 values (else unused), b (K, N) Tb row-major per head
// or shared, c (heads, M, N) Tb row-major, split_ids (num_long +
// num_medium,) int32 or null when both are 0.  A block is `groups` groups
// of a tile of n_tile columns (n_tile a multiple of 32, groups * n_tile at
// most 512), a thread a column, or two for bf16 B in a plan without split
// windows when n_tile is a multiple of 64 (a group then still fills whole
// warps); `cluster` blocks form one cluster.  A cluster size or
// shared-memory size the card refuses is returned as the launch's error.
template <typename Tv, typename Tb, typename Idx>
cudaError_t launch_spmm_window(
    const void* win_ptr, const void* cols, const void* vals,
    const void* scales, const void* b, void* c, const void* split_ids, int m,
    int n, int num_windows, int heads, int v, int k_blk, int n_tile,
    int groups, int cluster, int split_blk, int num_long, int num_medium,
    int64_t vals_hstride, int64_t b_hstride, void* stream) {
  if (n_tile % 32 != 0 || groups < 1 || groups * n_tile > kSpmmMaxThreads ||
      cluster < 1 || cluster > kSpmmMaxCluster || split_blk < 1 ||
      (num_long > 0 && cluster < 2) ||
      (std::is_same<Tv, int8_t>::value && scales == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const bool split = num_long + num_medium > 0;
  constexpr bool kPairs = std::is_same<Tb, __nv_bfloat16>::value;
  // columns a thread
  const int per_thread = kPairs && !split && n_tile % 64 == 0 ? 2 : 1;
  const int threads = groups * n_tile / per_thread;
  // a plan without split windows and a block of one group of several
  // warps: one ring for the block
  const bool block_ring = !split && n_tile / per_thread > 32;
  if (block_ring && groups != 1) return cudaErrorInvalidValue;
  const int64_t medium_tasks = (num_medium + cluster - 1) / cluster;
  const int64_t pack = static_cast<int64_t>(cluster) * groups;
  const int64_t tasks =
      num_long + medium_tasks + (num_windows + pack - 1) / pack;
  if (tasks * cluster > 0x7fffffff) return cudaErrorInvalidValue;

  const WindowArgs<Tv, Tb> args{static_cast<const int*>(win_ptr),
                                static_cast<const int*>(cols),
                                static_cast<const Tv*>(vals),
                                static_cast<const float*>(scales),
                                static_cast<const Tb*>(b),
                                static_cast<Tb*>(c),
                                static_cast<const int*>(split_ids),
                                m, n, num_windows, k_blk, n_tile, groups,
                                cluster, split_blk, num_long, num_medium,
                                vals_hstride, b_hstride};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tasks * cluster),
                     (n + n_tile - 1) / n_tile, heads);
  cfg.blockDim = dim3(threads);
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
    cfg.dynamicSmemBytes = (block_ring ? 1 : threads / 32) * ring_bytes +
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
  auto lean = [&](auto vt, auto ct) {  // a plan without split windows
    constexpr int V = decltype(vt)::value;
    constexpr int C = decltype(ct)::value;
    constexpr size_t ring = sizeof(WindowRing<V, Tv>);
    if (block_ring) {
      return run(spmm_window_kernel<V, false, true, C, Tv, Tb, Idx>, ring);
    }
    return run(spmm_window_kernel<V, false, false, C, Tv, Tb, Idx>, ring);
  };
  auto by_cols = [&](auto vt) {
    constexpr int V = decltype(vt)::value;
    if (split) {
      return run(spmm_window_kernel<V, true, false, 1, Tv, Tb, Idx>,
                 sizeof(WindowRing<V, Tv>));
    }
    if constexpr (kPairs) {
      if (per_thread == 2) return lean(vt, std::integral_constant<int, 2>{});
    }
    return lean(vt, std::integral_constant<int, 1>{});
  };
  if (v == 8) return by_cols(std::integral_constant<int, 8>{});
  if (v == 16) return by_cols(std::integral_constant<int, 16>{});
  return cudaErrorInvalidValue;
}

}  // namespace repro
