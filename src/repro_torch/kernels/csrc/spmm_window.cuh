// The window-parallel SpMM kernel, shared by spmm.cu (one head),
// spmm_batched.cu (a grid of H heads) and spmm_staged.cu (one head over a
// gathered copy of B):
// C[h] (M, N) = A[h] (M, K) @ B[h] (K, N), templated on the value type Tv
// (float, bf16, or int8 with one fp32 scale per K-block), B's type Tb
// (float or bf16, also C's unless Tc says otherwise) and the index type of
// one head's B and vals.
//
// Design: FlashSparse's swap and transpose on mma.sync m16n8k8 (TF32).  A
// window's output (V rows x N columns) is taken transposed, C_w^T = B^T .
// A_w^T, so the window's V = 8 rows are the mma's n side (V = 16: two n8
// tiles) and are never padded to 16: a k-step of 8 vectors t .. t + 7 is
//   * the mma's A operand (m16 x k8): 16 output columns x the 8 vectors'
//     gathered B rows, B[cols[t + k], col];
//   * its B operand (k8 x n8): the 8 vectors' values x the window's rows,
//     read from a ring of chunks in shared memory;
//   * its accumulator (m16 x n8): 16 columns x the 8 rows of the output.
// A warp owns 32 neighbouring columns of the tile (two m16 tiles).  The m
// side is free, so fragment row i of m-tile j holds column 4 (i % 8) + 2 j
// + i / 8 (the paper's memory-efficient mapping): lane (g, q) (g = lane /
// 4, q = lane % 4) needs columns 4 g .. 4 g + 3 of B rows cols[t + q] and
// cols[t + q + 4] for both m-tiles, one 16-byte load a row for fp32 B and
// one 8-byte load for bf16, so the 8 lanes on a row read one contiguous
// 128-byte (64-byte) segment, whole sectors; its accumulators hold rows
// 2 q and 2 q + 1 of those same 4 columns, so C is stored in row-major
// order straight from the registers, with no shuffle.  A warp issues the
// gathers of kSpmmSteps k-steps before their products.
//
// A thread block is G slice groups, each one column tile of n_tile
// columns walked by n_tile / 32 warps, and a group walks a range of one
// window's vectors in chunks of 32: each of its warps streams the chunks'
// column ids and (32, V) values through a ring of three chunks in shared
// memory of its own, each copied by cp.async through L1 two chunks ahead
// (a chunk costs one warp barrier and no synchronous load; a group-wide
// barrier would need a named barrier per group, which costs the SM
// resident blocks).  B rows shared by several windows (hub columns) are
// served from L2.
//
// K-steps.  A k-step is at most 8 consecutive vectors of one chunk and one
// slice: the steps of a chunk start at its first vector, or where a slice
// ends inside it, and a step that a slice's end, a window's end or the
// chunk's end cuts short multiplies zeros in the fragment columns past the
// cut (no B row or value past it is read).  Chunks and slices start on
// K-blocks, so at k_blk 8, 16 and 32 a step is one K-block or an eighth
// of one, and at k_blk = 4 two whole K-blocks of one slice, or the last
// one.
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
// Each slice is one pair of fp32 sums (hi, lo: see Precision) over its
// k-steps in order, added at the slice's end into the group's sum, which
// each lane keeps in shared memory (its own rows and columns: registers
// are what bounds the blocks an SM holds); the groups' sums of a window
// are added in group order, and for a long window the blocks' sums meet
// in distributed shared memory (the cluster's blocks read each other's
// shared memory) and are added by rank 0 in rank order.  No atomics and
// no scratch in device memory: every sum is taken in the same order on
// every launch, so two launches give the same bits.  A window of at most
// split_blk K-blocks is one slice walked by one group.  A plan without
// split windows (every window of the Amazon replica's A) launches a
// variant without the split path: one window per block of a column tile
// wider than a warp, whose warps then share one ring (block barriers), or
// four one-warp windows per block.  Every variant fits two blocks of 512
// threads an SM (64 registers a thread): a plan with a long window
// launches clusters of up to 16 blocks, and at one block an SM a cluster
// needs 16 free SMs of one GPC at once.  On an H100 (700 W;
// scripts/spmm_variants.py), Amazon's transpose at N = 128 took 1.45 ms
// at 91 registers a thread and 0.97 at 64; at 64, four k-steps of fp32
// gathers in flight took 1.14 ms and three 1.04 against 0.97 for two,
// and four of bf16 0.63 against 0.69 for two (kSpmmSteps).
//   * A head reads vals and B at its own offset, h * vals_hstride and
//     h * b_hstride; a stride of 0 makes an operand shared by every head,
//     read from one copy.  The arithmetic of an output does not depend on
//     the head, so H heads in one launch give bitwise the output of H
//     one-head launches.
//   * Padding vectors carry column 0 and value 0 and are multiplied, not
//     skipped, as in the reference.
//   * An empty window stores zeros; the all-empty dummy block belongs to
//     no window and is never visited.
//   * The ragged last column tile is masked: columns past N read as zero
//     and are not written, and a row of B or C is read or written element
//     by element where N or the base address does not allow the vector
//     access (N not a multiple of 4), with the same bits.  Rows >= M of the
//     last window are not written.  One head's B (K x N) and vals (NNZP x
//     V) are indexed in 32 bits (Idx = int); the wrappers choose the 64-bit
//     instantiation (Idx = int64_t) only when one of them reaches 2^31
//     elements.
//   * A gathered B (kGathered, spmm_staged.cu): B is the staged copy G =
//     B[cols] (NNZP x N), and a lane reads row t of G where it reads row
//     cols[t] of B, so no column id is staged; C may then be of another
//     type Tc than G's (the staged baseline's fp32 C).  Everything else,
//     the plan and the order of every sum included, is the same code, so
//     its output is the window kernel's bit for bit.
//   * Precision (the SDDMM tile's rules, sddmm_rows.cuh, tf32.cuh).  Every
//     operand is widened to fp32 as it is read.  fp32: 3xTF32, each operand
//     split into big = tf32(x) and small = tf32(x - big); a k-step's
//     big.big product is taken from a zero accumulator and added to the
//     hi sum by an fp32 add (the tensor cores' own accumulation does not
//     round to nearest, and a slice holds up to split_blk * k_blk / 8
//     k-steps), big.small and small.big accumulate in the lo sum's mma
//     chain, and a slice's sum is hi + lo.  bf16 values and B are exact in
//     TF32: the products with a small part are 0 and are not issued, so the
//     bf16 kernel is the fp32 kernel on the widened operands bit for bit,
//     and C is rounded to Tb once, at the store (round to nearest even).
//     int8: a value is dequantized to q * scale[t / k_blk] in fp32 (t its
//     vector) once a chunk lands, by the ring's threads into an fp32 slot
//     of the ring (each vector's scale is copied into the ring beside its
//     values); q * scale is split, and with bf16 B (exact) that is two
//     products a k-step, with fp32 B three, the fp32 kernel's on the q *
//     scale values.  bf16 and int8 values fill the ring's chunks at 2 and 1
//     bytes per value.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

namespace repro {

constexpr int kSpmmChunk = 32;        // vectors per pipeline step
constexpr int kSpmmMaxThreads = 512;  // G * n_tile
constexpr int kSpmmMaxCluster = 16;   // non-portable above 8
constexpr int kSpmmKStep = 8;         // vectors a k-step (mma k8)
// k-steps of gathers in flight a warp: the rows take 16 registers a lane,
// two k-steps of fp32 B, four of bf16
template <typename Tb>
constexpr int kSpmmSteps = std::is_same<Tb, float>::value ? 2 : 4;

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

// An element of B widened to fp32, and an fp32 sum rounded to Tb.
__device__ __forceinline__ float load_b(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_b(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
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

// Four neighbouring columns of a B row as loaded: fp32 in a float4, bf16
// as the raw bits of four in a uint2 (widened when a fragment is built, so
// the gathers in flight take half the registers).
template <typename Tb>
struct QuadOf {
  using type = float4;
};
template <>
struct QuadOf<__nv_bfloat16> {
  using type = uint2;
};
template <typename Tb>
using Quad = typename QuadOf<Tb>::type;

template <typename Tb>
__device__ __forceinline__ Quad<Tb> quad_zero() {
  if constexpr (std::is_same<Tb, float>::value) {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_uint2(0u, 0u);
  }
}

// Columns c .. c + 3 of the row of B whose column c is at p, zero at and
// past column n: one 16-byte (fp32) or 8-byte (bf16) load when `vec` (N a
// multiple of 4, B aligned) and all four exist, else one element at a time
// into the same places.
__device__ __forceinline__ float4 load_quad(const float* p, int c, int n,
                                            bool vec) {
  if (vec && c + 4 <= n) return __ldg(reinterpret_cast<const float4*>(p));
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = c + e < n ? __ldg(p + e) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ uint2 load_quad(const __nv_bfloat16* p, int c,
                                           int n, bool vec) {
  if (vec && c + 4 <= n) return __ldg(reinterpret_cast<const uint2*>(p));
  const auto* q = reinterpret_cast<const unsigned short*>(p);
  unsigned x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = c + e < n ? __ldg(q + e) : 0u;
  return make_uint2(x[0] | x[1] << 16, x[2] | x[3] << 16);
}

// Element e (0 .. 3, a constant after unrolling) of a quad, widened to
// fp32: a bf16 is the top half of the fp32 with the same value.
__device__ __forceinline__ float quad_elem(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}
__device__ __forceinline__ float quad_elem(const uint2& x, int e) {
  const unsigned w = e < 2 ? x.x : x.y;
  return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
}

// Value i of a ring chunk, widened to fp32.
__device__ __forceinline__ float ring_val(const float* sv, int i) {
  return sv[i];
}
__device__ __forceinline__ float ring_val(const __nv_bfloat16* sv, int i) {
  return __bfloat162float(sv[i]);
}

// Stores y[0 .. 3] to columns c .. c + 3 of the row of C whose column c is
// at p (those below n), rounded to Tc: one vector store when `vec` and all
// four exist.
template <typename Tc>
__device__ __forceinline__ void store_quad(Tc* p, int c, int n, bool vec,
                                           const float (&y)[4]) {
  if (vec && c + 4 <= n) {
    if constexpr (std::is_same<Tc, float>::value) {
      *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      *reinterpret_cast<uint2*>(p) =
          make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                     *reinterpret_cast<const unsigned*>(&hi));
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (c + e < n) p[e] = from_f32<Tc>(y[e]);
  }
}

// A lane's V sums: the accumulators of the warp's m16n8 tiles (n-tile nt,
// m-tile j at [2 nt + j]).  Element i of tile (nt, j) is output row
// nt * 8 + 2 q + (i & 1) (q = lane % 4) at column 4 g + 2 j + (i >> 1) of
// the warp's 32 (g = lane / 4): the lane's 4 columns of two rows per
// n-tile.
template <int V>
using Tiles = float[V / 4][4];

template <int V>
__device__ __forceinline__ void zero_tiles(Tiles<V>& x) {
#pragma unroll
  for (int k = 0; k < V / 4; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[k][i] = 0.f;
  }
}

// The lane's sums of output row nt * 8 + 2 q + hh at its 4 columns.
template <int V>
__device__ __forceinline__ void tile_row(const Tiles<V>& x, int nt, int hh,
                                         float (&y)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) y[e] = x[2 * nt + (e >> 1)][2 * (e & 1) + hh];
}

// The products of vectors [r0, r1) of one chunk (at most kSpmmChunk, all in
// one slice or run piece) added into this warp's sums on the tensor cores:
// the vectors' values are in the ring chunk sv ((32, V), fp32 or bf16),
// vector r's B row is brow(r) of bh (K x n), and the lane's columns are c
// .. c + 3.  K-steps of 8 vectors from r0, the last one cut at r1: the
// lanes' vectors past r1 enter both operands as zeros, and no B row or
// value past r1 is read.  The gathers of kSpmmSteps k-steps are issued
// before their products.  Each k-step's big.big product is added to hi
// (fp32, or fp64 for the balanced kernel's run sums), the small products
// accumulate in lo's mma chain; kTail: with the products of the operands'
// tails too (tf32.cuh), for sums too long for 3xTF32's representation.
template <int V, bool kTail, typename Tb, typename Ts, typename Brow,
          typename Acc>
__device__ __forceinline__ void mma_range(int r0, int r1, const Ts* sv,
                                          const Brow& brow,
                                          const Tb* __restrict__ bh, int n,
                                          int c, bool vec,
                                          Acc (&hi)[V / 4][4], Tiles<V>& lo) {
  constexpr int NT = V / 8;
  constexpr bool kExactB = !std::is_same<Tb, float>::value;  // bf16 B
  constexpr bool kExactV = std::is_same<Ts, __nv_bfloat16>::value;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int r = r0; r < r1; r += kSpmmKStep * kSpmmSteps<Tb>) {
    // B rows of vectors r + 8 s + q (half 0) and + 4 (half 1)
    Quad<Tb> rows[kSpmmSteps<Tb>][2];
#pragma unroll
    for (int s = 0; s < kSpmmSteps<Tb>; ++s) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = r + kSpmmKStep * s + q + 4 * hf;
        rows[s][hf] = t < r1 ? load_quad(bh + (brow(t) * n + c), c, n, vec)
                             : quad_zero<Tb>();
      }
    }
#pragma unroll
    for (int s = 0; s < kSpmmSteps<Tb>; ++s) {
      const int t0 = r + kSpmmKStep * s;
      if (t0 < r1) {  // warp-uniform
        Frag<2, kExactV, kTail> b[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int t = t0 + q + 4 * hf;
            b[nt].set(hf, t < r1 ? ring_val(sv, t * V + nt * 8 + g) : 0.f);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          Frag<4, kExactB, kTail> a;
          a.set(0, quad_elem(rows[s][0], 2 * mt));
          a.set(1, quad_elem(rows[s][0], 2 * mt + 1));
          a.set(2, quad_elem(rows[s][1], 2 * mt));
          a.set(3, quad_elem(rows[s][1], 2 * mt + 1));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // the big.big product from a zero accumulator, added to hi by
            // an fp32 add; the small products accumulate in lo's chain
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_3xtf32(d, lo[2 * nt + mt], a, b[nt]);
#pragma unroll
            for (int i = 0; i < 4; ++i) hi[2 * nt + mt][i] += d[i];
          }
        }
      }
    }
  }
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
// orders them as it orders the copies); without kIds (a gathered B) no
// column id.
template <int V, typename Tv, typename Idx, bool kIds = true>
__device__ __forceinline__ void issue_chunk(int t0, int cnt, int tid,
                                            int nthr, const int* cols,
                                            const Tv* vh, bool vec16,
                                            int* sc, Tv* sv) {
  if constexpr (kIds) {
    for (int i = tid; i < cnt; i += nthr) cp_async4(sc + i, cols + t0 + i);
  }
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

// cp.async of the K-block scale of each of the chunk's `cnt` vectors at t0
// (int8 values) into the ring slot's scales.
__device__ __forceinline__ void issue_scales(int t0, int cnt, int tid,
                                             int nthr, int k_blk,
                                             const float* scales, float* ss) {
  for (int i = tid; i < cnt; i += nthr) {
    cp_async4(ss + i, scales + (t0 + i) / k_blk);
  }
}

// Adds hi + lo into this lane's rows of a (V, stride) fp32 block in shared
// memory (row v of the lane's four columns at red + v * stride: rows
// nt * 8 + 2 q + hh, q = lane % 4) and zeroes hi and lo.
template <int V>
__device__ __forceinline__ void fold_rows(Tiles<V>& hi, Tiles<V>& lo,
                                          float* red, int stride) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < V / 8; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      auto* p = reinterpret_cast<float4*>(red + (nt * 8 + 2 * q + hh) * stride);
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 2 * nt + (e >> 1), i = 2 * (e & 1) + hh;
        y[e] = hi[k][i] + lo[k][i];
      }
      const float4 x = *p;
      *p = make_float4(x.x + y[0], x.y + y[1], x.z + y[2], x.w + y[3]);
    }
  }
  zero_tiles<V>(hi);
  zero_tiles<V>(lo);
}

// A group walks slices [s_lo, s_hi) of the window of `len` K-blocks at
// k_lo cut into ns slices.  kFold: each slice's sum is added, at the
// slice's end, into this lane's rows of the group's sums in shared memory
// (fold_rows(..., red, stride)); without it (one slice) the slice's sum is
// left in hi + lo.  This lane takes columns c .. c + 3 (`active`: its warp
// has a column below n), the chunks through its warp's ring, or with
// kBlockRing (a block of one group) through the block's; kGathered: bh is
// G = B[cols], row t for vector t.
template <int V, bool kFold, bool kBlockRing, typename Tv, typename Tb,
          typename Idx, bool kGathered>
__device__ __forceinline__ void walk_slices(
    int k_lo, int len, int ns, int s_lo, int s_hi, int k_blk,
    const int* __restrict__ cols, const Tv* __restrict__ vh,
    const float* __restrict__ scales, const Tb* __restrict__ bh, int n,
    int c, bool active, bool vec, WindowRing<V, Tv>& ring, Tiles<V>& hi,
    Tiles<V>& lo, float* red, int stride) {
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
    issue_chunk<V, Tv, Idx, !kGathered>(t0, chunk_len(t0), tid, nthr, cols,
                                        vh, vec16, ring.cols[ci % 3],
                                        ring.vals[ci % 3]);
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

  zero_tiles<V>(hi);
  zero_tiles<V>(lo);
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
    const int* sc = ring.cols[ci % 3];
    // the B row of the chunk's vector r: its column id, or for a gathered
    // B its own index
    auto brow = [&](int r) {
      if constexpr (kGathered) {
        return static_cast<Idx>(t0 + r);
      } else {
        return static_cast<Idx>(sc[r]);
      }
    };
    int r0 = 0;
    while (r0 < cnt) {
      const int r1 = kFold ? min(fold_at - t0, cnt) : cnt;
      if (active) {
        mma_range<V, false>(r0, r1, ring.chunk(ci), brow, bh, n, c, vec, hi,
                            lo);
      }
      r0 = r1;
      if (kFold && t0 + r1 == fold_at) {  // slice s ends: fold it
        if (active) fold_rows<V>(hi, lo, red, stride);
        ++s;
        fold_at = slice_start(k_lo, len, ns, s + 1) * k_blk;
      }
    }
  }
}

// Stores this lane's sums of window w (its two rows per n-tile at columns
// c .. c + 3) into C (rows < m, columns < n).
template <int V, typename Tc>
__device__ __forceinline__ void store_window(Tc* ch, int w, int m, int n,
                                             int c, bool vec,
                                             const Tiles<V>& x) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < V / 8; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = w * V + nt * 8 + 2 * q + hh;
      if (row < m) {
        float y[4];
        tile_row<V>(x, nt, hh, y);
        store_quad(ch + static_cast<int64_t>(row) * n + c, c, n, vec, y);
      }
    }
  }
}

// Arguments of both variants of the kernel (C of type Tc: Tb, or fp32
// for the staged baseline).
template <typename Tv, typename Tb, typename Tc = Tb>
struct WindowArgs {
  const int* win_ptr;
  const int* cols;       // null for a gathered B
  const Tv* vals;
  const float* scales;   // (NB,) per-K-block scales of int8 values, else null
  const Tb* b;           // B, or G = B[cols] when gathered
  Tc* c;
  const int* split_ids;  // the plan's long windows, then its medium ones
  int m, n, num_windows, k_blk, n_tile, groups, cluster, split_blk;
  int num_long, num_medium;
  int64_t vals_hstride, b_hstride;
};

// One block of G groups of n_tile threads (n_tile / 32 warps of 32
// columns) per (task rank, column tile, head); the grid's x is tasks *
// cluster, clusters along x.  kSplit false: a plan without split windows,
// every task a pack; kBlockRing: its block is one group that shares one
// ring.
template <int V, bool kSplit, bool kBlockRing, typename Tv, typename Tb,
          typename Idx, typename Tc, bool kGathered>
__global__ void __launch_bounds__(kSpmmMaxThreads, 2)
spmm_window_kernel(const WindowArgs<Tv, Tb, Tc> a) {
  extern __shared__ __align__(16) float smem[];
  const int tpg = a.n_tile;  // threads a group
  const int g = threadIdx.x / tpg;
  const int lc = threadIdx.x - g * tpg;  // this thread's column in the tile
  // the warp's first column in the tile, and this lane's four from c
  const int wc = lc & ~31;
  const int c = blockIdx.y * a.n_tile + wc + 4 * ((threadIdx.x & 31) >> 2);
  const bool active = blockIdx.y * a.n_tile + wc < a.n;
  const int64_t h = blockIdx.z;
  const Tv* vh = a.vals + h * a.vals_hstride;
  const Tb* bh = a.b + h * a.b_hstride;
  Tc* ch = a.c + h * static_cast<int64_t>(a.m) * a.n;
  // 16-byte (fp32) or 8-byte (bf16) accesses to four columns of a row
  const auto addr_b = reinterpret_cast<uintptr_t>(bh);
  const auto addr_c = reinterpret_cast<uintptr_t>(ch);
  const bool vec_b = a.n % 4 == 0 && addr_b % sizeof(Quad<Tb>) == 0;
  const bool vec_c = a.n % 4 == 0 && addr_c % (4 * sizeof(Tc)) == 0;
  const int nwarps = blockDim.x >> 5;
  auto* rings = reinterpret_cast<WindowRing<V, Tv>*>(smem);
  WindowRing<V, Tv>& ring = rings[kBlockRing ? 0 : threadIdx.x >> 5];
  const int cluster = kSplit ? a.cluster : 1;
  const int task = blockIdx.x / cluster;
  const int rank = blockIdx.x - task * cluster;
  const int num_long = kSplit ? a.num_long : 0;
  const int medium_tasks = kSplit ? (a.num_medium + cluster - 1) / cluster : 0;

  Tiles<V> hi, lo;  // this lane's sums: hi + lo (see Precision)

  if (task >= num_long + medium_tasks) {  // a pack: one window per group
    const int w =
        ((task - num_long - medium_tasks) * cluster + rank) * a.groups + g;
    if (w >= a.num_windows) return;  // the group leaves; no barrier follows
    const int k_lo = a.win_ptr[w];
    const int len = a.win_ptr[w + 1] - k_lo;
    if (kSplit && len > a.split_blk) return;  // its own task
    walk_slices<V, false, kBlockRing, Tv, Tb, Idx, kGathered>(
        k_lo, len, 1, 0, 1, a.k_blk, a.cols, vh, a.scales, bh, a.n, c,
        active, vec_b, ring, hi, lo, nullptr, 0);
    if (active) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) hi[k][i] += lo[k][i];
      }
      store_window<V>(ch, w, a.m, a.n, c, vec_c, hi);
    }
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
    // The group's sums (G, V, n_tile) in shared memory: each lane adds its
    // slices' sums into its own rows and columns of them, from zero.
    float* red = reinterpret_cast<float*>(rings + nwarps);
    const int nt = a.n_tile;
    float* mine = red + g * V * nt + wc + 4 * ((threadIdx.x & 31) >> 2);
    const int q = threadIdx.x & 3;
#pragma unroll
    for (int t = 0; t < V / 8; ++t) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        *reinterpret_cast<float4*>(mine + (t * 8 + 2 * q + hh) * nt) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    walk_slices<V, true, false, Tv, Tb, Idx, kGathered>(
        k_lo, len, ns, static_cast<int>((int64_t(j) * ns) / tg),
        static_cast<int>((int64_t(j + 1) * ns) / tg), a.k_blk, a.cols, vh,
        a.scales, bh, a.n, c, active, vec_b, ring, hi, lo, mine, nt);

    // The block's sum, in group order: thread (g, lc) adds rows v = g,
    // g + G, ... of column lc over the groups.
    __syncthreads();
    const int col = blockIdx.y * nt + lc;
    const bool has_col = col < a.n;
    for (int v = g; v < V; v += a.groups) {
      float s = red[v * nt + lc];
      for (int g2 = 1; g2 < a.groups; ++g2) s += red[(g2 * V + v) * nt + lc];
      if (!is_long) {
        const int row = w * V + v;
        if (has_col && row < a.m) {
          ch[static_cast<int64_t>(row) * a.n + col] = from_f32<Tc>(s);
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
        if (has_col && row < a.m) {
          ch[static_cast<int64_t>(row) * a.n + col] = from_f32<Tc>(s);
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
// most 512), a warp on 32 columns; `cluster` blocks form one cluster.  A
// cluster size or shared-memory size the card refuses is returned as the
// launch's error.  kGathered: b is G = B[cols] (NNZP x N) and cols is not
// read; c is of type Tc.
template <typename Tv, typename Tb, typename Idx, typename Tc = Tb,
          bool kGathered = false>
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
  const int threads = groups * n_tile;
  // a plan without split windows and a block of one group of several
  // warps: one ring for the block
  const bool block_ring = !split && n_tile > 32;
  if (block_ring && groups != 1) return cudaErrorInvalidValue;
  const int64_t medium_tasks = (num_medium + cluster - 1) / cluster;
  const int64_t pack = static_cast<int64_t>(cluster) * groups;
  const int64_t tasks =
      num_long + medium_tasks + (num_windows + pack - 1) / pack;
  if (tasks * cluster > 0x7fffffff) return cudaErrorInvalidValue;

  const WindowArgs<Tv, Tb, Tc> args{static_cast<const int*>(win_ptr),
                                    static_cast<const int*>(cols),
                                    static_cast<const Tv*>(vals),
                                    static_cast<const float*>(scales),
                                    static_cast<const Tb*>(b),
                                    static_cast<Tc*>(c),
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
  auto by_v = [&](auto vt) {
    constexpr int V = decltype(vt)::value;
    constexpr size_t ring = sizeof(WindowRing<V, Tv>);
    if (split) {
      return run(spmm_window_kernel<V, true, false, Tv, Tb, Idx, Tc, kGathered>,
                 ring);
    }
    if (block_ring) {
      return run(spmm_window_kernel<V, false, true, Tv, Tb, Idx, Tc, kGathered>,
                 ring);
    }
    return run(spmm_window_kernel<V, false, false, Tv, Tb, Idx, Tc, kGathered>,
               ring);
  };
  if (v == 8) return by_v(std::integral_constant<int, 8>{});
  if (v == 16) return by_v(std::integral_constant<int, 16>{});
  return cudaErrorInvalidValue;
}

}  // namespace repro
