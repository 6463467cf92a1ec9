// The SDDMM tile on the tensor cores, shared by sddmm.cu (one head),
// sddmm_batched.cu (a grid of H heads) and sddmm_balanced.cu (the
// Schedule's block list): S[h] = mask * (Q[h] @ K[h]^T), written in the
// blocked (NNZP, V) layout that the following SpMM reads, templated on the
// element type T of Q, K and S (float or bf16).
//
// What bounds it: bytes.  Each sampled row (a nonzero vector of the
// blocked view) needs a gathered K row, its window's V rows of Q and V
// outputs; the 2 * V * F flops a row are far below the tensor cores' rate
// for that traffic.  What costs time beyond the bytes is reading a row
// more than once, loads that leave sectors half used, and the latency of
// each tile's chain of dependent loads (block -> column id -> K row).
//
// Design: FlashSparse's swap-and-transpose on mma.sync m16n8k8 (TF32).  A
// warp takes a tile of 16 consecutive sampled rows t0 .. t0 + 15 and
// computes S_tile (16 x V) = K[cols[t0 ..]] (16 x F) . Q_w^T (F x V) with
// the window's V = 8 rows on the n side (V = 16: two n8 tiles): row i of
// the accumulator is sampled row t0 + i, already the layout S is stored
// in.  F is streamed in chunks of 32 features, any F: a lane loads eight
// neighbouring features of its two K rows (gid and gid + 8) and of its Q
// row (16 bytes for bf16, two 16-byte loads for fp32), so the 4 lanes of
// a row read its 64 (bf16) or 128 (fp32) contiguous bytes and every
// sector is used whole; a chunk is four k-steps of 8, k-step s taking
// features 8 tig + 2 s and + 1 at the fragment's k = tig and tig + 4 (the
// same permutation of k on both operands, so the sum is unchanged).  A
// tile reads its K rows once and its window's Q rows once, not once a
// sampled row as one thread a row did, and a stage of one or two chunks
// (F up to 32 or 64) is in flight at once.  Features past F read as
// zero: a chunk past F is not issued, and one that F cuts adds exact
// zeros.  Rows whose F or base address do not allow the 16-byte loads (F
// not a multiple of 4 for fp32, of 8 for bf16) load one element at a time
// into the same places, so both paths give the same bits.
//   * Windows: a tile's rows may belong to several windows (two at
//     k_blk = 8, up to four at k_blk = 4, more at smaller k_blk).  The
//     warp takes one n8 product per distinct window, reusing the tile's K
//     fragments, and each lane keeps the results of the rows (of its two)
//     that belong to that window: it passes its accumulator into every
//     product and keeps the result only on a match.  An element of an mma
//     result depends only on its row of A, its column of B and its own
//     accumulator, so a sampled row's value is the same chain of products
//     whatever tile holds it and whatever windows share the tile: the
//     window, head-grid and balanced SDDMMs give the same bits per row.
//     Against a host-built plan that pairs only same-window K-blocks, this
//     costs one extra product a k-step on tiles that straddle a window
//     (no extra bytes: each window's Q rows are needed anyway) and no plan.
//   * Latency: a warp walks a contiguous run of tiles.  The column ids
//     and windows of the next two tiles are loaded while a tile computes,
//     the mask bytes are loaded with the K rows, and when one stage holds
//     all of F a window's Q rows stay in registers from one tile to the
//     next (a window of the attention pattern spans about 9 tiles), so Q
//     is read about once a window and a warp, not once a tile.  The rest
//     of the latency is hidden by the warps an SM holds, which registers
//     bound; keeping a second tile's operands in flight, in registers or
//     in shared memory by cp.async, cost more warps than it hid.
//   * Precision: fp32 operands in 3xTF32 (tf32.cuh), fp32 accumulators,
//     S = (big.big + small products) * mask.  Each k-step's big.big
//     product is taken from a zero accumulator and added to the running
//     sum by an fp32 add, which rounds to nearest: the tensor cores' own
//     accumulation does not, and over the 188 k-steps of F = 1,500 its
//     error grows past the kernel tolerance of an attention over the
//     scores.  bf16 operands are widened as they are read and are exact
//     in TF32: the same instruction sequence without the small products,
//     so the bf16 kernel is bitwise the fp32 kernel on widened operands,
//     rounded once, at the store.
//   * A head reads Q and K at its own offsets, h * q_hstride and
//     h * k_hstride (0: shared by every head, one copy), and writes its
//     own (rows, V) slice; the arithmetic of a row does not depend on the
//     head, so H heads in one launch give bitwise the output of H one-head
//     launches.
//   * Q rows past M read as zero, as the reference's zero-padded Q does.
//     The dummy block of an all-empty matrix is covered by the window
//     SDDMMs; its mask is all False, so it writes zeros.  Offsets of rows,
//     heads and features are 64-bit.  No atomics: a second launch gives
//     the same bits.
// The mask arrives as one byte per element (torch.bool), a quarter of the
// reference's f32 copy; the arithmetic is the same.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

namespace repro {

constexpr int kSddmmWarps = 4;  // warps per block
constexpr int kSddmmTile = 16;  // sampled rows per warp tile (mma m16)
constexpr int kSddmmTilesPerWarp = 8;  // a warp's run of tiles
// Blocks an SM must hold: bf16 tiles of one stage fit 32 warps an SM in
// 64 registers; the others take what their registers allow.
template <typename T, int KC>
constexpr int kSddmmMinBlocks =
    !std::is_same<T, float>::value && KC == 1 ? 8 : 1;

// Sampled row u of the window SDDMMs: output row u, window
// block_win[u / k_blk].
struct WindowRows {
  const int* block_win;
  int k_blk;
  __device__ __forceinline__ void operator()(int64_t u, int64_t& row,
                                             int& win) const {
    row = u;
    win = __ldg(block_win + u / k_blk);
  }
};

// Scheduled row u of the balanced SDDMM: row u % k_blk of scheduled block
// blk_id[u / k_blk], whose window is blk_win[u / k_blk].
struct ScheduledRows {
  const int* blk_id;
  const int* blk_win;
  int k_blk;
  __device__ __forceinline__ void operator()(int64_t u, int64_t& row,
                                             int& win) const {
    const int64_t i = u / k_blk;
    row = static_cast<int64_t>(__ldg(blk_id + i)) * k_blk + (u - i * k_blk);
    win = __ldg(blk_win + i);
  }
};

// Eight neighbouring features as loaded: fp32 in two float4s, bf16 as the
// raw bits of eight in a uint4 (widened when the fragments are built, so a
// loaded tile of bf16 takes half the registers).
struct F32x8 {
  float4 lo, hi;
};
template <typename T>
struct RawOf {
  using type = F32x8;
};
template <>
struct RawOf<__nv_bfloat16> {
  using type = uint4;
};
template <typename T>
using Raw = typename RawOf<T>::type;

template <typename T>
__device__ __forceinline__ Raw<T> raw_zero() {
  if constexpr (std::is_same<T, float>::value) {
    return F32x8{make_float4(0.f, 0.f, 0.f, 0.f),
                 make_float4(0.f, 0.f, 0.f, 0.f)};
  } else {
    return make_uint4(0u, 0u, 0u, 0u);
  }
}

// Features c .. c + 7 of a row of T, zero past f: 16-byte loads when kVec
// (fp32: f a multiple of 4, two loads; bf16: f a multiple of 8, one load;
// rows 16-byte aligned), else one element at a time into the same places.
template <bool kVec, typename T>
__device__ __forceinline__ Raw<T> load_raw(const T* row, int c, int f) {
  Raw<T> x = raw_zero<T>();
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (kVec) {
      if (c < f) x.lo = __ldg(reinterpret_cast<const float4*>(row + c));
      if (c + 4 < f) x.hi = __ldg(reinterpret_cast<const float4*>(row + c + 4));
    } else {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = c + e < f ? __ldg(row + c + e) : 0.f;
      x.lo = make_float4(v[0], v[1], v[2], v[3]);
      x.hi = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
    if constexpr (kVec) {
      if (c < f) x = __ldg(reinterpret_cast<const uint4*>(row + c));
    } else {
      const auto* p = reinterpret_cast<const unsigned short*>(row);
      unsigned v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = c + e < f ? __ldg(p + c + e) : 0u;
      x = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                     v[6] | v[7] << 16);
    }
  }
  return x;
}

// Element e (0 .. 7, a constant after unrolling) widened to fp32: a bf16
// is the top half of the fp32 with the same value.
__device__ __forceinline__ float elem(const F32x8& x, int e) {
  const float4& h = e < 4 ? x.lo : x.hi;
  const int i = e & 3;
  return i == 0 ? h.x : i == 1 ? h.y : i == 2 ? h.z : h.w;
}
__device__ __forceinline__ float elem(const uint4& x, int e) {
  const int i = e >> 1;
  const unsigned w = i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
  return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
}

// One lane's share of a tile's index data: sampled row t0 + (lane & 15)
// (zeros past the last row).
struct TileRow {
  int64_t row;  // output row
  int win;
  int col;
};

template <typename Map>
__device__ __forceinline__ TileRow fetch_row(const Map& map,
                                             const int* __restrict__ cols,
                                             int64_t tile, int64_t rows,
                                             int lane) {
  TileRow r{0, 0, 0};
  const int64_t u = tile * kSddmmTile + (lane & 15);
  if (u < rows) {
    map(u, r.row, r.win);
    r.col = __ldg(cols + r.row);
  }
  return r;
}

// The tensor-core tile (see the header).  V: window rows (8 or 16: one or
// two n8 tiles); KC: chunks of 32 features a stage (1 for F <= 32, else
// 2); kVec: 16-byte loads; T: element type of Q, K and S; Map: sampled
// row -> (output row, window).  Warp w of block b walks the
// kSddmmTilesPerWarp tiles from (b kSddmmWarps + w) kSddmmTilesPerWarp on,
// in order; heads on gridDim.y.
template <int V, int KC, bool kVec, typename T, typename Map>
__global__ void __launch_bounds__(kSddmmWarps * 32, kSddmmMinBlocks<T, KC>)
sddmm_tile_kernel(Map map, const int* __restrict__ cols,
                  const T* __restrict__ q, const T* __restrict__ k,
                  const uint8_t* __restrict__ mask, T* __restrict__ out,
                  int m, int f, int64_t rows, int64_t q_hstride,
                  int64_t k_hstride, int64_t out_hstride) {
  constexpr int NT = V / 8;
  constexpr bool kExact = !std::is_same<T, float>::value;  // bf16 operands
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t h = blockIdx.y;
  q += h * q_hstride;
  k += h * k_hstride;
  out += h * out_hstride;
  const int64_t ntiles = (rows + kSddmmTile - 1) / kSddmmTile;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kSddmmWarps + (threadIdx.x >> 5)) *
      kSddmmTilesPerWarp;
  const int64_t last = first + kSddmmTilesPerWarp;
  const int64_t end = last < ntiles ? last : ntiles;
  if (first >= end) return;  // warp-uniform
  // One stage holds all of F: a window's Q rows stay in registers from one
  // tile to the next (qv_w: their window, -1 for none).
  const bool keep_q = f <= 32 * KC;

  // Q rows of window w at stage c0 (zero past M)
  auto load_q = [&](int w, Raw<T> (&qv)[NT][KC], int c0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int64_t qr = static_cast<int64_t>(w) * V + nt * 8 + gid;
#pragma unroll
      for (int cc = 0; cc < KC; ++cc) {
        qv[nt][cc] = qr < m ? load_raw<kVec>(q + qr * f, c0 + 32 * cc + 8 * tig,
                                             f)
                            : raw_zero<T>();
      }
    }
  };
  Raw<T> qv[NT][KC];
  int qv_w = -1;
  TileRow cur = fetch_row(map, cols, first, rows, lane);
  TileRow nxt = first + 1 < end ? fetch_row(map, cols, first + 1, rows, lane)
                                : TileRow{0, 0, 0};
  for (int64_t tile = first; tile < end; ++tile) {
    const TileRow nxt2 = tile + 2 < end
                             ? fetch_row(map, cols, tile + 2, rows, lane)
                             : TileRow{0, 0, 0};
    const int64_t u0 = tile * kSddmmTile;
    const bool ok = u0 + (lane & 15) < rows;
    const bool ok_a = u0 + gid < rows, ok_b = u0 + gid + 8 < rows;
    const int64_t row_a = __shfl_sync(kFullMask, cur.row, gid);
    const int64_t row_b = __shfl_sync(kFullMask, cur.row, gid + 8);
    const int win_a = __shfl_sync(kFullMask, cur.win, gid);
    const int win_b = __shfl_sync(kFullMask, cur.win, gid + 8);
    const T* krow_a =
        k + static_cast<int64_t>(__shfl_sync(kFullMask, cur.col, gid)) * f;
    const T* krow_b =
        k + static_cast<int64_t>(__shfl_sync(kFullMask, cur.col, gid + 8)) * f;
    // mask bytes (two a row and n8 tile), in flight with the K rows
    unsigned mk[2][NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * tig;
      mk[0][nt] = ok_a ? __ldg(reinterpret_cast<const unsigned short*>(
                             mask + row_a * V + c))
                       : 0u;
      mk[1][nt] = ok_b ? __ldg(reinterpret_cast<const unsigned short*>(
                             mask + row_b * V + c))
                       : 0u;
    }
    // the tile's distinct windows, the j-th held by lane j
    unsigned pending = __ballot_sync(kFullMask, ok) & 0xffffu;
    int my_w = 0, nw = 0;
    while (pending) {
      const int w = __shfl_sync(kFullMask, cur.win, __ffs(pending) - 1);
      pending &= ~__ballot_sync(kFullMask, ok && cur.win == w);
      if (lane == nw) my_w = w;
      ++nw;
    }

    float hi[NT][4], lo[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) hi[nt][i] = lo[nt][i] = 0.f;
    }
    for (int c0 = 0; c0 < f; c0 += 32 * KC) {
      Raw<T> ka[KC], kb[KC];
#pragma unroll
      for (int cc = 0; cc < KC; ++cc) {
        const int c = c0 + 32 * cc + 8 * tig;
        ka[cc] = ok_a ? load_raw<kVec>(krow_a, c, f) : raw_zero<T>();
        kb[cc] = ok_b ? load_raw<kVec>(krow_b, c, f) : raw_zero<T>();
      }
      const int w0 = __shfl_sync(kFullMask, my_w, 0);
      if (!(keep_q && w0 == qv_w)) load_q(w0, qv, c0);
      for (int j = 0; j < nw; ++j) {
        const int w = __shfl_sync(kFullMask, my_w, j);
        const bool more = j + 1 < nw;
        Raw<T> qn[NT][KC];
        if (more) load_q(__shfl_sync(kFullMask, my_w, j + 1), qn, c0);
        const bool keep_a = win_a == w, keep_b = win_b == w;
#pragma unroll
        for (int cc = 0; cc < KC; ++cc) {
          if (c0 + 32 * cc < f) {
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              Frag<4, kExact> a;
              a.set(0, elem(ka[cc], 2 * s));
              a.set(1, elem(kb[cc], 2 * s));
              a.set(2, elem(ka[cc], 2 * s + 1));
              a.set(3, elem(kb[cc], 2 * s + 1));
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                Frag<2, kExact> b;
                b.set(0, elem(qv[nt][cc], 2 * s));
                b.set(1, elem(qv[nt][cc], 2 * s + 1));
                // the k-step's big.big product from a zero accumulator,
                // added to hi by an fp32 add (the tensor cores' own sum
                // does not round to nearest, and hi grows with F); the
                // small products, 2^-11 of it, accumulate in the mma
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                if (nw == 1) {
                  mma_3xtf32(d, lo[nt], a, b);
#pragma unroll
                  for (int i = 0; i < 4; ++i) hi[nt][i] += d[i];
                } else {
                  float dl[4];
#pragma unroll
                  for (int i = 0; i < 4; ++i) dl[i] = lo[nt][i];
                  mma_3xtf32(d, dl, a, b);
#pragma unroll
                  for (int i = 0; i < 4; ++i) {
                    const bool keep = i < 2 ? keep_a : keep_b;
                    hi[nt][i] = keep ? hi[nt][i] + d[i] : hi[nt][i];
                    lo[nt][i] = keep ? dl[i] : lo[nt][i];
                  }
                }
              }
            }
          }
        }
        if (more) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int cc = 0; cc < KC; ++cc) qv[nt][cc] = qn[nt][cc];
          }
        }
      }
      qv_w = keep_q ? __shfl_sync(kFullMask, my_w, nw - 1) : -1;
    }

    // S = acc * mask: columns nt * 8 + 2 tig and + 1 of rows a and b
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (hh ? ok_b : ok_a) {
        const int64_t row = hh ? row_b : row_a;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned bits = mk[hh][nt];
          const float x0 = (hi[nt][2 * hh] + lo[nt][2 * hh]) *
                           ((bits & 0xffu) ? 1.f : 0.f);
          const float x1 = (hi[nt][2 * hh + 1] + lo[nt][2 * hh + 1]) *
                           ((bits >> 8) ? 1.f : 0.f);
          T* o = out + row * V + nt * 8 + 2 * tig;
          if constexpr (std::is_same<T, float>::value) {
            *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(x0, x1);
          }
        }
      }
    }
    cur = nxt;
    nxt = nxt2;
  }
}


// Launches the tile kernel over `rows` sampled rows (mapped by `map`) for
// `heads` heads.  q (M, F) T with heads q_hstride elements apart (0:
// shared), k (Mc, F) T with heads k_hstride apart, mask (NNZP, V) bool,
// 2-byte aligned, out (heads, NNZP, V) T with heads out_hstride apart,
// 8-byte aligned (a fresh allocation).  heads at most 65,535.
template <typename T, typename Map>
cudaError_t launch_sddmm_tiles(const Map& map, const int* cols, const T* q,
                               const T* k, const uint8_t* mask, T* out,
                               int m, int f, int64_t rows, int heads, int v,
                               int64_t q_hstride, int64_t k_hstride,
                               int64_t out_hstride, cudaStream_t stream) {
  const int64_t ntiles = (rows + kSddmmTile - 1) / kSddmmTile;
  const int64_t per_block =
      static_cast<int64_t>(kSddmmWarps) * kSddmmTilesPerWarp;
  const dim3 grid(static_cast<unsigned>((ntiles + per_block - 1) / per_block),
                  heads);
  if (ntiles == 0) return cudaSuccess;
  if ((reinterpret_cast<uintptr_t>(mask) & 1) != 0) {
    return cudaErrorMisalignedAddress;  // mask bytes are loaded 2 at a time
  }
  // The vector loads need 16-byte aligned rows: F a multiple of 4 (fp32)
  // or 8 (bf16) makes every row and every head stride so once the base
  // pointers are.
  constexpr int kPer16 = 16 / sizeof(T);
  const bool vec = f % (std::is_same<T, float>::value ? 4 : kPer16) == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0;
  auto run = [&](auto vt, auto kct, auto vect) {
    constexpr int V = decltype(vt)::value;
    constexpr int KC = decltype(kct)::value;
    constexpr bool kVec = decltype(vect)::value;
    sddmm_tile_kernel<V, KC, kVec, T, Map><<<grid, kSddmmWarps * 32, 0,
                                             stream>>>(
        map, cols, q, k, mask, out, m, f, rows, q_hstride, k_hstride,
        out_hstride);
    return cudaGetLastError();
  };
  auto by_vec = [&](auto vt, auto kct) {
    return vec ? run(vt, kct, std::true_type{})
               : run(vt, kct, std::false_type{});
  };
  auto by_kc = [&](auto vt) {
    return f <= 32 ? by_vec(vt, std::integral_constant<int, 1>{})
                   : by_vec(vt, std::integral_constant<int, 2>{});
  };
  if (v == 8) return by_kc(std::integral_constant<int, 8>{});
  if (v == 16) return by_kc(std::integral_constant<int, 16>{});
  return cudaErrorInvalidValue;
}

// The window SDDMMs (sddmm.cu, sddmm_batched.cu): every row of the blocked
// view.  block_win (NB,) int32, cols (NB * k_blk,) int32; out (heads, NB *
// k_blk, V).
template <typename T>
cudaError_t launch_sddmm_rows(const void* block_win, const void* cols,
                              const void* q, const void* k, const void* mask,
                              void* out, int m, int f, int num_blocks,
                              int heads, int v, int k_blk, int64_t q_hstride,
                              int64_t k_hstride, void* stream) {
  const int64_t rows = static_cast<int64_t>(num_blocks) * k_blk;
  return launch_sddmm_tiles<T>(
      WindowRows{static_cast<const int*>(block_win), k_blk},
      static_cast<const int*>(cols), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), m, f, rows, heads, v, q_hstride, k_hstride,
      rows * v, static_cast<cudaStream_t>(stream));
}

}  // namespace repro
