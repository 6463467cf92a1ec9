// The tensor-core chunk step of the fused attentions and the helpers of
// their rings of asynchronous copies.  The window attention (attention.cu,
// one warp on a range of windows) shares the helpers and the layout and
// keeps its own copy of the step (the mma's own accumulation of big.big,
// its machine code unchanged); the run-carried one (attention_balanced.cu,
// one warp on a run's pieces) runs Tile::step.
//
// FlashSparse's swap-and-transpose on mma.sync m16n8k8 (TF32) with the
// window's V = 8 query rows on the n side (V = 16: two n8 tiles).  Per
// chunk of 32 of a window's vectors:
//   1. scores: S^T (32 x V) = K[cols] (32 x D) . Q_w^T (D x V), two m16
//      tiles, D in steps of 8;
//   2. the online softmax per window row (a column of S^T): the chunk's
//      max and sum over the 8 lanes that hold the column (3 shuffles each,
//      two columns per lane per n8 tile), m_new = max(m, max_r s),
//      alpha = exp(m - m_new), p = exp(s - m_new) * maskf (multiplied
//      after the exp, so a fully masked chunk adds 0 and alpha stays 1; a
//      masked score is -FLT_MAX, not -inf), l = alpha * l + sum_r p;
//   3. output: acc^T (DV x V) = alpha * acc^T + Vmat[cols]^T (DV x 32) .
//      P^T (32 x V), DV in m16 tiles, the accumulator in registers; P goes
//      from the score fragments' layout to the B operand's through shared
//      memory.
// The chunk's Vmat rows go straight into the registers of the output's A
// operand (Tile::load_v), loaded before the scores are computed and used
// after the softmax: a lane takes four neighbouring columns of a row in
// one 16-byte load, and the m16 tiles' rows are a permutation of DV that
// makes them its fragment values (Tile::col gives each value's column).
// Precision: each fp32 operand x is split into big = tf32(x) and small =
// tf32(x - big), and a . b is taken as big.big + big.small + small.big
// with fp32 accumulators (3xTF32; big.big and the small products in two,
// so two chains of dependent mma run side by side), each k-step's big.big
// from a zero accumulator, added by an fp32 add (Tile::product).  bf16 K,
// Q and Vmat are exact in TF32: S takes one product (big.big), P . Vmat
// two (P's big and small parts against Vmat's big part), and each skipped
// product is an exact zero, so the bf16 tile is the fp32 tile on the
// widened operands, bit for bit.  The exponentials take the hardware's
// ex2 (__expf).
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

namespace repro {
namespace attn {

constexpr int kChunk = 32;     // vectors per online-softmax step
constexpr int kPStride = 36;   // P^T row stride (floats): conflict-free

// Shared memory of one warp, in bytes: K rows of two chunks (none when
// k_ring is false: the fragments are then loaded from global memory) and
// Q rows of two windows (elements of T), P^T (floats), mask bytes of two
// chunks, the two chunks' mbarriers (a multiple of 16 bytes in all, every
// part 16-byte aligned).  The row stride of K and Q, dp elements, is D
// padded to a multiple of 8, + 16 bytes: the fragment loads then hit
// distinct banks.
struct Layout {
  int dp, k, q, p, mask, bar, total;
};

__host__ __device__ __forceinline__ Layout layout(int vsz, int d, int elt,
                                                  bool k_ring = true) {
  Layout s;
  s.dp = (d + 7) / 8 * 8 + 16 / elt;
  s.k = 0;
  s.q = s.k + (k_ring ? 2 * kChunk * s.dp * elt : 0);
  s.p = s.q + 2 * vsz * s.dp * elt;
  s.mask = s.p + 4 * vsz * kPStride;
  s.bar = s.mask + 2 * kChunk * vsz;  // two mbarriers, 8 bytes each
  s.total = s.bar + 16;
  return s;
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Copies `rows` rows of `width` elements, row r from src + idx(r) * width,
// into dst with row stride `stride`, skipping rows >= valid: 16 bytes at a
// time when vec, else one element at a time (cp.async of 4 bytes for fp32,
// a plain load for bf16, which the barrier before the chunk is used orders
// as it orders the copies).  idx is a lane's column id broadcast by
// shuffle, so every lane runs the same number of iterations.
template <typename T, typename Idx>
__device__ __forceinline__ void copy_rows(T* dst, int stride, const T* src,
                                          int width, int rows, int valid,
                                          bool vec, int lane, Idx idx) {
  constexpr int kPer16 = 16 / sizeof(T);
  if (vec) {
    const int segs = width / kPer16;
    for (int i = lane; i < rows * segs; i += 32) {
      const int r = i / segs, s = i - r * segs;
      const int64_t row = idx(r);
      if (r < valid) {
        cp_async16(dst + r * stride + kPer16 * s,
                   src + row * width + kPer16 * s);
      }
    }
  } else {
    for (int i = lane; i < rows * width; i += 32) {
      const int r = i / width, e = i - r * width;
      const int64_t row = idx(r);
      if (r < valid) {
        if constexpr (sizeof(T) == 4) {
          cp_async4(dst + r * stride + e, src + row * width + e);
        } else {
          dst[r * stride + e] = src[row * width + e];
        }
      }
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on mbarrier bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The one arrival of a slot's phase, expecting `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Sets up a warp's two mbarriers and zeroes the K and Q rows' padding
// columns (d up to the last k-step's end), which no copy writes and every
// k-step reads: with finite zeros there, a row's padded products are 0.
// Nothing else needs clearing: a slot row that a chunk does not fill (a K
// row past the chunk's vectors, a Q row past M) is read only into its
// own row or column of S^T, which the mask sets to -FLT_MAX, and P^T is
// written whole by every chunk.
template <typename T>
__device__ __forceinline__ void init_region(unsigned char* region,
                                            const Layout& L, int lane, int d) {
  const int pad = (d + 7) / 8 * 8 - d;
  if (pad) {
    T* rows = reinterpret_cast<T*>(region + L.k);
    const int n = (L.p - L.k) / (L.dp * static_cast<int>(sizeof(T)));
    for (int i = lane; i < n * pad; i += 32) {
      rows[(i / pad) * L.dp + d + i % pad] = narrow<T>(0.f);
    }
  }
  if (lane == 0) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(region + L.bar);
    for (int i = 0; i < 2; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bar + i))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
}

// One warp's softmax state and output accumulator over a window (or a
// run's piece of one): V window rows (8 or 16, one or two n8 tiles), MT
// m16 tiles of a band's DV columns (DV <= 16 * MT), two per group of 32
// columns; T the element type of Q, K and Vmat.  Lane (gid, tig) holds
// rows nt * 8 + 2 * tig + e of the window (row(nt, e)) and of acc^T the
// columns col(mt, hh) of those rows, in acc[nt][mt][e + 2 * hh] (big.big)
// and acc_lo (the small products), summed at the end.
template <int V, int MT, typename T>
struct Tile {
  static constexpr int NT = V / 8;
  static constexpr int BANDS = (MT + 1) / 2;
  static constexpr bool kExact = !std::is_same<T, float>::value;

  int gid, tig;
  float m_run[NT][2], l_run[NT][2], acc[NT][MT][4], acc_lo[NT][MT][4];
  // Vmat rows of the chunk as the output's A operand: for k-step ks,
  // vector ks * 8 + tig (h2 = 0) and + 4 (h2 = 1), band b, this lane's
  // columns 32 b + 4 gid .. + 3 (zero past DV and past the chunk).  Row
  // gid of m16 tile mt is column 32 (mt / 2) + 4 gid + 2 (mt % 2), row
  // gid + 8 the next column.
  float4 vf[4][2][BANDS];

  __device__ __forceinline__ explicit Tile(int lane)
      : gid(lane >> 2), tig(lane & 3) {}

  __device__ __forceinline__ int row(int nt, int e) const {
    return nt * 8 + 2 * tig + e;
  }
  __device__ __forceinline__ int col(int mt, int hh) const {
    return 32 * (mt / 2) + 4 * gid + 2 * (mt % 2) + hh;
  }
  // acc^T's value at (row(nt, e), col(mt, hh)), unnormalised.
  __device__ __forceinline__ float value(int nt, int e, int mt, int hh) const {
    return acc[nt][mt][e + 2 * hh] + acc_lo[nt][mt][e + 2 * hh];
  }

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m_run[nt][e] = -FLT_MAX;
        l_run[nt][e] = 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[nt][mt][i] = acc_lo[nt][mt][i] = 0.f;
        }
      }
    }
  }

  // The chunk's Vmat rows (cnt of them; lane r holds row r's id in col)
  // from vmat (rows ldv elements apart, dv columns): vvec, four columns a
  // load.
  __device__ __forceinline__ void load_v(const T* vmat, int ldv, int dv,
                                         bool vvec, int cnt, int col) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = ks * 8 + tig + 4 * h2;
        const int c = __shfl_sync(kFullMask, col, r);
        const T* row = vmat + static_cast<int64_t>(c) * ldv;
#pragma unroll
        for (int b = 0; b < BANDS; ++b) {
          const int c0 = 32 * b + 4 * gid;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < cnt && c0 < dv) {
            if (vvec) {
              if constexpr (kExact) {  // four bf16: the top halves of fp32s
                const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + c0));
                x = make_float4(__uint_as_float(u.x << 16),
                                __uint_as_float(u.x & 0xffff0000u),
                                __uint_as_float(u.y << 16),
                                __uint_as_float(u.y & 0xffff0000u));
              } else {
                x = __ldg(reinterpret_cast<const float4*>(row + c0));
              }
            } else {
              x.x = widen(row[c0]);
              if (c0 + 1 < dv) x.y = widen(row[c0 + 1]);
              if (c0 + 2 < dv) x.z = widen(row[c0 + 2]);
              if (c0 + 3 < dv) x.w = widen(row[c0 + 3]);
            }
          }
          vf[ks][h2][b] = x;
        }
      }
    }
  }

  // hi, lo after a . b (mma_3xtf32), a's big.big product taken from a
  // zero accumulator and added to hi by fp32 adds, which round to nearest
  // (the tensor cores' own accumulation does not, and over the k-steps of
  // a wide D, or the chunks of a long piece, its error grows past the
  // kernel tolerance; sddmm_rows.cuh); the small products, 2^-11 of it,
  // accumulate in lo's mma chain.
  template <bool kAExact, bool kBExact>
  __device__ __forceinline__ static void product(
      float (&hi)[4], float (&lo)[4], const Frag<4, kAExact>& a,
      const Frag<2, kBExact>& b) {
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    mma_3xtf32(z, lo, a, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) hi[i] += z[i];
  }

  // One chunk of cnt vectors (see the header): kget(j, c) is feature c of
  // the chunk's K row 8 j + gid (j = 0..3, zero past D), sq the window's
  // Q rows (row stride dp, zero-padded to d8 steps of 8), sm its mask bytes
  // (V a vector), s_p the warp's P^T; dv columns of the band.
  template <typename KGet>
  __device__ __forceinline__ void step(KGet kget, const T* sq, int dp, int d8,
                                       const uint8_t* sm, float* s_p, int cnt,
                                       int dv) {
    // S^T in two parts, big.big and the small products
    float sc[NT][2][4], sc_lo[NT][2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[nt][mt][i] = sc_lo[nt][mt][i] = 0.f;
      }
    }
    for (int ks = 0; ks < d8; ++ks) {
      const int c0 = ks * 8 + tig;
      Frag<2, kExact> bq[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* qr = sq + (nt * 8 + gid) * dp;
        bq[nt].set(0, widen(qr[c0]));
        bq[nt].set(1, widen(qr[c0 + 4]));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        Frag<4, kExact> a;
        a.set(0, kget(2 * mt, c0));
        a.set(1, kget(2 * mt + 1, c0));
        a.set(2, kget(2 * mt, c0 + 4));
        a.set(3, kget(2 * mt + 1, c0 + 4));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          product(sc[nt][mt], sc_lo[nt][mt], a, bq[nt]);
        }
      }
    }

#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = row(nt, e);  // window row (column of S^T)
        float s[2][2], keep[2][2];
        float mx = -FLT_MAX;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = mt * 16 + gid + 8 * hh;
            keep[mt][hh] = (r < cnt && sm[r * V + c]) ? 1.f : 0.f;
            const int i = e + 2 * hh;
            const float x = sc[nt][mt][i] + sc_lo[nt][mt][i];
            s[mt][hh] = keep[mt][hh] > 0.f ? x : -FLT_MAX;
            mx = fmaxf(mx, s[mt][hh]);
          }
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
        }
        const float m_new = fmaxf(m_run[nt][e], mx);
        const float alpha = __expf(m_run[nt][e] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float pv = __expf(s[mt][hh] - m_new) * keep[mt][hh];
            psum += pv;
            s_p[c * kPStride + mt * 16 + gid + 8 * hh] = pv;
          }
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          psum += __shfl_xor_sync(kFullMask, psum, off);
        }
        l_run[nt][e] = l_run[nt][e] * alpha + psum;
        m_run[nt][e] = m_new;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[nt][mt][e] *= alpha;
          acc[nt][mt][e + 2] *= alpha;
          acc_lo[nt][mt][e] *= alpha;
          acc_lo[nt][mt][e + 2] *= alpha;
        }
      }
    }
    __syncwarp();  // P^T in shared memory

#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      const int r0 = ks * 8 + tig;
      Frag<2> bp[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* pr = s_p + (nt * 8 + gid) * kPStride;
        bp[nt].set(0, pr[r0]);
        bp[nt].set(1, pr[r0 + 4]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (32 * (mt / 2) + 2 * (mt % 2) < dv) {
          const float4& x0 = vf[ks][0][mt / 2];
          const float4& x1 = vf[ks][1][mt / 2];
          Frag<4, kExact> a;
          a.set(0, mt % 2 ? x0.z : x0.x);
          a.set(1, mt % 2 ? x0.w : x0.y);
          a.set(2, mt % 2 ? x1.z : x1.x);
          a.set(3, mt % 2 ? x1.w : x1.y);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            product(acc[nt][mt], acc_lo[nt][mt], a, bp[nt]);
          }
        }
      }
    }
  }
};

}  // namespace attn
}  // namespace repro
