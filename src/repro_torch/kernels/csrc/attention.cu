// Single-pass fused sparse attention over the blocked ME-BCRS pattern:
// out[h] = softmax_rows(mask * (Q_s[h] @ K[h]^T)) @ Vmat[h] for H heads in
// one launch, with Q_s = scale * Q folded in before the launch (one scale
// for every head); Q, K, Vmat and out all fp32 or all bf16, the scores,
// the softmax and the sums in fp32.  Q, K and Vmat are each either per
// head or shared by every head.  One launch covers a band of at most 128
// columns of Vmat and out (their rows ldv and ldo elements apart); the
// wrapper launches once per band.
//
// Replaces: src/repro/kernels/attention_pallas.py, _fused_attn_kernel
// (launched through attention_pallas), with its bf16 variant.
//
// Bound on the card: bytes.  Each input read once and the output written
// once is Q (M x D) + K, Vmat (Mc x D, Mc x DV), each per distinct head, +
// mask (NNZP x V bytes) + cols (NNZP) + win_ptr + out (H x M x DV); scores
// and probabilities never reach device memory.  The work, about
// 2 * H * nnz * (D + DV) flops plus one exp per score, runs on the tensor
// cores, whose rate (495 TFLOP/s TF32, three products per multiply here)
// leaves bytes the bound; at 12 heads of width 64 the fp32 rate of the
// CUDA cores would not.
//
// Design: FlashSparse's swap-and-transpose on mma.sync m16n8k8 (TF32) with
// the window's V = 8 query rows on the n side.  One warp walks a range of
// consecutive windows of one head (heads on gridDim.y); per chunk of 32 of
// a window's vectors:
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
// V = 16 is two n8 tiles.  The next chunk's gathered K rows, and at a
// window's first chunk the window's Q rows, are copied into shared memory
// while the current chunk computes, double-buffered: one bulk copy
// (cp.async.bulk, completing on an mbarrier of the slot) per row when D is
// a multiple of 4, else cp.async 4 bytes at a time; the mask bytes by
// cp.async; the column ids are loaded a chunk before that.  The stream of
// chunks runs across the windows of a warp's range (the wrapper sizes the
// ranges: short windows, longer ranges), so a window's first loads are in
// flight during the last chunk of the window before.  The current chunk's
// Vmat rows go straight into the registers of the output's A operand,
// loaded before the scores are computed and used after the softmax: a
// lane takes four neighbouring columns of a row in one 16-byte load, and
// the m16 tiles' rows are a permutation of DV that makes them its fragment
// values (the epilogue stores each row at its column).  Shared memory thus
// holds K and Q only, and an SM keeps twice the warps in flight that
// staging Vmat there too allowed.  D that is not a multiple of 8 is
// zero-padded in shared memory, whose row strides avoid bank conflicts on
// the fragment loads; columns of Vmat past DV are loaded as zeros.
// Precision: each fp32 operand x is split into big = tf32(x) and small =
// tf32(x - big), and a . b is taken as big.big + big.small + small.big
// with fp32 accumulators (3xTF32; big.big and the small products in two,
// so two chains of dependent mma run side by side): plain TF32 keeps
// about 10 mantissa bits, the split about 21.
// bf16 (the reference's bf16 path): K, Q and Vmat rows are staged in
// shared memory and registers at 2 bytes a value, half the fp32 rings,
// and widened to fp32 at the fragment loads.  A bf16 value is exact in
// TF32 (its small part is 0), so S = K . Q^T takes one TF32 product
// (big.big, exact products, fp32 sums) and P . Vmat two (P's big and
// small parts against Vmat's big part); P stays fp32, as the reference's
// body upcasts Vmat, not P.  The result is rounded to bf16 once, at the
// store (round to nearest even).  The exponentials take the
// hardware's ex2 (__expf: 2 + 1.16 |x| ulp, so only probabilities far below
// a row's largest, which add little to it, see more than a few ulp).
// The reference updates m and l once per K-block; here they are updated
// once per 32 vectors.  The online softmax is exact under any grouping,
// so only the rounding differs.  The epilogue divides by max(l, 1e-20),
// so empty windows and rows give 0, and does not write rows >= M.  The
// mask arrives as one byte per element (torch.bool), a quarter of the
// reference's f32 copy; the semantics are the same.  A head reads Q, K
// and Vmat at its own offsets (h * q_hstride, ...; a stride of 0 shares
// the operand's one copy), the pattern is shared, and a window's
// arithmetic depends neither on the head nor on the windows walked
// before it, so H heads in one launch give bitwise the output of H
// one-head launches.
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "tf32.cuh"

namespace {

constexpr int kChunk = 32;     // vectors per online-softmax step
constexpr int kPStride = 36;   // P^T row stride (floats): conflict-free
constexpr int kMaxWindowsPerWarp = 16;  // win_ptr entries: a lane each

using repro::cp_async16;
using repro::cp_async4;
using repro::Frag;
using repro::mma_3xtf32;
using repro::widen;

// Shared memory of the one warp of a block, in bytes: K rows of two
// chunks and Q rows of two windows (elements of T), P^T (floats), mask
// bytes of two chunks, the two chunks' mbarriers (a multiple of 16 bytes
// in all, every part 16-byte aligned).  The row stride of K and Q, dp
// elements, is D padded to a multiple of 8, + 16 bytes: the fragment
// loads then hit distinct banks.
struct Layout {
  int dp, k, q, p, mask, bar, total;
};

__host__ __device__ __forceinline__ Layout layout(int vsz, int d, int elt) {
  Layout s;
  s.dp = (d + 7) / 8 * 8 + 16 / elt;
  s.k = 0;
  s.q = s.k + 2 * kChunk * s.dp * elt;
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

struct Pos {
  int w;       // window (== the range's end when the stream is done)
  int64_t t0;  // first vector of the chunk
};

// V: window rows (8 or 16, one or two n8 tiles); MT: m16 tiles of the
// band's DV columns (DV <= 16 * MT), two per group of 32 columns; T: the
// element type of Q, K, Vmat and out.
template <int V, int MT, typename T>
__global__ void __launch_bounds__(32)
attention_kernel(const int* __restrict__ win_ptr, const int* __restrict__ cols,
                 const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ vmat,
                 const uint8_t* __restrict__ mask, T* __restrict__ out,
                 int m, int d, int dv, int ldv, int ldo, int k_blk,
                 int num_windows, int wpw, int64_t q_hstride,
                 int64_t k_hstride, int64_t v_hstride) {
  constexpr int NT = V / 8;
  constexpr int BANDS = (MT + 1) / 2;
  constexpr bool kExact = !std::is_same<T, float>::value;  // bf16 operands
  constexpr int kElt = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t h = blockIdx.y;
  q += h * q_hstride;
  k += h * k_hstride;
  vmat += h * v_hstride;
  out += h * static_cast<int64_t>(m) * ldo;
  const Layout L = layout(V, d, kElt);
  T* s_k = reinterpret_cast<T*>(smem + L.k);
  T* s_q = reinterpret_cast<T*>(smem + L.q);
  float* s_p = reinterpret_cast<float*>(smem + L.p);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem + L.mask);
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  // Every slot a chunk does not fill (padding columns, rows past a
  // window's last vector) holds finite values: zeros, or an earlier
  // chunk's rows, multiplied by p = 0.
  for (int i = lane; i < L.bar / 16; i += 32) {
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (lane == 0) {
    for (int i = 0; i < 2; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(s_bar + i))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  const int wa = blockIdx.x * wpw;
  const int wb = min(wa + wpw, num_windows);
  // lane i holds win_ptr[wa + i] for i <= wb - wa
  const int wp_lane = lane <= wb - wa ? win_ptr[wa + lane] : 0;
  auto lo = [&](int w) {
    const int wp = __shfl_sync(repro::kFullMask, wp_lane, w - wa);
    return static_cast<int64_t>(wp) * k_blk;
  };
  auto aligned16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool kvec = d % (16 / kElt) == 0 && aligned16(k);
  const bool qvec = d % (16 / kElt) == 0 && aligned16(q);
  // four neighbouring columns of Vmat in one load (16 bytes fp32, 8 bf16)
  const bool vvec = dv % 4 == 0 && ldv % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(vmat) & (4 * kElt - 1)) == 0;
  const bool bulk = kvec && qvec;
  unsigned parity = 0;  // bit sl: the phase of slot sl's mbarrier

  // Empty windows store zeros.
  for (int w = wa; w < wb; ++w) {
    if (lo(w) == lo(w + 1)) {
      for (int i = lane; i < V * dv; i += 32) {
        const int64_t row = static_cast<int64_t>(w) * V + i / dv;
        if (row < m) out[row * ldo + i % dv] = narrow<T>(0.f);
      }
    }
  }

  auto first_from = [&](int w) {
    while (w < wb && lo(w) == lo(w + 1)) ++w;
    return Pos{w, w < wb ? lo(w) : 0};
  };
  auto advance = [&](Pos p) {
    if (p.w >= wb) return p;
    if (p.t0 + kChunk < lo(p.w + 1)) return Pos{p.w, p.t0 + kChunk};
    return first_from(p.w + 1);
  };
  auto count = [&](Pos p) {
    const int64_t rest = lo(p.w + 1) - p.t0;
    return rest < kChunk ? static_cast<int>(rest) : kChunk;
  };
  auto load_col = [&](Pos p) {
    return p.w < wb && lane < count(p) ? __ldg(cols + p.t0 + lane) : 0;
  };
  // cp.async of chunk p into slot sl (and of its window's Q rows into Q
  // slot qs when p is the window's first chunk).
  auto issue = [&](Pos p, int sl, int qs, int col) {
    const int cnt = count(p);
    const bool first = p.t0 == lo(p.w);
    const int64_t row0 = static_cast<int64_t>(p.w) * V;
    const int valid = m - row0 < V ? static_cast<int>(m - row0) : V;
    T* dk = s_k + sl * kChunk * L.dp;
    T* dq = s_q + qs * V * L.dp;
    if (bulk) {  // lane r copies row r of K (and of Q)
      // order this warp's reads of the slot before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane == 0) {
        mbar_expect(s_bar + sl, 1u * kElt * d * (cnt + (first ? valid : 0)));
      }
      __syncwarp();
      if (lane < cnt) {
        bulk_copy(dk + lane * L.dp, k + static_cast<int64_t>(col) * d,
                  kElt * d, s_bar + sl);
      }
      if (first && lane < valid) {
        bulk_copy(dq + lane * L.dp, q + (row0 + lane) * d, kElt * d,
                  s_bar + sl);
      }
    } else {
      auto gathered = [&](int r) {
        return static_cast<int64_t>(__shfl_sync(repro::kFullMask, col, r));
      };
      copy_rows(dk, L.dp, k, d, kChunk, cnt, kvec, lane, gathered);
      if (first) {
        copy_rows(dq, L.dp, q, d, V, valid, qvec, lane,
                  [&](int r) { return row0 + r; });
      }
    }
    if (lane < cnt) {
      const uint8_t* src = mask + (p.t0 + lane) * V;
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        cp_async4(s_mask + (sl * kChunk + lane) * (V / 4) + j, src + 4 * j);
      }
    }
  };

  // acc^T in two parts (big.big and the small products), summed at the
  // window's end
  float m_run[NT][2], l_run[NT][2], acc[NT][MT][4], acc_lo[NT][MT][4];
  auto reset = [&]() {
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
  };
  const int d8 = (d + 7) / 8;

  // Vmat rows of chunk p as the output's A operand: for k-step ks, vector
  // ks * 8 + tig (h2 = 0) and + 4 (h2 = 1), band b, this lane's columns
  // 32 b + 4 gid .. + 3 (zero past DV and past the chunk).  Row gid of m16
  // tile mt is column 32 (mt / 2) + 4 gid + 2 (mt % 2), row gid + 8 the
  // next column.
  float4 vf[4][2][BANDS];
  auto load_v = [&](Pos p, int col) {
    const int cnt = count(p);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = ks * 8 + tig + 4 * h2;
        const int c = __shfl_sync(repro::kFullMask, col, r);
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
  };

  // One chunk: scores, online softmax, output (see the header).
  auto compute = [&](Pos p, int sl, int qs) {
    const int cnt = count(p);
    const T* sk = s_k + sl * kChunk * L.dp;
    const T* sq = s_q + qs * V * L.dp;
    const uint8_t* sm = reinterpret_cast<const uint8_t*>(
        s_mask + sl * kChunk * (V / 4));
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
        const T* qr = sq + (nt * 8 + gid) * L.dp;
        bq[nt].set(0, widen(qr[c0]));
        bq[nt].set(1, widen(qr[c0 + 4]));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const T* kr = sk + (mt * 16 + gid) * L.dp;
        Frag<4, kExact> a;
        a.set(0, widen(kr[c0]));
        a.set(1, widen(kr[8 * L.dp + c0]));
        a.set(2, widen(kr[c0 + 4]));
        a.set(3, widen(kr[8 * L.dp + c0 + 4]));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_3xtf32(sc[nt][mt], sc_lo[nt][mt], a, bq[nt]);
        }
      }
    }

#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * tig + e;  // window row (column of S^T)
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
          mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, off));
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
          psum += __shfl_xor_sync(repro::kFullMask, psum, off);
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
            mma_3xtf32(acc[nt][mt], acc_lo[nt][mt], a, bp[nt]);
          }
        }
      }
    }
  };

  auto epilogue = [&](int w) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t row = static_cast<int64_t>(w) * V + nt * 8 + 2 * tig + e;
        const float den = fmaxf(l_run[nt][e], 1e-20f);
        if (row < m) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int c = 32 * (mt / 2) + 4 * gid + 2 * (mt % 2) + hh;
              const int i = e + 2 * hh;
              if (c < dv) {
                out[row * ldo + c] =
                    narrow<T>((acc[nt][mt][i] + acc_lo[nt][mt][i]) / den);
              }
            }
          }
        }
      }
    }
  };

  Pos cur = first_from(wa);
  if (cur.w >= wb) return;
  int col_cur = load_col(cur);
  issue(cur, 0, 0, col_cur);
  repro::cp_async_commit();
  Pos nxt = advance(cur);
  int col_nxt = load_col(nxt);
  int sl = 0, qs = 0;
  reset();
  while (true) {
    const Pos nxt2 = advance(nxt);
    const int col_nxt2 = load_col(nxt2);  // in flight during this chunk
    const bool more = nxt.w < wb;
    const int qs_nxt = more && nxt.w != cur.w ? qs ^ 1 : qs;
    if (more) issue(nxt, sl ^ 1, qs_nxt, col_nxt);
    repro::cp_async_commit();
    load_v(cur, col_cur);  // in flight during the scores and the softmax
    repro::cp_async_wait<1>();  // every copy but the newest: chunk cur
    if (bulk) {
      mbar_wait(s_bar + sl, (parity >> sl) & 1u);
      parity ^= 1u << sl;
    }
    __syncwarp();
    compute(cur, sl, qs);
    if (!more || nxt.w != cur.w) {
      epilogue(cur.w);
      reset();
    }
    __syncwarp();  // slot sl (and P^T) may now be overwritten
    if (!more) break;
    cur = nxt;
    col_cur = col_nxt;
    nxt = nxt2;
    col_nxt = col_nxt2;
    sl ^= 1;
    qs = qs_nxt;
  }
}

template <int V, int MT, typename T>
cudaError_t launch_mt(const int* win_ptr, const int* cols, const T* q,
                      const T* k, const T* vmat, const uint8_t* mask, T* out,
                      int m, int d, int dv, int ldv, int ldo, int num_windows,
                      int heads, int k_blk, int wpw, int64_t q_hstride,
                      int64_t k_hstride, int64_t v_hstride,
                      cudaStream_t stream) {
  const size_t smem = layout(V, d, sizeof(T)).total;
  const auto fn = attention_kernel<V, MT, T>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return err;
  }
  if (wpw < 1 || wpw > kMaxWindowsPerWarp) return cudaErrorInvalidValue;
  const dim3 grid((num_windows + wpw - 1) / wpw, heads);
  fn<<<grid, 32, smem, stream>>>(win_ptr, cols, q, k, vmat, mask, out, m, d,
                                 dv, ldv, ldo, k_blk, num_windows, wpw,
                                 q_hstride, k_hstride, v_hstride);
  return cudaGetLastError();
}

template <int V, typename T>
cudaError_t launch(const void* win_ptr, const void* cols, const void* q,
                   const void* k, const void* vmat, const void* mask,
                   void* out, int m, int d, int dv, int ldv, int ldo,
                   int num_windows, int heads, int k_blk, int wpw,
                   int64_t q_hstride, int64_t k_hstride, int64_t v_hstride,
                   cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(mask) & 3) != 0) {
    return cudaErrorMisalignedAddress;  // mask bytes are copied 4 at a time
  }
  auto run = [&](auto mt) {
    return launch_mt<V, decltype(mt)::value, T>(
        static_cast<const int*>(win_ptr), static_cast<const int*>(cols),
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(vmat), static_cast<const uint8_t*>(mask),
        static_cast<T*>(out), m, d, dv, ldv, ldo, num_windows, heads, k_blk,
        wpw, q_hstride, k_hstride, v_hstride, stream);
  };
  if (dv <= 32) return run(std::integral_constant<int, 2>{});
  if (dv <= 64) return run(std::integral_constant<int, 4>{});
  if (dv <= 128) return run(std::integral_constant<int, 8>{});
  return cudaErrorInvalidValue;  // a band's accumulator lives in registers
}

}  // namespace

// win_ptr (W + 1,) int32, cols (NNZP,) int32, q (M, D) already scaled,
// k (Mc, D), vmat (Mc, ...) and out (H, M, ...) all of type `type` (0 f32,
// 1 bf16), q, k, vmat with heads q_hstride, k_hstride, v_hstride elements
// apart (0: shared by every head), mask (NNZP, V) bool.  The launch covers
// dv (at most 128) columns of vmat and out, whose rows are ldv and ldo
// elements apart (vmat and out point at the band's first column); each
// warp walks wpw (1 to 16) consecutive windows.  H at most 65,535.
extern "C" int attention_launch(const void* win_ptr, const void* cols,
                                const void* q, const void* k, const void* vmat,
                                const void* mask, void* out, int m, int d,
                                int dv, int ldv, int ldo, int num_windows,
                                int heads, int v, int k_blk, int wpw,
                                int64_t q_hstride, int64_t k_hstride,
                                int64_t v_hstride, int type, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto by_v = [&](auto t) {
    using T = decltype(t);
    if (v == 8) {
      return launch<8, T>(win_ptr, cols, q, k, vmat, mask, out, m, d, dv, ldv,
                          ldo, num_windows, heads, k_blk, wpw, q_hstride,
                          k_hstride, v_hstride, st);
    }
    if (v == 16) {
      return launch<16, T>(win_ptr, cols, q, k, vmat, mask, out, m, d, dv,
                           ldv, ldo, num_windows, heads, k_blk, wpw,
                           q_hstride, k_hstride, v_hstride, st);
    }
    return cudaErrorInvalidValue;
  };
  if (type == 0) return by_v(float{});
  if (type == 1) return by_v(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

// Bytes of shared memory a launch needs for V = v, D = d and elements of
// elt bytes (the wrapper routes a D whose rings do not fit elsewhere).
extern "C" int attention_smem_bytes(int v, int d, int elt) {
  return layout(v, d, elt).total;
}

REPRO_ERROR_STRING(attention_error_string)
