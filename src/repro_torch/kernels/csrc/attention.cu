// Single-pass fused sparse attention over the blocked ME-BCRS pattern:
// out[h] = softmax_rows(mask * (Q_s[h] @ K[h]^T)) @ Vmat[h], fp32, for H
// heads in one launch, with Q_s = scale * Q folded in before the launch
// (one scale for every head).  Q, K and Vmat are each either per head or
// shared by every head.
//
// Replaces: src/repro/kernels/attention_pallas.py, _fused_attn_kernel
// (launched through attention_pallas).
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
// about 10 mantissa bits, the split about 21.  The exponentials take the
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
#include "common.cuh"

namespace {

constexpr int kChunk = 32;     // vectors per online-softmax step
constexpr int kPStride = 36;   // P^T row stride (floats): conflict-free
constexpr int kMaxWindowsPerWarp = 16;  // win_ptr entries: a lane each

using repro::cp_async16;
using repro::cp_async4;

// Shared memory of the one warp of a block, in floats: K rows of two
// chunks, Q rows of two windows, P^T, mask bytes of two chunks, the two
// chunks' mbarriers (a multiple of 4 floats in all, every part 16-byte
// aligned).  The row stride of K and Q is D padded to a multiple of 8,
// + 4: the fragment loads then hit 32 distinct banks.
struct Layout {
  int dp, k, q, p, mask, bar, total;
};

__host__ __device__ __forceinline__ Layout layout(int vsz, int d) {
  Layout s;
  s.dp = (d + 7) / 8 * 8 + 4;
  s.k = 0;
  s.q = s.k + 2 * kChunk * s.dp;
  s.p = s.q + 2 * vsz * s.dp;
  s.mask = s.p + vsz * kPStride;
  s.bar = s.mask + 2 * kChunk * vsz / 4;  // two mbarriers, 8 bytes each
  s.total = s.bar + 4;
  return s;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// An mma operand fragment of N fp32 values split into TF32 big and small.
template <int N>
struct Frag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    big[i] = to_tf32(x);
    small[i] = to_tf32(x - __uint_as_float(big[i]));
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a . b in 3xTF32: big.big into hi, big.small + small.big into lo.  Two
// accumulators make two chains of dependent mma instead of one.
__device__ __forceinline__ void mma_3xtf32(float (&hi)[4], float (&lo)[4],
                                           const Frag<4>& a,
                                           const Frag<2>& b) {
  mma_tf32(lo, a.big, b.small);
  mma_tf32(lo, a.small, b.big);
  mma_tf32(hi, a.big, b.big);
}

// Copies `rows` rows of `width` floats, row r from src + idx(r) * width,
// into dst with row stride `stride`, skipping rows >= valid: 16 bytes at a
// time when vec, else 4.  idx is a lane's column id broadcast by shuffle,
// so every lane runs the same number of iterations.
template <typename Idx>
__device__ __forceinline__ void copy_rows(float* dst, int stride,
                                          const float* src, int width,
                                          int rows, int valid, bool vec,
                                          int lane, Idx idx) {
  if (vec) {
    const int segs = width / 4;
    for (int i = lane; i < rows * segs; i += 32) {
      const int r = i / segs, s = i - r * segs;
      const int64_t row = idx(r);
      if (r < valid) {
        cp_async16(dst + r * stride + 4 * s, src + row * width + 4 * s);
      }
    }
  } else {
    for (int i = lane; i < rows * width; i += 32) {
      const int r = i / width, e = i - r * width;
      const int64_t row = idx(r);
      if (r < valid) cp_async4(dst + r * stride + e, src + row * width + e);
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

// V: window rows (8 or 16, one or two n8 tiles); MT: m16 tiles of DV
// (DV <= 16 * MT), two per band of 32 columns.
template <int V, int MT>
__global__ void __launch_bounds__(32)
attention_kernel(const int* __restrict__ win_ptr, const int* __restrict__ cols,
                 const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ vmat,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int m, int d, int dv, int k_blk, int num_windows, int wpw,
                 int64_t q_hstride, int64_t k_hstride, int64_t v_hstride) {
  constexpr int NT = V / 8;
  constexpr int BANDS = (MT + 1) / 2;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t h = blockIdx.y;
  q += h * q_hstride;
  k += h * k_hstride;
  vmat += h * v_hstride;
  out += h * static_cast<int64_t>(m) * dv;
  const Layout L = layout(V, d);
  float* s_k = smem + L.k;
  float* s_q = smem + L.q;
  float* s_p = smem + L.p;
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem + L.mask);
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  // Every slot a chunk does not fill (padding columns, rows past a
  // window's last vector) holds finite values: zeros, or an earlier
  // chunk's rows, multiplied by p = 0.
  for (int i = lane; i < L.bar / 4; i += 32) {
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
  const bool kvec = d % 4 == 0 && aligned16(k);
  const bool qvec = d % 4 == 0 && aligned16(q);
  const bool vvec = dv % 4 == 0 && aligned16(vmat);
  const bool bulk = kvec && qvec;
  unsigned parity = 0;  // bit sl: the phase of slot sl's mbarrier

  // Empty windows store zeros.
  for (int w = wa; w < wb; ++w) {
    if (lo(w) == lo(w + 1)) {
      for (int i = lane; i < V * dv; i += 32) {
        const int64_t row = static_cast<int64_t>(w) * V + i / dv;
        if (row < m) out[row * dv + i % dv] = 0.f;
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
    float* dk = s_k + sl * kChunk * L.dp;
    float* dq = s_q + qs * V * L.dp;
    if (bulk) {  // lane r copies row r of K (and of Q)
      // order this warp's reads of the slot before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane == 0) {
        mbar_expect(s_bar + sl, 4u * d * (cnt + (first ? valid : 0)));
      }
      __syncwarp();
      if (lane < cnt) {
        bulk_copy(dk + lane * L.dp, k + static_cast<int64_t>(col) * d, 4 * d,
                  s_bar + sl);
      }
      if (first && lane < valid) {
        bulk_copy(dq + lane * L.dp, q + (row0 + lane) * d, 4 * d, s_bar + sl);
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
        const float* row = vmat + static_cast<int64_t>(c) * dv;
#pragma unroll
        for (int b = 0; b < BANDS; ++b) {
          const int c0 = 32 * b + 4 * gid;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < cnt && c0 < dv) {
            if (vvec) {
              x = __ldg(reinterpret_cast<const float4*>(row + c0));
            } else {
              x.x = __ldg(row + c0);
              if (c0 + 1 < dv) x.y = __ldg(row + c0 + 1);
              if (c0 + 2 < dv) x.z = __ldg(row + c0 + 2);
              if (c0 + 3 < dv) x.w = __ldg(row + c0 + 3);
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
    const float* sk = s_k + sl * kChunk * L.dp;
    const float* sq = s_q + qs * V * L.dp;
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
      Frag<2> bq[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* qr = sq + (nt * 8 + gid) * L.dp;
        bq[nt].set(0, qr[c0]);
        bq[nt].set(1, qr[c0 + 4]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* kr = sk + (mt * 16 + gid) * L.dp;
        Frag<4> a;
        a.set(0, kr[c0]);
        a.set(1, kr[8 * L.dp + c0]);
        a.set(2, kr[c0 + 4]);
        a.set(3, kr[8 * L.dp + c0 + 4]);
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
          Frag<4> a;
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
                out[row * dv + c] = (acc[nt][mt][i] + acc_lo[nt][mt][i]) / den;
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

template <int V, int MT>
cudaError_t launch_mt(const int* win_ptr, const int* cols, const float* q,
                      const float* k, const float* vmat, const uint8_t* mask,
                      float* out, int m, int d, int dv, int num_windows,
                      int heads, int k_blk, int wpw, int64_t q_hstride,
                      int64_t k_hstride, int64_t v_hstride,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * layout(V, d).total;
  const auto fn = attention_kernel<V, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return err;
  }
  if (wpw < 1 || wpw > kMaxWindowsPerWarp) return cudaErrorInvalidValue;
  const dim3 grid((num_windows + wpw - 1) / wpw, heads);
  fn<<<grid, 32, smem, stream>>>(win_ptr, cols, q, k, vmat, mask, out, m, d,
                                 dv, k_blk, num_windows, wpw, q_hstride,
                                 k_hstride, v_hstride);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch(const int* win_ptr, const int* cols, const float* q,
                   const float* k, const float* vmat, const uint8_t* mask,
                   float* out, int m, int d, int dv, int num_windows,
                   int heads, int k_blk, int wpw, int64_t q_hstride,
                   int64_t k_hstride,
                   int64_t v_hstride, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(mask) & 3) != 0) {
    return cudaErrorMisalignedAddress;  // mask bytes are copied 4 at a time
  }
  if (dv <= 32) {
    return launch_mt<V, 2>(win_ptr, cols, q, k, vmat, mask, out, m, d, dv,
                           num_windows, heads, k_blk, wpw, q_hstride,
                           k_hstride,
                           v_hstride, stream);
  }
  if (dv <= 64) {
    return launch_mt<V, 4>(win_ptr, cols, q, k, vmat, mask, out, m, d, dv,
                           num_windows, heads, k_blk, wpw, q_hstride,
                           k_hstride,
                           v_hstride, stream);
  }
  if (dv <= 128) {
    return launch_mt<V, 8>(win_ptr, cols, q, k, vmat, mask, out, m, d, dv,
                           num_windows, heads, k_blk, wpw, q_hstride,
                           k_hstride,
                           v_hstride, stream);
  }
  return cudaErrorInvalidValue;  // the accumulator lives in registers
}

}  // namespace

// win_ptr (W + 1,) int32, cols (NNZP,) int32, q (M, D) f32 already scaled,
// k (Mc, D) f32, vmat (Mc, DV) f32, each with heads q_hstride, k_hstride,
// v_hstride elements apart (0: shared by every head), mask (NNZP, V) bool,
// out (H, M, DV) f32; each warp walks wpw (1 to 16) consecutive windows.
// DV at most 128, H at most 65,535.
extern "C" int attention_f32(const void* win_ptr, const void* cols,
                             const void* q, const void* k, const void* vmat,
                             const void* mask, void* out, int m, int d, int dv,
                             int num_windows, int heads, int v, int k_blk,
                             int wpw,
                             int64_t q_hstride, int64_t k_hstride,
                             int64_t v_hstride, void* stream) {
  const auto* wp = static_cast<const int*>(win_ptr);
  const auto* cl = static_cast<const int*>(cols);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const float*>(k);
  const auto* vv = static_cast<const float*>(vmat);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8:
      return launch<8>(wp, cl, qq, kk, vv, mk, o, m, d, dv, num_windows, heads,
                       k_blk, wpw, q_hstride, k_hstride, v_hstride, st);
    case 16:
      return launch<16>(wp, cl, qq, kk, vv, mk, o, m, d, dv, num_windows, heads,
                        k_blk, wpw, q_hstride, k_hstride, v_hstride, st);
    default:
      return cudaErrorInvalidValue;
  }
}

REPRO_ERROR_STRING(attention_error_string)
