// Load-balanced single-pass sparse attention over a block-parallel
// Schedule cut into runs: out[h] = softmax_rows(mask * (Q_s[h] @ K[h]^T))
// @ Vmat[h] for H heads, each of Q, K and Vmat either per head or shared,
// with Q_s = scale * Q folded in before the launch; Q, K, Vmat and out all
// fp32 or all bf16.
//
// Replaces: src/repro/kernels/attention_pallas.py, _balanced_attn_kernel
// (launched through attention_pallas_balanced), with its bf16 variant
// (attention_pallas.py:392, :401: Q scaled in fp32 and rounded to bf16,
// fp32 scores, softmax and sums, one cast of the output, :324).
//
// Bound on the card: bytes.  Each input read once and the output written
// once is Q (M x D), K (Mc x D), Vmat (Mc x DV), each per distinct head,
// + mask (NNZP x V bytes) + cols (NNZP) + the run plan (run_ptr, pieces)
// + out (H x M x DV); scores and probabilities never reach device memory.
// On the Amazon replica's A at D = DV = 32 (Q = K), 181 MB, 0.054 ms at
// 3.35 TB/s, against about 2 * nnz * (D + DV) = 0.43 GFLOP plus one exp
// per score, three TF32 products a multiply on the tensor cores (495
// TFLOP/s).  bf16 halves the bytes of Q, K, Vmat and out.
//
// Design.  The TPU kernel carries the online-softmax state (m, l, acc) of
// a window across its split segments on a sequential grid.  CUDA blocks
// run in no order, so the carry lives inside a warp:
//   1. run pass: kernels/_combine.py cuts the schedule's segments, in
//      order, into runs of about run_blk K-blocks (cut only at segment
//      boundaries, near a window boundary where one is close); a run is a
//      list of pieces, one per window it touches.  One warp per (rpw
//      consecutive runs, head, band of 128 value columns), up to kRunWarps
//      a block, walks the runs' pieces in order (consecutive in the plan),
//      a piece in chunks of 32 of its vectors that span its segments, so a
//      window of 36 vectors takes 2 chunks whatever split_blk cut it
//      into; the wrapper picks rpw for about 9 chunks a warp.  Each chunk
//      is attention_chunk.cuh's tensor-core step (FlashSparse's swap and
//      transpose on mma.sync m16n8k8: S^T = K[cols] Q_w^T and acc^T =
//      alpha acc^T + Vmat[cols]^T P^T, the window's V query rows on the n
//      side, the online softmax in the fragments' layout, 3 shuffles over
//      the 8 lanes of a row), the softmax state and acc^T in registers for
//      the whole piece.  As in attention.cu, the warp's stream of chunks
//      runs across its pieces: the next chunk's K rows (and at a piece's
//      first chunk its window's Q rows) are copied into a double-buffered
//      ring of shared memory while the current chunk computes, fp32 rows
//      by cp.async.bulk on an mbarrier a slot when D is a multiple of 4
//      (bf16 rows and other D by cp.async), so a piece's first loads are
//      in flight during the last chunk of the piece before; its mask bytes
//      by cp.async with them, its column ids a chunk before that, its Vmat
//      rows into registers before its scores.  A D whose ring does not fit
//      a block's shared memory (past about 700 fp32 columns at V = 8)
//      reads the K fragments from global memory instead, staging only Q.
//      At a piece's end, when the run holds the whole window the warp
//      normalises and stores its rows; otherwise it writes the
//      unnormalised acc (V, DV), the row maxima m (V) and the row sums l
//      (V) from the fragments to the piece's edge entry.  A run leaves
//      partials for at most two windows, the one cut at its start and the
//      one cut at its end.
//   2. combine tree: the edge entries of each window that runs cut are
//      merged by a tree of groups (tree_meta, from kernels/_combine.py),
//      one level per launch (a hub window of a power-law graph's transpose
//      is cut into thousands of runs).
//      One warp per (group, head) merges the group's up to 32 entries in
//      order by log-sum-exp, M = max_e m_e, L = sum_e l_e exp(m_e - M),
//      A = sum_e acc_e exp(m_e - M), with L and A summed and kept in fp64,
//      and writes (M, L, A) as one entry of the next level or, for the
//      window's last group, A / max(L, 1e-20) as its rows of out.
// No atomics: the result is the same bits from run to run.  The merge is
// exact in exact arithmetic; only the rounding differs from the
// sequential carry.  A pass with one warp per segment would, at
// split_blk = 1, give a warp one K-block, reload the window's queries per
// segment and write 1,088 bytes of (m, l, acc) for every segment of a
// split window: at DV = 32 on the Amazon replica, 0.25 GB written and
// read back on A (227,197 segments) and 0.42 GB on Aᵀ (388,828).  Runs of
// 16 K-blocks leave none on A and 22,899 entries on Aᵀ (25 MB, 17x
// fewer); phase 5 of chip_smoke.py prints them for every plan.  An entry
// with no unmasked score has m = -FLT_MAX, l = 0 and acc = 0, so it weighs
// nothing; an empty window (a zero-length piece, which takes no chunk)
// and an empty row store 0, not NaN.  Rows >= M are not written.
// Precision: fp32 operands in 3xTF32 (big.big and the small products in
// two chains); every big.big product, of the scores' k-steps and of P .
// Vmat's, is taken from a zero accumulator and added by an fp32 add, which
// rounds to nearest where the tensor cores' own accumulation does not: at
// split_blk = 0 a hub window of Amazon's Aᵀ is one piece of 50,424
// K-blocks, and D may be 1,500 (chip_smoke.py holds both).  The window
// kernel (attention.cu) keeps the mma's own accumulation.  bf16: Q, K and
// Vmat are widened as they are read and are exact in TF32, so the same
// instructions without the small products compute the fp32 kernel's
// result on the widened operands; (m, l, acc), the edge entries and the
// tree stay fp32 (fp64 sums), and the output is rounded to bf16 once:
// bit for bit the fp32 kernel's, rounded.
#include "attention_chunk.cuh"
#include "spmm_window.cuh"

namespace {

constexpr int kWarps = 4;     // groups of the combine tree per thread block
// Warps a block of the run kernel (at most), and the blocks an SM must
// hold at DV <= 32 and at DV <= 64 (registers a thread: 65,536 / (32 *
// warps * blocks)); chosen by scripts/spmm_variants.py --attention.
constexpr int kRunWarps = 2;
constexpr int kMinBlocks = 8;
constexpr int kMinBlocks4 = 6;
constexpr int kBand = 128;    // value columns of a block (registers)

using repro::from_f32;
using repro::attn::kChunk;
using repro::attn::Layout;
using repro::attn::layout;
using repro::attn::narrow;
using repro::attn::Tile;

// A position of a warp's stream of chunks: piece pi (== the run's end when
// the stream is done) of window w, whose vectors end at t_hi; the chunk's
// first vector t0 and whether it is the piece's first chunk.
struct Pos {
  int pi, w;
  bool first;
  int64_t t0, t_hi;
};

// V: window rows (8 or 16, one or two n8 tiles); MT: m16 tiles of a band
// of at most kBand value columns (blockIdx.z), two per group of 32; T: the
// element type of Q, K, Vmat and out; kRing: K rows staged in a ring of
// two chunks in shared memory (else the K fragments are loaded from global
// memory, for a D whose ring does not fit).
template <int V, int MT, typename T, bool kRing>
__global__ void __launch_bounds__(kRunWarps * 32,
                                  MT <= 2 ? kMinBlocks
                                          : (MT <= 4 ? kMinBlocks4 : 1))
attention_run_kernel(
               const int* __restrict__ run_ptr, const int* __restrict__ pieces,
               int num_runs, const int* __restrict__ cols,
               const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ vmat,
               const uint8_t* __restrict__ mask, T* __restrict__ out,
               float* __restrict__ part_acc, float* __restrict__ part_m,
               float* __restrict__ part_l, int m, int d, int ldv, int k_blk,
               int64_t entries, int per_warp, int rpw, int64_t q_hstride,
               int64_t k_hstride, int64_t v_hstride) {
  constexpr int NT = V / 8;
  constexpr int kElt = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // this warp's runs [r, r_end): their pieces are consecutive
  const int r = (blockIdx.x * (blockDim.x >> 5) + warp) * rpw;
  const int64_t h = blockIdx.y;
  if (r >= num_runs) return;  // the whole warp leaves together
  const int r_end = min(r + rpw, num_runs);
  // this block's band of value columns: [c_band, c_band + dv)
  const int c_band = blockIdx.z * kBand;
  const int dv = min(kBand, ldv - c_band);
  const bool band0 = blockIdx.z == 0;  // writes the edge entries' m and l
  q += h * q_hstride;
  k += h * k_hstride;
  vmat += h * v_hstride + c_band;
  out += h * m * static_cast<int64_t>(ldv) + c_band;

  unsigned char* region = smem_bytes + static_cast<size_t>(warp) * per_warp;
  const Layout L = layout(V, d, kElt, kRing);
  T* s_k = reinterpret_cast<T*>(region + L.k);
  T* s_q = reinterpret_cast<T*>(region + L.q);
  float* s_p = reinterpret_cast<float*>(region + L.p);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(region + L.mask);
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(region + L.bar);
  repro::attn::init_region<T>(region, L, lane, d);

  auto aligned16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool kvec = d % (16 / kElt) == 0 && aligned16(k);
  const bool qvec = d % (16 / kElt) == 0 && aligned16(q);
  // four neighbouring columns of Vmat in one load (16 bytes fp32, 8 bf16)
  const bool vvec = dv % 4 == 0 && ldv % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(vmat) & (4 * kElt - 1)) == 0;
  // Bulk copies of whole rows for fp32; bf16 rows go by cp.async, 16 bytes
  // a lane, which measured faster for them (scripts/spmm_variants.py
  // --attention: 0.340 against 0.356 ms at D = 32, 0.712 against 0.751 at
  // D = 64 with 12 heads, where fp32 took 0.920 against 0.765 without
  // bulk copies).
  const bool bulk = kRing && kvec && qvec && std::is_same<T, float>::value;
  unsigned parity = 0;  // bit sl: the phase of slot sl's mbarrier

  const int p_lo = run_ptr[r], p_hi = run_ptr[r_end];
  const int4* piece4 = reinterpret_cast<const int4*>(pieces);
  Tile<V, MT, T> tile(lane);
  // A piece's end: the window's rows of out from the tile, normalised
  // (entry < 0: the run holds the whole window), or its edge entry (acc,
  // m, l) for the combine tree.
  auto store = [&](int w, int entry) {
    if (entry < 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t row = static_cast<int64_t>(w) * V + tile.row(nt, e);
          const float den = fmaxf(tile.l_run[nt][e], 1e-20f);
          if (row < m) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int c = tile.col(mt, hh);
                if (c < dv) {
                  out[row * ldv + c] =
                      narrow<T>(tile.value(nt, e, mt, hh) / den);
                }
              }
            }
          }
        }
      }
    } else {
      const int64_t slot = h * entries + entry;
      float* pa = part_acc + slot * V * ldv + c_band;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int vr = tile.row(nt, e);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int c = tile.col(mt, hh);
              if (c < dv) pa[vr * ldv + c] = tile.value(nt, e, mt, hh);
            }
          }
          if (band0 && tile.gid == 0) {
            part_m[slot * V + vr] = tile.m_run[nt][e];
            part_l[slot * V + vr] = tile.l_run[nt][e];
          }
        }
      }
    }
  };

  // Zero-length pieces (empty windows) take no chunk: from the reset tile
  // they store zeros, or an entry that weighs nothing (m = -FLT_MAX, l =
  // 0, acc = 0).
  tile.reset();
  for (int base = p_lo; base < p_hi; base += 32) {
    const int pi = base + lane;
    const int4 pm = pi < p_hi ? __ldg(piece4 + pi) : make_int4(0, 0, 1, 0);
    unsigned empty = __ballot_sync(repro::kFullMask, pm.z == 0);
    while (empty) {
      const int j = __ffs(empty) - 1;
      empty &= empty - 1;
      store(__shfl_sync(repro::kFullMask, pm.x, j),
            __shfl_sync(repro::kFullMask, pm.w, j));
    }
  }

  auto first_from = [&](int pi) {
    for (; pi < p_hi; ++pi) {
      const int4 pm = __ldg(piece4 + pi);
      if (pm.z > 0) {
        const int64_t t_lo = static_cast<int64_t>(pm.y) * k_blk;
        return Pos{pi, pm.x, true, t_lo,
                   t_lo + static_cast<int64_t>(pm.z) * k_blk};
      }
    }
    return Pos{p_hi, 0, false, 0, 0};
  };
  auto advance = [&](Pos p) {
    if (p.pi >= p_hi) return p;
    if (p.t0 + kChunk < p.t_hi) {
      return Pos{p.pi, p.w, false, p.t0 + kChunk, p.t_hi};
    }
    return first_from(p.pi + 1);
  };
  auto count = [&](Pos p) {
    const int64_t rest = p.t_hi - p.t0;
    return rest < kChunk ? static_cast<int>(rest) : kChunk;
  };
  auto load_col = [&](Pos p) {
    return p.pi < p_hi && lane < count(p) ? __ldg(cols + p.t0 + lane) : 0;
  };
  // Copies of chunk p into slot sl (and of its window's Q rows into Q
  // slot qs when p is its piece's first chunk), as attention.cu's.
  auto issue = [&](Pos p, int sl, int qs, int col) {
    const int cnt = count(p);
    const int64_t row0 = static_cast<int64_t>(p.w) * V;
    const int valid = m - row0 < V ? static_cast<int>(m - row0) : V;
    T* dk = s_k + sl * kChunk * L.dp;
    T* dq = s_q + qs * V * L.dp;
    if (bulk) {  // lane r copies row r of K (and of Q)
      // order this warp's reads of the slot before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane == 0) {
        repro::attn::mbar_expect(
            s_bar + sl, 1u * kElt * d * (cnt + (p.first ? valid : 0)));
      }
      __syncwarp();
      if (lane < cnt) {
        repro::attn::bulk_copy(dk + lane * L.dp,
                               k + static_cast<int64_t>(col) * d, kElt * d,
                               s_bar + sl);
      }
      if (p.first && lane < valid) {
        repro::attn::bulk_copy(dq + lane * L.dp, q + (row0 + lane) * d,
                               kElt * d, s_bar + sl);
      }
    } else {
      if constexpr (kRing) {
        repro::attn::copy_rows(dk, L.dp, k, d, kChunk, cnt, kvec, lane,
                               [&](int r) {
                                 return static_cast<int64_t>(__shfl_sync(
                                     repro::kFullMask, col, r));
                               });
      }
      if (p.first) {
        repro::attn::copy_rows(dq, L.dp, q, d, V, valid, qvec, lane,
                               [&](int r) { return row0 + r; });
      }
    }
    if (lane < cnt) {
      const uint8_t* src = mask + (p.t0 + lane) * V;
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        repro::cp_async4(s_mask + (sl * kChunk + lane) * (V / 4) + j,
                         src + 4 * j);
      }
    }
  };

  const int d8 = (d + 7) / 8;

  // One chunk: scores, online softmax, output (attention_chunk.cuh).
  auto compute = [&](Pos p, int sl, int qs, int col) {
    const T* sq = s_q + qs * V * L.dp;
    const uint8_t* sm =
        reinterpret_cast<const uint8_t*>(s_mask + sl * kChunk * (V / 4));
    if constexpr (kRing) {
      const T* sk = s_k + sl * kChunk * L.dp;
      tile.step([&](int j, int c) {
                  return repro::widen(sk[(8 * j + tile.gid) * L.dp + c]);
                },
                sq, L.dp, d8, sm, s_p, count(p), dv);
    } else {
      // K row 8 j + gid of the chunk straight from global memory (a lane
      // past the chunk holds column 0, a real row, met by p = 0)
      const T* kr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = __shfl_sync(repro::kFullMask, col, 8 * j + tile.gid);
        kr[j] = k + static_cast<int64_t>(c) * d;
      }
      tile.step([&](int j, int c) {
                  return c < d ? repro::widen(kr[j][c]) : 0.f;
                },
                sq, L.dp, d8, sm, s_p, count(p), dv);
    }
  };

  Pos cur = first_from(p_lo);
  if (cur.pi >= p_hi) return;
  int col_cur = load_col(cur);
  issue(cur, 0, 0, col_cur);
  repro::cp_async_commit();
  Pos nxt = advance(cur);
  int col_nxt = load_col(nxt);
  int sl = 0, qs = 0;
  while (true) {
    const Pos nxt2 = advance(nxt);
    const int col_nxt2 = load_col(nxt2);  // in flight during this chunk
    const bool more = nxt.pi < p_hi;
    const int qs_nxt = more && nxt.pi != cur.pi ? qs ^ 1 : qs;
    if (more) issue(nxt, sl ^ 1, qs_nxt, col_nxt);
    repro::cp_async_commit();
    // in flight during the scores and the softmax
    tile.load_v(vmat, ldv, dv, vvec, count(cur), col_cur);
    repro::cp_async_wait<1>();  // every copy but the newest: chunk cur
    if (bulk) {
      repro::attn::mbar_wait(s_bar + sl, (parity >> sl) & 1u);
      parity ^= 1u << sl;
    }
    __syncwarp();
    compute(cur, sl, qs, col_cur);
    if (!more || nxt.pi != cur.pi) {  // the piece ends
      store(cur.w, __ldg(piece4 + cur.pi).w);
      tile.reset();
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

template <int V, typename Acc, typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_tree_kernel(
            const int* __restrict__ tree_meta, int group0, int num_groups,
            const Acc* __restrict__ src_acc, const float* __restrict__ src_m,
            const Acc* __restrict__ src_l, int64_t src_entries,
            double* __restrict__ dst_acc, float* __restrict__ dst_m,
            double* __restrict__ dst_l, int64_t tree_entries,
            T* __restrict__ out, int m, int dv) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = blockIdx.x * kWarps + warp;
  const int h = blockIdx.y;
  if (gi >= num_groups) return;
  const int* g = tree_meta + static_cast<int64_t>(group0 + gi) * 4;
  const int64_t lo = h * src_entries + g[0], hi = lo + g[1];
  const int64_t row0 = static_cast<int64_t>(g[2]) * V;
  const int64_t dst = h * tree_entries + g[3];
  for (int i = lane; i < V * dv; i += 32) {
    const int v = i / dv;
    float mx = -FLT_MAX;
    for (int64_t e = lo; e < hi; ++e) mx = fmaxf(mx, src_m[e * V + v]);
    double l = 0.0, a = 0.0;
    for (int64_t e = lo; e < hi; ++e) {
      const double w = expf(src_m[e * V + v] - mx);
      l += src_l[e * V + v] * w;
      a += src_acc[e * V * dv + i] * w;
    }
    if (g[3] < 0) {  // the window's last group: normalise, store
      if (row0 + v < m) {
        out[(static_cast<int64_t>(h) * m + row0 + v) * dv + (i - v * dv)] =
            from_f32<T>(static_cast<float>(a) /
                        fmaxf(static_cast<float>(l), 1e-20f));
      }
    } else {
      dst_acc[dst * V * dv + i] = a;
      if (i - v * dv == 0) {
        dst_m[dst * V + v] = mx;
        dst_l[dst * V + v] = l;
      }
    }
  }
}

// Warps a block of the run kernel takes at `per_warp` bytes of shared
// memory each: the count of at most kRunWarps that keeps the most warps
// on an SM whose shared memory (sm_bytes, 1 KB of it reserved a block)
// bounds them, or 0 when one warp's does not fit a block (block_bytes).
int warps_per_block(int per_warp, int sm_bytes, int block_bytes) {
  int best = 0, best_warps = 0;
  for (int w = 1; w <= kRunWarps; ++w) {
    const int bytes = w * per_warp;
    if (bytes > block_bytes) break;
    const int warps = w * (sm_bytes / (bytes + 1024));
    if (warps >= best_warps) {
      best = w;
      best_warps = warps;
    }
  }
  return best;
}

template <int V, int MT, typename T, bool kRing>
cudaError_t launch_run(const int* run_ptr, const int* pieces, int num_runs,
                       const int* cols, const T* q, const T* k,
                       const T* vmat, const uint8_t* mask, T* out,
                       float* part_acc, float* part_m, float* part_l, int m,
                       int d, int dv, int heads, int k_blk, int64_t entries,
                       int64_t q_hstride, int64_t k_hstride,
                       int64_t v_hstride, int per_warp, int wpb, int rpw,
                       cudaStream_t stream) {
  const auto fn = attention_run_kernel<V, MT, T, kRing>;
  const int smem = per_warp * wpb;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return err;
  }
  const int warps = (num_runs + rpw - 1) / rpw;
  const dim3 grid((warps + wpb - 1) / wpb, heads, (dv + kBand - 1) / kBand);
  fn<<<grid, wpb * 32, smem, stream>>>(
      run_ptr, pieces, num_runs, cols, q, k, vmat, mask, out, part_acc,
      part_m, part_l, m, d, dv, k_blk, entries, per_warp, rpw, q_hstride,
      k_hstride, v_hstride);
  return cudaGetLastError();
}

template <int V, typename T>
cudaError_t launch(const int* run_ptr, const int* pieces,
                   const int* tree_meta, const int* cols, const void* qv,
                   const void* kv, const void* vv, const uint8_t* mask,
                   void* outv, float* part_acc, float* part_m, float* part_l,
                   double* tree_acc, float* tree_m, double* tree_l, int m,
                   int d, int dv, int num_runs, int heads, int k_blk,
                   int64_t q_hstride, int64_t k_hstride, int64_t v_hstride,
                   const int* levels, int num_levels, int64_t entries,
                   int64_t tree_entries, int rpw, cudaStream_t stream) {
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  const T* vmat = static_cast<const T*>(vv);
  T* out = static_cast<T*>(outv);
  if ((reinterpret_cast<uintptr_t>(mask) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(pieces) & 15) != 0) {
    // mask bytes are copied 4 at a time, a piece is read as one int4
    return cudaErrorMisalignedAddress;
  }
  int dev = 0, sm_bytes = 0, block_bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &block_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  // K rows in a ring of shared memory when one warp's fits a block, else
  // from global memory (a D of several hundred columns)
  const int ring = layout(V, d, sizeof(T), true).total;
  const int direct = layout(V, d, sizeof(T), false).total;
  const int wpb_ring = warps_per_block(ring, sm_bytes, block_bytes);
  const int wpb = wpb_ring ? wpb_ring
                           : warps_per_block(direct, sm_bytes, block_bytes);
  if (wpb == 0 || rpw < 1) return cudaErrorInvalidValue;  // D too wide
  auto run = [&](auto mt, auto k_ring) {
    return launch_run<V, decltype(mt)::value, T, decltype(k_ring)::value>(
        run_ptr, pieces, num_runs, cols, q, k, vmat, mask, out, part_acc,
        part_m, part_l, m, d, dv, heads, k_blk, entries, q_hstride,
        k_hstride, v_hstride, k_ring ? ring : direct, wpb, rpw, stream);
  };
  auto by_mt = [&](auto k_ring) {
    if (dv <= 32) return run(std::integral_constant<int, 2>{}, k_ring);
    if (dv <= 64) return run(std::integral_constant<int, 4>{}, k_ring);
    return run(std::integral_constant<int, 8>{}, k_ring);  // bands of 128
  };
  if (num_runs > 0) {
    err = wpb_ring ? by_mt(std::true_type{}) : by_mt(std::false_type{});
  }
  for (int l = 0; l < num_levels && err == cudaSuccess; ++l) {
    const int g0 = levels[2 * l], ng = levels[2 * l + 1];
    const dim3 tgrid((ng + kWarps - 1) / kWarps, heads);
    if (l == 0) {
      attention_tree_kernel<V, float, T><<<tgrid, kWarps * 32, 0, stream>>>(
          tree_meta, g0, ng, part_acc, part_m, part_l, entries, tree_acc,
          tree_m, tree_l, tree_entries, out, m, dv);
    } else {
      attention_tree_kernel<V, double, T><<<tgrid, kWarps * 32, 0, stream>>>(
          tree_meta, g0, ng, tree_acc, tree_m, tree_l, tree_entries, tree_acc,
          tree_m, tree_l, tree_entries, out, m, dv);
    }
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// run_ptr (NR + 1,), pieces (P, 4), tree_meta (G, 4), cols (NNZP,) int32;
// q (H or 1, M, D) already scaled, k (H or 1, Mc, D), vmat (H or 1, Mc,
// DV) and out (H, M, DV), all of qk_type (0 f32, 1 bf16), with head
// strides of 0 for a shared operand; mask (NNZP, V) bool; scratch, null
// when unused: part_acc (H, entries, V, DV), part_m and part_l
// (H, entries, V) f32; tree_acc (H, tree_entries, V, DV) f64, tree_m
// (H, tree_entries, V) f32, tree_l (H, tree_entries, V) f64.  levels: host
// array of (first group, group count) per tree level.  Each warp of the
// run kernel walks rpw (>= 1) consecutive runs.
extern "C" int attention_balanced_launch(
    const void* run_ptr, const void* pieces, const void* tree_meta,
    const void* cols, const void* q, const void* k, const void* vmat,
    const void* mask, void* out, void* part_acc, void* part_m, void* part_l,
    void* tree_acc, void* tree_m, void* tree_l, int m, int d, int dv,
    int num_runs, int heads, int v, int k_blk, int64_t q_hstride,
    int64_t k_hstride, int64_t v_hstride, const void* levels, int num_levels,
    int64_t entries, int64_t tree_entries, int qk_type, int rpw,
    void* stream) {
  auto run = [&](auto vt, auto tt) {
    return launch<decltype(vt)::value, decltype(tt)>(
        static_cast<const int*>(run_ptr), static_cast<const int*>(pieces),
        static_cast<const int*>(tree_meta), static_cast<const int*>(cols), q,
        k, vmat, static_cast<const uint8_t*>(mask), out,
        static_cast<float*>(part_acc), static_cast<float*>(part_m),
        static_cast<float*>(part_l), static_cast<double*>(tree_acc),
        static_cast<float*>(tree_m), static_cast<double*>(tree_l), m, d, dv,
        num_runs, heads, k_blk, q_hstride, k_hstride, v_hstride,
        static_cast<const int*>(levels), num_levels, entries, tree_entries,
        rpw, static_cast<cudaStream_t>(stream));
  };
  auto by_type = [&](auto vt) {
    if (qk_type == 0) return run(vt, float{});
    if (qk_type == 1) return run(vt, __nv_bfloat16{});
    return cudaErrorInvalidValue;
  };
  if (v == 8) return by_type(std::integral_constant<int, 8>{});
  if (v == 16) return by_type(std::integral_constant<int, 16>{});
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(attention_balanced_error_string)
