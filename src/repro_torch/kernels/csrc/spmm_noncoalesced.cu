// SpMM with the non-coalesced thread mapping, the baseline of the paper's
// coalescing ablation (FlashSparse Fig. 15): C (M, N) = A (M, K) @ B (K, N),
// with fp32 values and B, bf16 values and B, or int8 values (one fp32 scale
// per K-block) and fp32 or bf16 B; C in B's type, fp32 sums.
//
// Replaces: src/repro/kernels/spmm_pallas.py, _fused_spmm_kernel with
// double_buffer=False (launched through spmm_pallas_noncoalesced), the
// TPU's serialised per-row fetch, with its precision variants
// (_apply_precision: bf16, and int8 through `quantized`).  The reference's
// variant keeps its kernel's arithmetic and serialises the row copies,
// with no overlap of copy and compute, as the TPU's analogue of the
// direct mapping's strided reads; this kernel keeps the paper's GPU
// baseline itself, the direct thread mapping, and overlaps its copies as
// spmm.cu does.  So its time against spmm.cu's prices the uncoalesced
// reads of B alone, not exposed copy latency, and its ratio is not the
// reference's.
//
// Bound on the card: bytes, as spmm.cu: vals (NNZP x V) + cols (NNZP) +
// win_ptr + B (K x N) + C (M x N) read or written once, each at its stored
// width (int8 values with a 4-byte scale a K-block); 2 * NNZP * V * N
// flops.
//
// Mapping, the property this baseline exists to measure.  The paper's
// memory-efficient mapping (spmm.cu) puts the 32 lanes of a warp on 32
// neighbouring columns of one window, so the B elements a warp reads for
// one vector are one contiguous row segment: one or a few 32-byte sectors
// per load instruction.  This kernel keeps the mapping that one replaces:
// the 32 lanes of a warp are on 32 different slices of windows at ONE
// column, so one load instruction reads B[cols[t_lane], col] from 32
// different rows of B - 32 sectors, of which each lane uses 4 bytes (bf16
// B: 2) - and C is written the same way.  A lane never takes a second,
// adjacent column: that would coalesce it partly.  Its time beside
// spmm.cu's at the same shapes is the ablation's number.
//
// Everything else is spmm.cu's, so that the number is the mapping's:
//   * Balanced work.  The lanes take the slices of the window plan
//     (kernels/_window.py, LanePlan: row 1's cut of every window of more
//     than split_blk K-blocks into equal slices), not whole windows, so no
//     lane's chain is longer than split_blk K-blocks; on a matrix without
//     such windows (the Amazon replica's A) the slices are the windows.
//   * Values and ids staged.  A block is 32 lanes x kWarps warps: its 32
//     slices (lane l of every warp on slice 32 g + l) at kWarps
//     neighbouring columns, one a warp, so the warps that share a 32-byte
//     sector of B run together between two barriers.  The slices' column
//     ids and values go through shared memory in chunks of kChunk vectors
//     a slice, copied by cp.async into one slot of a double buffer while
//     the other is summed: each is read from device memory once per
//     column tile (and the column tiles of one lane group are neighbouring
//     blocks, which find them in L2).  Each lane then keeps 8 B gathers in
//     flight before their products.
//   * Split windows.  A window's slices in one lane group form a run of
//     neighbouring lanes; a segmented scan by shuffles (a fixed tree of
//     additions over lanes 1, 2, 4, 8, 16 apart) leaves the run's sum in
//     its last lane, which stores it into C when the run is the whole
//     window, else as one fp32 partial; a second kernel adds a window's
//     partials in run order.  No atomics: every sum is taken in the same
//     order on every launch, so two launches give the same bits.
//   * Bits.  A window of at most split_blk K-blocks is one slice in one
//     lane: one fp32 running sum in vector order on the CUDA cores,
//     acc[v] = fma(a[t, v], B[cols[t], col], acc[v]) (spmm_fma.cuh), every
//     operand widened to fp32 as it is read (an int8 value to
//     q * scale[t / k_blk], rounded to fp32, as spmm_window.cuh dequantizes
//     it), no shuffle addition, one rounding to B's type at the store.
//     spmm.cu takes its products on the tensor cores in k-steps of 8
//     vectors, so the two agree to the kernel tolerance, not bit for bit.
// Padding vectors are multiplied, empty windows store zeros, and rows >= M
// are not written, as in spmm.cu.
#include "spmm_fma.cuh"
#include "spmm_window.cuh"

namespace {

constexpr int kLanes = 32;   // slices per block: one per lane of each warp
constexpr int kWarps = 16;   // columns per block: one per warp
constexpr int kThreads = kLanes * kWarps;
constexpr int kChunk = 16;   // vectors of a slice staged per pipeline step
constexpr int kUnroll = repro::kSpmmUnroll;  // B gathers in flight a lane

// Shared memory of a block: two slots, each holding every lane's chunk of
// values (a lane's row padded by 16 bytes, so the lanes' 16-byte reads of
// one vector fall in different banks), column ids and (int8 values) the
// vectors' K-block scales (rows padded by one word), and each lane's
// slice: its first vector and its vector count.
template <int V, typename Tv>
struct LaneRing {
  static constexpr bool kInt8 = std::is_same<Tv, int8_t>::value;
  static constexpr int kRow = kChunk * V * static_cast<int>(sizeof(Tv)) + 16;
  unsigned char vals[2][kLanes][kRow];
  int cols[2][kLanes][kChunk + 1];
  float scl[2][kLanes][kInt8 ? kChunk + 1 : 1];
  int lo[kLanes];
  int len[kLanes];
};

// acc[v] = fma(q[v] * scale, bv, acc[v]) for the V int8 values of one
// vector in shared memory: each dequantized to fp32 with one rounding, as
// spmm_window.cuh's ring does before its products.
template <int V>
__device__ __forceinline__ void fma_vector_q(float (&acc)[V], const int8_t* q,
                                             float scale,
                                             const float (&bv)[1]) {
  const unsigned* w = reinterpret_cast<const unsigned*>(q);
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const unsigned u = w[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = __fmul_rn(
          static_cast<float>(static_cast<int8_t>(u >> (8 * j))), scale);
      acc[4 * i + j] = fmaf(a, bv[0], acc[4 * i + j]);
    }
  }
}

template <typename Tv, typename Tb>
struct LaneArgs {
  const int* slice_ptr;  // (S + 1,) K-block ranges of the slices
  const int* slice_win;  // (S,) window of each slice
  const int* slice_out;  // (S,) -1 store C, p >= 0 store partial p, -2 none
  const int* cols;
  const Tv* vals;
  const float* scales;   // (NB,) per-K-block scales of int8 values, else null
  const Tb* b;
  Tb* c;
  float* part;           // (partials, V, N) fp32
  int m, n, num_slices, k_blk, col_tiles;
};

// One block per (lane group, column tile), column tiles fastest: blockIdx.x
// = group * col_tiles + tile.  threadIdx.x is the lane (slice 32 g + lane),
// threadIdx.y the warp (column tile * kWarps + warp).
template <int V, typename Tv, typename Tb, typename Idx>
__global__ void __launch_bounds__(kThreads)
spmm_noncoalesced_kernel(const LaneArgs<Tv, Tb> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& ring = *reinterpret_cast<LaneRing<V, Tv>*>(smem);
  constexpr bool kInt8 = LaneRing<V, Tv>::kInt8;
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * kLanes + lane;
  const int tile = blockIdx.x % a.col_tiles;
  const int64_t s = static_cast<int64_t>(blockIdx.x / a.col_tiles) * kLanes +
                    lane;
  const int col = tile * kWarps + threadIdx.y;
  const bool active = col < a.n;
  const bool has = s < a.num_slices;
  if (threadIdx.y == 0) {
    const int k0 = has ? a.slice_ptr[s] : 0;
    const int k1 = has ? a.slice_ptr[s + 1] : 0;
    ring.lo[lane] = k0 * a.k_blk;
    ring.len[lane] = (k1 - k0) * a.k_blk;
  }
  __syncthreads();
  const int my_len = ring.len[lane];
  // the block walks as many chunks as its longest slice needs (every warp
  // holds the same 32 slices, so every warp finds the same count)
  const int nchunks =
      (__reduce_max_sync(repro::kFullMask, my_len) + kChunk - 1) / kChunk;
  // chunks start at K-block boundaries (or kChunk vectors after one), so a
  // lane's values are 16-byte aligned when a K-block's are
  const bool vec16 = (reinterpret_cast<uintptr_t>(a.vals) & 15) == 0 &&
                     (a.k_blk * V * sizeof(Tv)) % 16 == 0;

  // cp.async of chunk ci of every lane's slice into slot ci % 2, by the
  // block's threads (narrow values without 16-byte alignment by plain
  // loads: the barrier before the chunk is summed orders them too)
  auto issue = [&](int ci) {
    const int slot = ci & 1;
    for (int i = tid; i < kLanes * kChunk; i += kThreads) {
      const int l = i / kChunk;
      const int r = i - l * kChunk;
      if (ci * kChunk + r < ring.len[l]) {
        const int t = ring.lo[l] + ci * kChunk + r;
        repro::cp_async4(&ring.cols[slot][l][r], a.cols + t);
        if constexpr (kInt8) {
          repro::cp_async4(&ring.scl[slot][l][r], a.scales + t / a.k_blk);
        }
      }
    }
    constexpr int kPer16 = 16 / sizeof(Tv);
    constexpr int kPieces = kChunk * V / kPer16;  // 16-byte pieces a lane
    if (vec16) {
      for (int i = tid; i < kLanes * kPieces; i += kThreads) {
        const int l = i / kPieces;
        const int p = i - l * kPieces;
        const int cnt = min(ring.len[l] - ci * kChunk, kChunk);
        if (p * kPer16 < cnt * V) {
          const Tv* src =
              a.vals + static_cast<Idx>(ring.lo[l] + ci * kChunk) * V +
              p * kPer16;
          repro::cp_async16_ca(ring.vals[slot][l] + 16 * p, src);
        }
      }
    } else {
      for (int i = tid; i < kLanes * kChunk * V; i += kThreads) {
        const int l = i / (kChunk * V);
        const int e = i - l * (kChunk * V);
        const int cnt = min(ring.len[l] - ci * kChunk, kChunk);
        if (e < cnt * V) {
          const Tv* src =
              a.vals + static_cast<Idx>(ring.lo[l] + ci * kChunk) * V + e;
          Tv* dst = reinterpret_cast<Tv*>(ring.vals[slot][l]) + e;
          if constexpr (sizeof(Tv) == 4) {
            repro::cp_async4(dst, src);
          } else {
            *dst = *src;
          }
        }
      }
    }
  };

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  if (nchunks > 0) issue(0);
  repro::cp_async_commit();
  for (int ci = 0; ci < nchunks; ++ci) {
    // chunk ci has landed and every thread is done with chunk ci - 1,
    // whose slot takes chunk ci + 1 while ci is summed
    repro::cp_async_wait_all();
    __syncthreads();
    if (ci + 1 < nchunks) issue(ci + 1);
    repro::cp_async_commit();

    const int slot = ci & 1;
    const int cnt = min(my_len - ci * kChunk, kChunk);  // <= 0: done
    const int* sc = ring.cols[slot][lane];
    const Tv* sv = reinterpret_cast<const Tv*>(ring.vals[slot][lane]);
    auto product = [&](int r, const float (&bv)[1]) {
      if constexpr (kInt8) {
        fma_vector_q<V>(acc, sv + r * V, ring.scl[slot][lane][r], bv);
      } else {
        repro::fma_vector<V, 1>(acc, sv + r * V, bv);
      }
    };
    if (active) {
      int r = 0;
      // 8 gathers in flight, each from this lane's own row of B, then
      // their products in vector order
      for (; r + kUnroll <= cnt; r += kUnroll) {
        float bv[kUnroll][1];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          bv[u][0] = repro::load_b(a.b + (static_cast<Idx>(sc[r + u]) * a.n +
                                          col));
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) product(r + u, bv[u]);
      }
      for (; r < cnt; ++r) {
        const float bv[1] = {
            repro::load_b(a.b + (static_cast<Idx>(sc[r]) * a.n + col))};
        product(r, bv);
      }
    }
  }

  // The runs of split windows: a segmented inclusive scan over the lanes
  // (lanes d apart, d = 1, 2, 4, 8, 16, added when on one window) leaves
  // each run's sum in its last lane.  A warp whose lanes are all on
  // different windows (every warp of a plan without split windows) skips
  // it, and a run of one lane is never added to.
  const int win = has ? a.slice_win[s] : -1 - lane;
  const int out = has ? a.slice_out[s] : -2;
  const int prev = __shfl_up_sync(repro::kFullMask, win, 1);
  if (__any_sync(repro::kFullMask, lane > 0 && prev == win)) {
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const int wd = __shfl_up_sync(repro::kFullMask, win, d);
      float y[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        y[v] = __shfl_up_sync(repro::kFullMask, acc[v], d);
      }
      if (lane >= d && wd == win) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += y[v];
      }
    }
  }
  if (!active || out == -2) return;
  if (out == -1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int64_t row = static_cast<int64_t>(win) * V + v;
      if (row < a.m) a.c[row * a.n + col] = repro::from_f32<Tb>(acc[v]);
    }
  } else {
    float* p = a.part + static_cast<int64_t>(out) * V * a.n + col;
#pragma unroll
    for (int v = 0; v < V; ++v) p[static_cast<int64_t>(v) * a.n] = acc[v];
  }
}

// The second pass: C rows of window part_win[i] = the sum of its partials
// in run order, one thread per column (blockIdx.x = i).
template <int V, typename Tb>
__global__ void __launch_bounds__(128)
add_partials_kernel(const int* __restrict__ part_win,
                    const int* __restrict__ part_ptr,
                    const float* __restrict__ part, Tb* __restrict__ c, int m,
                    int n) {
  const int i = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= n) return;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int p = part_ptr[i]; p < part_ptr[i + 1]; ++p) {
    const float* src = part + static_cast<int64_t>(p) * V * n + col;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] += src[static_cast<int64_t>(v) * n];
  }
  const int64_t w = part_win[i];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t row = w * V + v;
    if (row < m) c[row * n + col] = repro::from_f32<Tb>(acc[v]);
  }
}

template <typename Tv, typename Tb, typename Idx>
cudaError_t launch(const LaneArgs<Tv, Tb>& args, const void* part_win,
                   const void* part_ptr, int num_part_windows, int v,
                   cudaStream_t stream) {
  if (std::is_same<Tv, int8_t>::value && args.scales == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int64_t groups = (args.num_slices + kLanes - 1) / kLanes;
  const int64_t blocks = groups * args.col_tiles;
  if (blocks > 0x7fffffff || (args.n + 127) / 128 > 65535) {
    return cudaErrorInvalidValue;
  }
  auto run = [&](auto vt) {
    constexpr int V = decltype(vt)::value;
    auto kernel = spmm_noncoalesced_kernel<V, Tv, Tb, Idx>;
    const int smem = static_cast<int>(sizeof(LaneRing<V, Tv>));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // leave no sticky error
      return err;
    }
    if (blocks > 0) {
      kernel<<<static_cast<unsigned>(blocks), dim3(kLanes, kWarps), smem,
               stream>>>(args);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    if (num_part_windows > 0) {
      add_partials_kernel<V, Tb>
          <<<dim3(num_part_windows, (args.n + 127) / 128), 128, 0, stream>>>(
              static_cast<const int*>(part_win),
              static_cast<const int*>(part_ptr), args.part, args.c, args.m,
              args.n);
      err = cudaGetLastError();
    }
    return err;
  };
  if (v == 8) return run(std::integral_constant<int, 8>{});
  if (v == 16) return run(std::integral_constant<int, 16>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// The lane plan (kernels/_window.py, LanePlan): slice_ptr (S + 1,),
// slice_win (S,), slice_out (S,), part_win (NPW,), part_ptr (NPW + 1,)
// int32; cols (NNZP,) int32, vals (NNZP, V) of vals_type (0 f32, 1 bf16,
// 2 int8), scales (NB,) f32 (int8 values only, else null), b (K, N) of
// b_type (0 f32, 1 bf16) row-major, c (M, N) of b_type row-major, part
// (partials, V, N) f32 scratch (null without partials); wide != 0 indexes
// B and vals in 64 bits.
extern "C" int spmm_noncoalesced_launch(
    const void* slice_ptr, const void* slice_win, const void* slice_out,
    const void* cols, const void* vals, const void* scales, const void* b,
    void* c, void* part, const void* part_win, const void* part_ptr, int m,
    int n, int num_slices, int num_part_windows, int v, int k_blk,
    int vals_type, int b_type, int wide, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tv, auto tb, auto idx) {
    using Tv = decltype(tv);
    using Tb = decltype(tb);
    const LaneArgs<Tv, Tb> args{static_cast<const int*>(slice_ptr),
                                static_cast<const int*>(slice_win),
                                static_cast<const int*>(slice_out),
                                static_cast<const int*>(cols),
                                static_cast<const Tv*>(vals),
                                static_cast<const float*>(scales),
                                static_cast<const Tb*>(b),
                                static_cast<Tb*>(c),
                                static_cast<float*>(part),
                                m, n, num_slices, k_blk,
                                (n + kWarps - 1) / kWarps};
    return launch<Tv, Tb, decltype(idx)>(args, part_win, part_ptr,
                                         num_part_windows, v, st);
  };
  auto by_index = [&](auto tv, auto tb) {
    return wide ? run(tv, tb, int64_t{}) : run(tv, tb, int{});
  };
  if (vals_type == 0 && b_type == 0) return by_index(float{}, float{});
  if (vals_type == 1 && b_type == 1) {
    return by_index(__nv_bfloat16{}, __nv_bfloat16{});
  }
  if (vals_type == 2 && b_type == 0) return by_index(int8_t{}, float{});
  if (vals_type == 2 && b_type == 1) return by_index(int8_t{}, __nv_bfloat16{});
  return cudaErrorInvalidValue;
}

REPRO_ERROR_STRING(spmm_noncoalesced_error_string)
