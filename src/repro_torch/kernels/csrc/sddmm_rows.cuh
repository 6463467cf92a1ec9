// The row-parallel SDDMM kernel, shared by sddmm.cu (one head) and
// sddmm_batched.cu (a grid of H heads): S[h] = mask * (Q[h] @ K[h]^T),
// written in the blocked (NNZP, V) layout that the following SpMM reads,
// templated on the element type T of Q, K and S (float or bf16).
//
// Design: one thread per sampled row t (a nonzero vector of the blocked
// view), 128 rows per thread block, rows on gridDim.x and heads on
// gridDim.y.  The work per row is small (V dot products of length F), so
// what bounds a simple kernel is the latency of the dependent loads it
// waits on: block_win -> cols -> the K row.  Each thread therefore issues
// the whole K row and the V rows of Q's window block_win[t / k_blk] as
// independent 16-byte loads (when F is a multiple of 4 and the rows are
// 16-byte aligned; one float at a time otherwise, in the same order) and
// keeps its V sums in registers: no shared memory, no shuffles, no
// barriers.  It walks the whole feature dimension in one pass, so the
// reference's feature tile f_blk has no counterpart.  The threads of a
// warp cover consecutive rows, which share a handful of Q windows, so the
// Q rows come from L1.  Each thread writes its V results as one
// contiguous run, S[t, :] = acc * mask.
//   * A head reads Q and K at its own offsets, h * q_hstride and
//     h * k_hstride (0: shared by every head, one copy), and writes its
//     own (NNZP, V) slice.  The per-thread arithmetic does not depend on
//     the head, so H heads in one launch give bitwise the output of H
//     one-head launches.
//   * Q rows past M read as zero, as the reference's zero-padded Q does.
//   * The dummy block of an all-empty matrix is covered; its mask is all
//     False, so it writes zeros.
// The mask arrives as one byte per element (torch.bool), a quarter of the
// reference's f32 copy; the arithmetic is the same.
// bf16 (the reference's bf16 path): Q and K are widened to fp32 as they
// are read (16-byte loads of 8 values when F is a multiple of 8), the
// dots are fp32, and S is rounded to bf16 once, at the store.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int kSddmmThreads = 128;

// The 8 bf16 values of a 16-byte word, widened to fp32 (a bf16 is the top
// half of the fp32 with the same value).
__device__ __forceinline__ void widen8(const uint4 u, float (&x)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int V, bool kVec, typename T>
__global__ void __launch_bounds__(kSddmmThreads)
sddmm_rows_kernel(const int* __restrict__ block_win, const int* __restrict__ cols,
                  const T* __restrict__ q, const T* __restrict__ k,
                  const uint8_t* __restrict__ mask, T* __restrict__ out,
                  int m, int f, int k_blk, int64_t nnzp, int64_t q_hstride,
                  int64_t k_hstride) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kSddmmThreads + threadIdx.x;
  if (t >= nnzp) return;
  const int64_t h = blockIdx.y;
  const T* qh = q + h * q_hstride;
  const int64_t row0 = static_cast<int64_t>(block_win[t / k_blk]) * V;
  const T* krow = k + h * k_hstride + static_cast<int64_t>(cols[t]) * f;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  if constexpr (kVec && !std::is_same<T, float>::value) {
    // 8 bf16 features per 16-byte load, in feature order
    for (int d = 0; d < f; d += 8) {
      float kv[8];
      widen8(__ldg(reinterpret_cast<const uint4*>(krow + d)), kv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (row0 + v < m) {
          float qv[8];
          widen8(__ldg(reinterpret_cast<const uint4*>(qh + (row0 + v) * f + d)),
                 qv);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[v] = fmaf(kv[j], qv[j], acc[v]);
        }
      }
    }
  } else if constexpr (kVec) {
#pragma unroll 2
    for (int d = 0; d < f; d += 4) {
      const float4 kv = __ldg(reinterpret_cast<const float4*>(krow + d));
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (row0 + v < m) {
          const float4 qv =
              __ldg(reinterpret_cast<const float4*>(qh + (row0 + v) * f + d));
          acc[v] = fmaf(kv.x, qv.x, acc[v]);
          acc[v] = fmaf(kv.y, qv.y, acc[v]);
          acc[v] = fmaf(kv.z, qv.z, acc[v]);
          acc[v] = fmaf(kv.w, qv.w, acc[v]);
        }
      }
    }
  } else {
    for (int d = 0; d < f; ++d) {
      const float kv = widen(krow[d]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (row0 + v < m) acc[v] = fmaf(kv, widen(qh[(row0 + v) * f + d]), acc[v]);
      }
    }
  }

  const uint8_t* mk = mask + t * V;
  T* o = out + h * nnzp * V + t * V;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int v = 0; v < V; v += 4) {
      const float4 r = make_float4(acc[v] * (mk[v] ? 1.f : 0.f),
                                   acc[v + 1] * (mk[v + 1] ? 1.f : 0.f),
                                   acc[v + 2] * (mk[v + 2] ? 1.f : 0.f),
                                   acc[v + 3] * (mk[v + 3] ? 1.f : 0.f));
      *reinterpret_cast<float4*>(o + v) = r;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      o[v] = __float2bfloat16_rn(acc[v] * (mk[v] ? 1.f : 0.f));
    }
  }
}

template <int V, typename T>
cudaError_t launch_sddmm_rows_v(const int* block_win, const int* cols,
                                const T* q, const T* k, const uint8_t* mask,
                                T* out, int m, int f, int num_blocks,
                                int heads, int k_blk, int64_t q_hstride,
                                int64_t k_hstride, cudaStream_t stream) {
  const int64_t nnzp = static_cast<int64_t>(num_blocks) * k_blk;
  const dim3 grid(static_cast<unsigned>((nnzp + kSddmmThreads - 1) / kSddmmThreads),
                  heads);
  // 16-byte loads need every head's rows 16-byte aligned: F a multiple of
  // 16 / sizeof(T) makes every row and every head stride so once the base
  // pointers are.
  const bool vec = f % (16 / sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0;
  if (vec) {
    sddmm_rows_kernel<V, true, T><<<grid, kSddmmThreads, 0, stream>>>(
        block_win, cols, q, k, mask, out, m, f, k_blk, nnzp, q_hstride,
        k_hstride);
  } else {
    sddmm_rows_kernel<V, false, T><<<grid, kSddmmThreads, 0, stream>>>(
        block_win, cols, q, k, mask, out, m, f, k_blk, nnzp, q_hstride,
        k_hstride);
  }
  return cudaGetLastError();
}

// block_win (NB,) int32, cols (NB * k_blk,) int32, q (M, F) T with heads
// q_hstride elements apart (0: shared), k (Mc, F) T with heads k_hstride
// apart (0: shared), mask (NB * k_blk, V) bool, out (heads, NB * k_blk, V)
// T with 16-byte alignment (a fresh allocation).  heads at most 65,535.
template <typename T>
cudaError_t launch_sddmm_rows(const void* block_win, const void* cols,
                              const void* q, const void* k, const void* mask,
                              void* out, int m, int f, int num_blocks,
                              int heads, int v, int k_blk, int64_t q_hstride,
                              int64_t k_hstride, void* stream) {
  const auto* bw = static_cast<const int*>(block_win);
  const auto* cl = static_cast<const int*>(cols);
  const auto* qq = static_cast<const T*>(q);
  const auto* kk = static_cast<const T*>(k);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<T*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8:
      return launch_sddmm_rows_v<8, T>(bw, cl, qq, kk, mk, o, m, f,
                                       num_blocks, heads, k_blk, q_hstride,
                                       k_hstride, st);
    case 16:
      return launch_sddmm_rows_v<16, T>(bw, cl, qq, kk, mk, o, m, f,
                                        num_blocks, heads, k_blk, q_hstride,
                                        k_hstride, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro
