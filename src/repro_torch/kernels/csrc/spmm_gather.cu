// The staged copy of the pre-fusion SpMM baseline (spmm_staged.cu):
// G = B[cols] (NNZP x N), written to device memory, with fp32 or bf16 B.
//
// Replaces: the jnp.take gather of src/repro/kernels/spmm_pallas.py,
// spmm_pallas_staged (XLA there, outside the Pallas kernel; a kernel here,
// since torch's indexing reached about a third of this copy's bound on an
// H100).
//
// Bound on the card: bytes.  cols (NNZP) read, the NNZP gathered rows of
// B read (each distinct row of B at least once) and G (NNZP x N) written,
// at B's width.
//
// Design: consecutive threads on consecutive 16-byte pieces of the
// gathered rows (a warp on one 512-byte row of fp32 B at N = 128, or on
// 32 / pieces narrower rows), four rows in flight a warp, the int32 column
// ids read as they are; 16-byte loads and stores where B's rows and both
// buffers allow, else one element a thread.
#include "common.cuh"

namespace {

constexpr int kGatherThreads = 256;
constexpr int kGatherRows = 4;  // rows (or sets of narrow rows) a warp

// g[r] = b[cols[r]] for rows r < rows of `per` pieces of type P each;
// `sub` rows a warp at once (32 / per of them when per divides 32, else 1,
// its lanes then striding the row by 32).
template <typename P>
__global__ void __launch_bounds__(kGatherThreads)
spmm_gather_kernel(const int* __restrict__ cols, const P* __restrict__ b,
                   P* __restrict__ g, int64_t rows, int per, int sub) {
  const int lane = threadIdx.x & 31;
  const int span = 32 / sub;  // lanes a row
  const int r_off = lane / span;
  const int p0 = lane - r_off * span;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kGatherThreads + threadIdx.x) >> 5;
  int64_t r[kGatherRows];
  int id[kGatherRows];
#pragma unroll
  for (int k = 0; k < kGatherRows; ++k) {
    r[k] = (warp * kGatherRows + k) * sub + r_off;
    id[k] = r[k] < rows ? __ldg(cols + r[k]) : 0;
  }
  for (int p = p0; p < per; p += span) {
    P x[kGatherRows];
#pragma unroll
    for (int k = 0; k < kGatherRows; ++k) {
      if (r[k] < rows) x[k] = __ldg(b + static_cast<int64_t>(id[k]) * per + p);
    }
#pragma unroll
    for (int k = 0; k < kGatherRows; ++k) {
      if (r[k] < rows) g[r[k] * per + p] = x[k];
    }
  }
}

template <typename P>
cudaError_t gather(const void* cols, const void* b, void* g, int64_t rows,
                   int per, cudaStream_t stream) {
  const int sub = per < 32 && 32 % per == 0 ? 32 / per : 1;
  const int64_t warps = (rows + int64_t(sub) * kGatherRows - 1) /
                        (int64_t(sub) * kGatherRows);
  const int64_t blocks = (warps * 32 + kGatherThreads - 1) / kGatherThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  spmm_gather_kernel<P><<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                          stream>>>(static_cast<const int*>(cols),
                                    static_cast<const P*>(b),
                                    static_cast<P*>(g), rows, per, sub);
  return cudaGetLastError();
}

}  // namespace

// G = B[cols]: cols (rows,) int32, b (K, N) and g (rows, N) row-major of
// dtype (0 f32, 1 bf16).
extern "C" int spmm_gather_launch(const void* cols, const void* b, void* g,
                                  int rows, int n, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int64_t row_bytes = static_cast<int64_t>(n) * (dtype == 0 ? 4 : 2);
  const bool vec16 = row_bytes % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(b) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (vec16) {
    return gather<uint4>(cols, b, g, rows, static_cast<int>(row_bytes / 16),
                         st);
  }
  if (dtype == 0) return gather<unsigned>(cols, b, g, rows, n, st);
  return gather<unsigned short>(cols, b, g, rows, n, st);
}

REPRO_ERROR_STRING(spmm_gather_error_string)
