// fp32 and bf16 operands on the TF32 tensor cores (mma.sync m16n8k8),
// shared by the fused attention (attention.cu), the SDDMM tile
// (sddmm_rows.cuh) and the run-carried attention (attention_balanced.cu,
// which takes the bf16 widening only).
//
// A bf16 is the top half of the fp32 with the same value, so widening is a
// shift or a mask.  An fp32 operand x is split into big = tf32(x) (cvt.rna:
// round to nearest, ties away) and small = tf32(x - big), and a . b is
// taken as big.big + big.small + small.big with fp32 accumulators
// (3xTF32): plain TF32 keeps about 10 mantissa bits, the split about 21.
// A widened bf16 is exact in TF32: its small part is 0, and the products
// that would take it are not issued (Frag<N, true>).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace repro {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The 8 bf16 values of a 16-byte word, widened to fp32.
__device__ __forceinline__ void widen8(const uint4 u, float (&x)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// cvt.rna.tf32.f32's rounding in two integer instructions (the compiler
// adds a NaN check to the cvt): half a TF32 ulp added to the magnitude,
// the 13 low bits cleared.  Equal to the cvt for every input but NaNs
// whose payload lies in the low bits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An mma operand fragment of N fp32 values split into TF32 big and small;
// kExact: values that TF32 holds exactly (widened bf16), whose small part
// is 0 and is never used.
template <int N, bool kExact = false>
struct Frag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    if constexpr (kExact) {
      big[i] = __float_as_uint(x);
    } else {
      big[i] = to_tf32(x);
      small[i] = to_tf32(x - __uint_as_float(big[i]));
    }
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
// accumulators make two chains of dependent mma instead of one.  A product
// with an exact operand's small part is 0 and is not taken.
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma_3xtf32(float (&hi)[4], float (&lo)[4],
                                           const Frag<4, kAExact>& a,
                                           const Frag<2, kBExact>& b) {
  if constexpr (!kBExact) mma_tf32(lo, a.big, b.small);
  if constexpr (!kAExact) mma_tf32(lo, a.small, b.big);
  mma_tf32(hi, a.big, b.big);
}

}  // namespace repro
