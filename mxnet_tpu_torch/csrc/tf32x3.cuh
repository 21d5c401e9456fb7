// Device helpers of the 3xTF32 tensor-core kernels (conv_wgrad.cu,
// conv3x3_tc.cu, causal_attention.cu): asynchronous copies into shared
// memory, the hi/lo split of an fp32 value into TF32 parts, and the
// m16n8k8 TF32 product.
//
// 3xTF32 ("fast fp32"): every fp32 operand v is split into TF32 hi and lo,
// and each product is lo*hi' + hi*lo' + hi*hi', small terms first.  The
// dropped lo*lo' and the truncation of lo leave an error of fp32's order
// (one TF32 product alone errs by ~2^-11).  The tensor core truncates its
// own fp32 sums, so the kernels gather a short chain of products in a run
// accumulator from zero and add it to their sums with IEEE adds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxt_tf32 {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v = hi + lo with hi = v's top 11 significant bits (a TF32 value, v
// rounded toward zero) and lo = v - hi, exact in fp32; the tensor core
// reads lo's top 11 bits, so hi + lo as it sees them is within 2^-21 |v|
// of v.  Masking costs an integer op where cvt.rna.tf32.f32 is a
// sequence of compares and selects (its NaN and overflow handling).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}

// c += a . b on one 16 x 8 x 8 TF32 tile: a the row-major 16 x 8 A
// fragment, b the column-major 8 x 8 B fragment, c the 16 x 8 fp32 sums
// (lane (g, t) = (lane / 4, lane % 4) holds a: (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); b: (t, g), (t + 4, g); c: (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += the three TF32 products of the split operands, small terms first
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ahi,
                                           const uint32_t* alo,
                                           const uint32_t* bhi,
                                           const uint32_t* blo) {
  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

// run += the 3xTF32 products of one 8-deep step of a warp's fp32
// fragments (a[mi] 16 x 8 A fragments, b[ni] 8 x 8 B fragments), each
// split into hi and lo here
template <int MI, int NI>
__device__ __forceinline__ void mma_step(const float (&a)[MI][4],
                                         const float (&b)[NI][2],
                                         float (&run)[MI][NI][4]) {
  uint32_t ahi[MI][4], alo[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[mi][e], ahi[mi][e], alo[mi][e]);
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    uint32_t bhi[2], blo[2];
    split(b[ni][0], bhi[0], blo[0]);
    split(b[ni][1], bhi[1], blo[1]);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      mma_3xtf32(run[mi][ni], ahi[mi], alo[mi], bhi, blo);
  }
}

}  // namespace mxt_tf32
