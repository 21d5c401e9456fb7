// Device helpers of the tensor-core kernels (conv_wgrad.cu,
// conv3x3_tc.cu, flash_fwd_tc.cuh): asynchronous copies into shared
// memory, the hi/lo split of an fp32 value into TF32 parts, the m16n8k8
// TF32 product, and, for the bf16 and fp16 instances of the conv kernels,
// the m16n8k16 bf16 and fp16 products, the half types' conversions
// (`Half<T>`) and the transposing ldmatrix.
//
// 3xTF32 ("fast fp32"): every fp32 operand v is split into TF32 hi and lo,
// and each product is lo*hi' + hi*lo' + hi*hi', small terms first.  The
// dropped lo*lo' and the truncation of lo leave an error of fp32's order
// (one TF32 product alone errs by ~2^-11).  The tensor core truncates its
// own fp32 sums, so the kernels gather a short chain of products in a run
// accumulator from zero and add it to their sums with IEEE adds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// c += a . b on one 16 x 8 x 16 bf16 tile with fp32 sums: a the row-major
// 16 x 16 A fragment (lane (g, t) holds (g, 2t..2t+1), (g + 8, 2t..),
// (g, 2t + 8..), (g + 8, 2t + 8..), two halves a register, the lower k in
// the lower half), b the column-major 16 x 8 B fragment ((2t..2t+1, g),
// (2t + 8..2t + 9, g)), c as the TF32 product's.  The products of bf16
// values are exact in fp32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same on fp16 operands (`.f16.f16`, the same fragments): products of
// fp16 values (11 significant bits each) are exact in fp32 too.
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a,
                                        const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The half types of the conv kernels' bf16 and fp16 instances: the pair
// type, the raw bits, the widening to fp32, the rounding from it (to
// nearest even: fp16 overflows to +-inf past 65504 and keeps its
// subnormals, as a cast of the fp32 value does) and the m16n8k16 product.
template <typename T>
struct Half;

template <>
struct Half<__nv_bfloat16> {
  using T = __nv_bfloat16;
  using T2 = __nv_bfloat162;
  __device__ static uint16_t bits(T v) { return __bfloat16_as_ushort(v); }
  __device__ static float wide(T v) { return __bfloat162float(v); }
  __device__ static float2 wide2(T2 v) { return __bfloat1622float2(v); }
  __device__ static T narrow(float v) { return __float2bfloat16_rn(v); }
  __device__ static T2 narrow2(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  __device__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    mma_bf16(c, a, b);
  }
};

template <>
struct Half<__half> {
  using T = __half;
  using T2 = __half2;
  __device__ static uint16_t bits(T v) { return __half_as_ushort(v); }
  __device__ static float wide(T v) { return __half2float(v); }
  __device__ static float2 wide2(T2 v) { return __half22float2(v); }
  __device__ static T narrow(float v) { return __float2half_rn(v); }
  __device__ static T2 narrow2(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  __device__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    mma_f16(c, a, b);
  }
};

// Four 8 x 8 matrices of 2-byte values from shared memory, transposed:
// lane l gives the address of row l % 8 of matrix l / 8 (8 contiguous
// values, 16-byte aligned), and register j of lane (g, t) = (l / 4, l % 4)
// receives rows 2t and 2t + 1 of column g of matrix j, row 2t in the
// lower half.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
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
