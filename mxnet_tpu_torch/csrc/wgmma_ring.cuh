// Hopper building blocks of the bf16 and fp16 wgmma conv kernels
// (conv_bf16_wgmma.cu): mbarriers, TMA loads (tiled and im2col) that
// complete on them, wgmma matrix descriptors of 128-byte-swizzled tiles,
// the m64nNk16 bf16 and fp16 products, and the driver's tensor-map
// encoders, reached through the runtime (cudaGetDriverEntryPoint*) so the
// library links without -lcuda.  Every helper is a single PTX instruction or a
// wait loop around one; the layouts they assume are stated where the
// kernels use them.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxt_wgmma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void bar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive once and expect `bytes` more from the copies of this phase
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(b))
               : "memory");
}

// wait until the phase of parity `parity` has completed.  The retry loop
// lives inside the asm: a loop the compiler sees as divergent before a
// wgmma makes ptxas serialize the products (C7518).
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------ TMA loads
// Each copies one box of the tensor behind `map` (a __grid_constant__
// kernel parameter) to `dst` and completes its bytes on `bar`; elements
// out of the tensor's bounds arrive as zeros.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// im2col over an NHWC tensor: the map's pixelsPerColumn pixels from (n,
// h, w) on, in N, H, W order within the map's bounding box, each shifted
// by (oh, ow) — a filter tap — and channelsPerPixel channels from c of
// each; pixels shifted off the image arrive as zeros (the conv's halo).
__device__ __forceinline__ void tma_im2col(void* dst, const CUtensorMap* map,
                                           uint64_t* bar, int c, int w,
                                           int h, int n, uint16_t ow,
                                           uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(ow), "h"(oh)
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// The descriptor of a tile of 2-byte halves in shared memory as TMA
// writes it with 128-byte swizzling: rows of 128 bytes (64 values), the
// swizzle's 8-row pattern 1024-byte aligned.  K-major (k along the
// row): `addr` steps 32 bytes a 16-deep k step, `sbo` = 1024 (8 rows),
// `lbo` unused.  MN-major (m or n along the row, k down the rows): `addr`
// steps 16 rows (2048 bytes) a k step, `sbo` = 1024 (the next 8 k rows),
// `lbo` = the bytes to the next 64 values of m or n.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products (fence after wg_wait, before wg_fence)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32, N / 2 registers a thread) = (scale_d ? d : 0) + A (64
// x 16) . B (16 x N), A and B 2-byte halves behind descriptors: bf16
// (`.bf16.bf16`) or, with F16, fp16 (`.f16.f16`), the same shapes and
// layouts; TA, TB: 1 where A, B is MN-major.  Thread t of the warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4)
// (+ 1): d[4 j .. 4 j + 3] = (r, c), (r, c + 1), (r + 8, c), (r + 8, c +
// 1).
#define MXT_WGMMA_N64(TY)                                                   \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31}, "                                               \
      "%32, %33, p, 1, 1, %35, %36;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))

#define MXT_WGMMA_N128(TY)                                                  \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                 \
      "%64, %65, p, 1, 1, %67, %68;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))

template <int TA, int TB, bool F16>
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (F16)
    MXT_WGMMA_N64("f16");
  else
    MXT_WGMMA_N64("bf16");
}

template <int TA, int TB, bool F16>
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (F16)
    MXT_WGMMA_N128("f16");
  else
    MXT_WGMMA_N128("bf16");
}

#undef MXT_WGMMA_N64
#undef MXT_WGMMA_N128

template <int N, int TA, int TB, bool F16 = false>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da,
                                    uint64_t db, int scale_d) {
  if constexpr (N == 64)
    mma_n64<TA, TB, F16>(d, da, db, scale_d);
  else
    mma_n128<TA, TB, F16>(d, da, db, scale_d);
}

// ------------------------------------------------- tensor-map encoders
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2colFn)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const int*, const int*,
                                   cuuint32_t, cuuint32_t, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

struct Encoders {
  EncodeTiledFn tiled = nullptr;
  EncodeIm2colFn im2col = nullptr;
  cudaError_t err = cudaSuccess;
};

inline void* driver_entry(const char* name, cudaError_t* err) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  *err = cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault,
                                          &found);
#else
  *err = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found);
#endif
  if (*err == cudaSuccess && (found != cudaDriverEntryPointSuccess || !fn))
    *err = cudaErrorSymbolNotFound;
  return fn;
}

// the two encoders, looked up once a process
inline const Encoders& encoders() {
  static const Encoders e = [] {
    Encoders r;
    r.tiled = reinterpret_cast<EncodeTiledFn>(
        driver_entry("cuTensorMapEncodeTiled", &r.err));
    if (r.err == cudaSuccess)
      r.im2col = reinterpret_cast<EncodeIm2colFn>(
          driver_entry("cuTensorMapEncodeIm2col", &r.err));
    return r;
  }();
  return e;
}

}  // namespace mxt_wgmma
