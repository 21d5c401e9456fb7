// The BatchNorm affine pass of the fused 3x3/s1/p1 conv + BatchNorm (+ add)
// (+ ReLU) training block, fp32, bf16 or fp16, NHWC:
//
//   bn_affine   out = act(z * scale[c] + shift[c] (+ res)), elementwise.
//
// (The conv z with its per-channel sums, conv_stats, is the STATS
// instance of conv3x3_tc.cu, which also holds the conv alone and the data
// gradient; the weight gradient is conv_wgrad.cu's.)
//
// Replaces: mxnet_tpu/ops/pallas_block.py `_affine_kernel` (`_affine`),
// the second pass of the training forward of `residual_block_fused`.
//
// Bound on an H100: it moves 2-3 tensors of N*H*W*Cout floats and does
// 2-4 flops an element, so bytes bound it (103 MB, 31 us at
// (64,56,56,64)).
//
// Design.  CUDA C++ rather than Triton, so the port keeps one build system
// and nothing compiles at first launch: float4 loads and stores when
// Cout % 4 == 0 and the bases are 16-byte aligned, a grid-stride loop,
// scale and shift read per element (they stay in L1).
//
// The bf16 instance (the bf16 training slice; `_affine_kernel` computes
// in f32 and stores z's dtype): z, res and out bf16, scale and shift fp32.
// Each value is widened to fp32, the affine, the add and the ReLU run in
// fp32 as the fp32 instance's, and the result is rounded once to bf16 at
// the store.  8 halves a 16-byte load and store when Cout % 8 == 0 and
// the bases are aligned, else one element at a time.  Bound: bytes, 2 an
// element each way (103 MB, 0.0307 ms at (128, 56, 56, 64)).
//
// The fp16 instance (the fp16 training slice): the bf16 instance's code
// on `__half` z, res and out: fp32 arithmetic, one rounding to nearest
// even at the store (+-inf past 65504, as the reference's cast; fp16
// subnormals kept), 8 halves a 16-byte access.  Bound as bf16's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
using mxt_tf32::Half;

template <bool VEC>
__global__ void __launch_bounds__(256)
bn_affine_kernel(const float* __restrict__ z, const float* __restrict__ scale,
                 const float* __restrict__ shift,
                 const float* __restrict__ res, float* __restrict__ out,
                 long long total, int Cout, int relu) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if constexpr (VEC) {
    const long long n4 = total / 4;
    const int cq = Cout / 4;
    const float4* z4 = reinterpret_cast<const float4*>(z);
    const float4* r4 = reinterpret_cast<const float4*>(res);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n4; i += stride) {
      const int c = (int)(i % cq) * 4;
      const float4 v = z4[i];
      const float4 sc = *reinterpret_cast<const float4*>(scale + c);
      const float4 sh = *reinterpret_cast<const float4*>(shift + c);
      float4 y = make_float4(fmaf(v.x, sc.x, sh.x), fmaf(v.y, sc.y, sh.y),
                             fmaf(v.z, sc.z, sh.z), fmaf(v.w, sc.w, sh.w));
      if (res) {
        const float4 r = r4[i];
        y.x += r.x; y.y += r.y; y.z += r.z; y.w += r.w;
      }
      if (relu) {
        y.x = y.x > 0.f ? y.x : 0.f; y.y = y.y > 0.f ? y.y : 0.f;
        y.z = y.z > 0.f ? y.z : 0.f; y.w = y.w > 0.f ? y.w : 0.f;
      }
      o4[i] = y;
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
      const int c = (int)(i % Cout);
      float y = fmaf(z[i], scale[c], shift[c]);
      if (res) y += res[i];
      if (relu) y = y > 0.f ? y : 0.f;
      out[i] = y;
    }
  }
}

// 8 half values (T) of a 16-byte word as fp32, and back rounded once each
template <typename T>
__device__ __forceinline__ void unpack8(const uint4& q, float (&f)[8]) {
  const auto* h = reinterpret_cast<const typename Half<T>::T2*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = Half<T>::wide2(h[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 q;
  auto* h = reinterpret_cast<typename Half<T>::T2*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = Half<T>::narrow2(f[2 * k], f[2 * k + 1]);
  return q;
}

// The body of the half instances (T bf16 or fp16).
template <typename T, bool VEC>
__device__ __forceinline__ void bn_affine_half(
    const T* __restrict__ z, const float* __restrict__ scale,
    const float* __restrict__ shift, const T* __restrict__ res,
    T* __restrict__ out, long long total, int Cout, int relu) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if constexpr (VEC) {
    const long long n8 = total / 8;
    const int cq = Cout / 8;
    const uint4* z8 = reinterpret_cast<const uint4*>(z);
    const uint4* r8 = reinterpret_cast<const uint4*>(res);
    uint4* o8 = reinterpret_cast<uint4*>(out);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n8; i += stride) {
      const int c = (int)(i % cq) * 8;
      float v[8], r[8];
      unpack8<T>(z8[i], v);
      if (res) unpack8<T>(r8[i], r);
      const float4 sc[2] = {*reinterpret_cast<const float4*>(scale + c),
                            *reinterpret_cast<const float4*>(scale + c + 4)};
      const float4 sh[2] = {*reinterpret_cast<const float4*>(shift + c),
                            *reinterpret_cast<const float4*>(shift + c + 4)};
      const float* scf = reinterpret_cast<const float*>(sc);
      const float* shf = reinterpret_cast<const float*>(sh);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float y = fmaf(v[k], scf[k], shf[k]);
        if (res) y += r[k];
        if (relu) y = y > 0.f ? y : 0.f;
        v[k] = y;
      }
      o8[i] = pack8<T>(v);
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
      const int c = (int)(i % Cout);
      float y = fmaf(Half<T>::wide(z[i]), scale[c], shift[c]);
      if (res) y += Half<T>::wide(res[i]);
      if (relu) y = y > 0.f ? y : 0.f;
      out[i] = Half<T>::narrow(y);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(256)
bn_affine_bf16_kernel(const bf16* __restrict__ z,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      const bf16* __restrict__ res, bf16* __restrict__ out,
                      long long total, int Cout, int relu) {
  bn_affine_half<bf16, VEC>(z, scale, shift, res, out, total, Cout, relu);
}

template <bool VEC>
__global__ void __launch_bounds__(256)
bn_affine_f16_kernel(const f16* __restrict__ z,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     const f16* __restrict__ res, f16* __restrict__ out,
                     long long total, int Cout, int relu) {
  bn_affine_half<f16, VEC>(z, scale, shift, res, out, total, Cout, relu);
}

// The grid of a launch over `work` items: a thread an item, at most 32
// blocks an SM of 132 (grid-stride beyond).
unsigned grid_of(long long work) {
  long long blocks = (work + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  return (unsigned)blocks;
}

}  // namespace

// All pointers are contiguous fp32 device memory; it returns
// cudaGetLastError() after its launch.
// z, res, out (total,) as rows of Cout channels; scale, shift (Cout,);
// res may be null.  vec needs Cout % 4 == 0 and 16-byte aligned bases.
extern "C" int mxt_bn_affine_f32(const void* z, const void* scale,
                                 const void* shift, const void* res,
                                 void* out, long long total, int Cout,
                                 int relu, int vec, void* stream) {
  if (total <= 0 || Cout <= 0 || total % Cout != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = grid_of(vec ? total / 4 : total);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zi = static_cast<const float*>(z);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* r = static_cast<const float*>(res);
  float* o = static_cast<float*>(out);
  if (vec)
    bn_affine_kernel<true><<<blocks, 256, 0, s>>>(zi, sc, sh, r, o, total,
                                                  Cout, relu);
  else
    bn_affine_kernel<false><<<blocks, 256, 0, s>>>(zi, sc, sh, r, o, total,
                                                   Cout, relu);
  return (int)cudaGetLastError();
}

// The same on bf16 z, res and out (scale and shift fp32); vec needs
// Cout % 8 == 0 and 16-byte aligned bases.
extern "C" int mxt_bn_affine_bf16(const void* z, const void* scale,
                                  const void* shift, const void* res,
                                  void* out, long long total, int Cout,
                                  int relu, int vec, void* stream) {
  if (total <= 0 || Cout <= 0 || total % Cout != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = grid_of(vec ? total / 8 : total);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* zi = static_cast<const bf16*>(z);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const bf16* r = static_cast<const bf16*>(res);
  bf16* o = static_cast<bf16*>(out);
  if (vec)
    bn_affine_bf16_kernel<true><<<blocks, 256, 0, s>>>(zi, sc, sh, r, o,
                                                       total, Cout, relu);
  else
    bn_affine_bf16_kernel<false><<<blocks, 256, 0, s>>>(zi, sc, sh, r, o,
                                                        total, Cout, relu);
  return (int)cudaGetLastError();
}

// The same on fp16 z, res and out (scale and shift fp32); vec needs
// Cout % 8 == 0 and 16-byte aligned bases.
extern "C" int mxt_bn_affine_f16(const void* z, const void* scale,
                                 const void* shift, const void* res,
                                 void* out, long long total, int Cout,
                                 int relu, int vec, void* stream) {
  if (total <= 0 || Cout <= 0 || total % Cout != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = grid_of(vec ? total / 8 : total);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const f16* zi = static_cast<const f16*>(z);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const f16* r = static_cast<const f16*>(res);
  f16* o = static_cast<f16*>(out);
  if (vec)
    bn_affine_f16_kernel<true><<<blocks, 256, 0, s>>>(zi, sc, sh, r, o,
                                                      total, Cout, relu);
  else
    bn_affine_f16_kernel<false><<<blocks, 256, 0, s>>>(zi, sc, sh, r, o,
                                                       total, Cout, relu);
  return (int)cudaGetLastError();
}
