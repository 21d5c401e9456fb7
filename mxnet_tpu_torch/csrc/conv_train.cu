// The BatchNorm affine pass of the fused 3x3/s1/p1 conv + BatchNorm (+ add)
// (+ ReLU) training block, fp32, NHWC:
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

#include <cuda_runtime.h>

namespace {

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
  const long long work = vec ? total / 4 : total;
  long long blocks = (work + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zi = static_cast<const float*>(z);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* r = static_cast<const float*>(res);
  float* o = static_cast<float*>(out);
  if (vec)
    bn_affine_kernel<true><<<(unsigned)blocks, 256, 0, s>>>(
        zi, sc, sh, r, o, total, Cout, relu);
  else
    bn_affine_kernel<false><<<(unsigned)blocks, 256, 0, s>>>(
        zi, sc, sh, r, o, total, Cout, relu);
  return (int)cudaGetLastError();
}
