// 3x3/s1/p1 convolution with a folded frozen-BatchNorm epilogue, an
// optional residual add and an optional ReLU, fp32, NHWC x HWIO.
//
//   out[n,h,w,co] = act( sum_{dh,dw,ci} x[n,h+dh-1,w+dw-1,ci] * W[dh,dw,ci,co]
//                        * scale[co] + shift[co] (+ res[n,h,w,co]) )
//   scale = gamma * rsqrt(var + eps),  shift = beta - mean * scale
//
// Replaces: mxnet_tpu/ops/pallas_block.py `_conv_affine_kernel` (launched
// by `_conv_affine`, with `_fold` and the frozen branch of `_fused_fwd`),
// reached through mxnet_tpu/ops/nn.py `residual_block` from Gluon's
// `fused_conv_bn_relu` (the 3x3 mid conv of every ResNet-50 v1
// bottleneck, the 3x3/s1 convs of ResNet-18/34's basic blocks).
//
// Bound on an H100: fp32 operations at the ResNet shapes.  A segment does
// 2 * N*H*W * 9*C * Cout flops (231 MFLOP per image at every ResNet-50
// stage) against (N*H*W*(C + Cout) + 9*C*Cout) * 4 bytes; at batch 8 that
// is 1.85 GFLOP, ~28 us at the 67 TFLOP/s fp32 peak, over ~3-12 MB, ~1-4
// us at 3.35 TB/s.  At batch 1 on the 7x7x512 stage the 9.4 MB weight
// read and the under-filled grid dominate instead.
//
// Design: an implicit GEMM on the CUDA cores (TF32 stays off, as
// everywhere in the port).  M = N*H*W output pixels, N = Cout, K = 9*C
// in tap-major order, so the HWIO weight is read as the row-major
// (9C, Cout) matrix the TPU kernel multiplies (`_patches`).  The tile
// and its mainloop are conv3x3_tile.cuh's, shared with conv_train.cu: a
// block of 256 threads owns a 64-pixel x 64-channel output tile and
// streams K in chunks of 16 through double-buffered shared memory, the
// input patch gathered straight from NHWC with the 3x3 halo zero-filled
// by predicated loads (the TPU kernel materialises `jnp.pad` instead).
// The epilogue folds gamma/beta/mean/var for its four channels in
// registers, so BN costs no extra launch and the conv output makes one
// trip to device memory.  When C % 16 == 0, Cout % 4 == 0 and every base
// is 16-byte aligned (every ResNet stage), a chunk lies inside one tap and
// all loads and stores are 16 bytes; otherwise every element is gathered
// and predicated on its own (ragged C, Cout and pixel counts).

#include <cuda_runtime.h>

#include "conv3x3_tile.cuh"

namespace {

using namespace mxt_conv;

struct Args {
  ConvGeom g;            // x (N, H, W, C), w (3, 3, C, Cout) == (9C, Cout)
  const float* gamma;    // (Cout,) each
  const float* beta;
  const float* mean;
  const float* var;
  const float* res;      // (N, H, W, Cout) or null
  float* out;            // (N, H, W, Cout)
  float eps;
  int relu;
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_affine_kernel(const Args a) {
  __shared__ __align__(16) TileSmem smem;
  const int tid = threadIdx.x;
  const int tx = tid & 15;          // output channels tx*4 .. +3
  const int ty = tid >> 4;          // output pixels ty*4 .. +3
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[4][4];
  ConvFwdLoader<VEC> ld(a.g, m0, n0);
  gemm_tile(ld, (a.g.K + BK - 1) / BK, smem, acc);

  // epilogue: fold BN for this thread's four channels, then
  // scale/shift (+ residual) (+ ReLU), stored NHWC
  const int Cout = a.g.Cout;
  float sc[4], sh[4];
  const int nb = n0 + tx * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = nb + j;
    if (n < Cout) {
      sc[j] = a.gamma[n] * rsqrtf(a.var[n] + a.eps);
      sh[j] = a.beta[n] - a.mean[n] * sc[j];
    } else {
      sc[j] = sh[j] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= a.g.M) continue;
    const long long row = m * Cout;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = acc[i][j] * sc[j] + sh[j];
    if constexpr (VEC) {
      if (nb < Cout) {
        if (a.res) {
          const float4 r = *reinterpret_cast<const float4*>(a.res + row + nb);
          v[0] += r.x; v[1] += r.y; v[2] += r.z; v[3] += r.w;
        }
        if (a.relu) {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = v[j] > 0.f ? v[j] : 0.f;
        }
        *reinterpret_cast<float4*>(a.out + row + nb) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nb + j;
        if (n >= Cout) continue;
        float o = v[j];
        if (a.res) o += a.res[row + n];
        if (a.relu) o = o > 0.f ? o : 0.f;
        a.out[row + n] = o;
      }
    }
  }
}

}  // namespace

// x (N, H, W, C), w (3, 3, C, Cout), out and res (N, H, W, Cout), all
// contiguous fp32; gamma/beta/mean/var (Cout,); res may be null.
// vec != 0 asks for 16-byte accesses: the host checked C % 16 == 0,
// Cout % 4 == 0 and 16-byte aligned bases.
extern "C" int mxt_conv_affine_f32(const void* x, const void* w,
                                   const void* gamma, const void* beta,
                                   const void* mean, const void* var,
                                   const void* res, void* out, int N, int H,
                                   int W, int C, int Cout, float eps,
                                   int relu, int vec, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.g.x = static_cast<const float*>(x);
  a.g.w = static_cast<const float*>(w);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.mean = static_cast<const float*>(mean);
  a.var = static_cast<const float*>(var);
  a.res = static_cast<const float*>(res);
  a.out = static_cast<float*>(out);
  a.g.M = (long long)N * H * W;
  a.g.H = H; a.g.W = W; a.g.C = C; a.g.Cout = Cout; a.g.K = 9 * C;
  a.eps = eps;
  a.relu = relu;
  const long long mb = (a.g.M + BM - 1) / BM;
  if (mb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)mb, (unsigned)((Cout + BN - 1) / BN));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    conv_affine_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else
    conv_affine_kernel<false><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
