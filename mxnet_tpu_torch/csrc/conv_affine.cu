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
// (9C, Cout) matrix the TPU kernel multiplies (`_patches`).  A block of
// 256 threads owns a 64-pixel x 64-channel output tile and streams K in
// chunks of 16 through double-buffered shared memory: the input patch
// columns are gathered straight from NHWC, the 3x3 halo zero-filled by
// predicated loads (the TPU kernel materialises `jnp.pad` instead), and
// the next chunk is fetched into registers while the current one is
// multiplied.  Each thread keeps a 4x4 sub-tile of sums in registers.
// The epilogue folds gamma/beta/mean/var for its four channels in
// registers, so BN costs no extra launch and the conv output makes one
// trip to device memory.  When C % 16 == 0, Cout % 4 == 0 and every base
// is 16-byte aligned (every ResNet stage), a chunk lies inside one tap and
// all loads and stores are 16 bytes; otherwise every element is gathered
// and predicated on its own (ragged C, Cout and pixel counts).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // reduction chunk (taps x input channels)
constexpr int APAD = 4;       // pad of the pixel rows of the A tile
constexpr int kThreads = 256;

struct Args {
  const float* x;        // (N, H, W, C)
  const float* w;        // (3, 3, C, Cout) == (9C, Cout)
  const float* gamma;    // (Cout,) each
  const float* beta;
  const float* mean;
  const float* var;
  const float* res;      // (N, H, W, Cout) or null
  float* out;            // (N, H, W, Cout)
  long long M;           // N*H*W
  int H, W, C, Cout, K;  // K = 9*C
  float eps;
  int relu;
};

// The four input values of (pixel, k0 + q*4 .. +3) for this thread.
template <bool VEC>
__device__ __forceinline__ void load_a(const Args& a, const float* pix,
                                       bool valid, int ph, int pw, int k0,
                                       int q, float* r) {
  if constexpr (VEC) {
    // C % 16 == 0: the chunk lies inside one tap, channels contiguous
    const int tap = k0 / a.C;
    const int c = k0 - tap * a.C + q * 4;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    const int ih = ph + dh, iw = pw + dw;
    if (valid && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W) {
      const float4 v = *reinterpret_cast<const float4*>(
          pix + ((long long)dh * a.W + dw) * a.C + c);
      r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
    } else {
      r[0] = r[1] = r[2] = r[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + q * 4 + e;
      float v = 0.f;
      if (valid && k < a.K) {
        const int tap = k / a.C;
        const int c = k - tap * a.C;
        const int dh = tap / 3 - 1, dw = tap % 3 - 1;
        const int ih = ph + dh, iw = pw + dw;
        if (ih >= 0 && ih < a.H && iw >= 0 && iw < a.W)
          v = pix[((long long)dh * a.W + dw) * a.C + c];
      }
      r[e] = v;
    }
  }
}

// Weight row k0 + row, columns n0 + col .. +3.
template <bool VEC>
__device__ __forceinline__ void load_b(const Args& a, int k0, int row,
                                       int n, float* r) {
  const int k = k0 + row;
  if constexpr (VEC) {
    // K % 16 == 0 and Cout % 4 == 0: the four columns are all in or out
    if (n < a.Cout) {
      const float4 v = *reinterpret_cast<const float4*>(
          a.w + (long long)k * a.Cout + n);
      r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
    } else {
      r[0] = r[1] = r[2] = r[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e] = (k < a.K && n + e < a.Cout) ? a.w[(long long)k * a.Cout + n + e]
                                         : 0.f;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_affine_kernel(const Args a) {
  __shared__ __align__(16) float As[2][BK][BM + APAD];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;          // output channels tx*4 .. +3
  const int ty = tid >> 4;          // output pixels ty*4 .. +3
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loads: pixel tid/4 of the tile, k sub-quad tid%4 of the chunk.
  // The pixel's coordinates are fixed for the whole K loop.
  const int a_q = tid & 3;
  const long long am = m0 + (tid >> 2);
  const bool a_valid = am < a.M;
  int ph = 0, pw = 0;
  const float* pix = a.x;
  if (a_valid) {
    pw = (int)(am % a.W);
    ph = (int)((am / a.W) % a.H);
    pix = a.x + am * a.C;           // NHWC: pixel index * C
  }
  // B loads: chunk row tid/16, columns (tid%16)*4 .. +3
  const int b_row = tid >> 4;
  const int b_col = (tid & 15) * 4;

  float ra[4], rb[4];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = (a.K + BK - 1) / BK;
  load_a<VEC>(a, pix, a_valid, ph, pw, 0, a_q, ra);
  load_b<VEC>(a, 0, b_row, n0 + b_col, rb);
#pragma unroll
  for (int e = 0; e < 4; ++e) As[0][a_q * 4 + e][tid >> 2] = ra[e];
  *reinterpret_cast<float4*>(&Bs[0][b_row][b_col]) =
      make_float4(rb[0], rb[1], rb[2], rb[3]);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {   // next chunk into registers while this one multiplies
      load_a<VEC>(a, pix, a_valid, ph, pw, (kt + 1) * BK, a_q, ra);
      load_b<VEC>(a, (kt + 1) * BK, b_row, n0 + b_col, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    if (more) {   // the other buffer was last read before the last sync
#pragma unroll
      for (int e = 0; e < 4; ++e) As[cur ^ 1][a_q * 4 + e][tid >> 2] = ra[e];
      *reinterpret_cast<float4*>(&Bs[cur ^ 1][b_row][b_col]) =
          make_float4(rb[0], rb[1], rb[2], rb[3]);
    }
    __syncthreads();
  }

  // epilogue: fold BN for this thread's four channels, then
  // scale/shift (+ residual) (+ ReLU), stored NHWC
  float sc[4], sh[4];
  const int nb = n0 + tx * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = nb + j;
    if (n < a.Cout) {
      sc[j] = a.gamma[n] * rsqrtf(a.var[n] + a.eps);
      sh[j] = a.beta[n] - a.mean[n] * sc[j];
    } else {
      sc[j] = sh[j] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= a.M) continue;
    const long long row = m * a.Cout;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = acc[i][j] * sc[j] + sh[j];
    if constexpr (VEC) {
      if (nb < a.Cout) {
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
        if (n >= a.Cout) continue;
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
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.mean = static_cast<const float*>(mean);
  a.var = static_cast<const float*>(var);
  a.res = static_cast<const float*>(res);
  a.out = static_cast<float*>(out);
  a.M = (long long)N * H * W;
  a.H = H; a.W = W; a.C = C; a.Cout = Cout; a.K = 9 * C;
  a.eps = eps;
  a.relu = relu;
  const long long mb = (a.M + BM - 1) / BM;
  if (mb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)mb, (unsigned)((Cout + BN - 1) / BN));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    conv_affine_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else
    conv_affine_kernel<false><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
