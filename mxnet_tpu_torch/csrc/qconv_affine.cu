// int8 3x3/s1/p1 convolution with an int32 accumulator and a fused
// dequantization epilogue, NHWC x (Cout, 9C), f32 out:
//
//   acc[n,h,w,co] = sum_{dh,dw,ci} qx[n,h+dh-1,w+dw-1,ci] * qw[dh,dw,ci,co]
//   out[n,h,w,co] = act( f32(acc) * scale[co] + shift[co] (+ res[n,h,w,co]) )
//
// Replaces: mxnet_tpu/ops/pallas_int8.py `_qconv_affine_kernel` (:197,
// launched by `qconv3x3_affine` :217, oracle `qconv3x3_xla` :246), reached
// through mxnet_tpu/ops/nn.py `quantized_conv` from the QuantizedConv2D
// twins of quantization.py: the 3x3 mid conv of every ResNet-50 v1
// bottleneck after `quantize_net` (16 a forward), whose `scale` is the
// dequantization 1/(s_in * w_scale[co]) and whose `shift` is the folded
// BatchNorm.
//
// Bound on an H100: bytes.  A segment reads N*H*W*C int8 activations and
// 9*C*Cout int8 weights and writes N*H*W*Cout f32 outputs (plus an f32
// residual read); it does 2 * N*H*W * 9*C * Cout int8 operations.  At
// batch 8 on the 56x56x64 stage that is ~8.1 MB, 2.4 us at 3.35 TB/s,
// against 1.85 G operations, 0.9 us at the 1,979 TOPS int8 tensor-core
// peak: the f32 output write sets the floor at every ResNet-50 stage.
//
// Design, for Hopper rather than after the TPU's row blocks: an implicit
// GEMM on the int8 tensor cores with `mma.sync.m16n8k32.s32.s8.s8.s32`.
// M = N*H*W output pixels, N = Cout, K = 9*C in tap-major order (the HWIO
// weight read as the (9C, Cout) matrix the TPU kernel multiplies).  The
// weight comes packed once, at QuantizedConv2D construction, as the
// (Cout, 9C) matrix, so B's fragments (K-contiguous per output channel)
// load straight from it.  A block of 128 threads (four warps, 2 x 2, each
// 32 x 32) owns a 64-pixel x 64-channel output tile and walks K in
// 64-byte chunks through a three-stage ring in shared memory filled by
// 16-byte `cp.async` copies; the 3x3 halo is a predicated copy with a
// source size of 0 (zero fill), which is exact because the quantization
// is symmetric with zero-point 0 (the TPU kernel pads a copy instead).
// Rows of the ring are 80 bytes apart, so the fragment reads of a warp
// hit 32 distinct banks.  The epilogue converts each int32 sum to f32 and
// applies scale, shift, residual and ReLU in registers with __fmul_rn /
// __fadd_rn (no contraction into an FMA), so the result equals its plain
// version, `acc.float() * scale + shift (+ res)`, bit for bit, and the
// output makes one trip to device memory.  The 16-byte path needs
// C % 16 == 0 (a 16-byte piece of K lies inside one tap) and 16-byte
// aligned bases, which every ResNet stage has; any other C (3, 20, ...)
// takes the same tile with its bytes gathered one by one.  The TPU's
// VMEM gate and per-stage table have no counterpart: every shape runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output pixels a block
constexpr int BN = 64;          // output channels a block
constexpr int BK = 64;          // K bytes a stage: two mma k-steps
constexpr int LDS = BK + 16;    // ring row stride in bytes
constexpr int STAGES = 3;
constexpr int kThreads = 128;

struct Args {
  const int8_t* x;       // (N, H, W, C)
  const int8_t* wt;      // (Cout, 9C): the HWIO weight, transposed
  const float* scale;    // (Cout,)
  const float* shift;    // (Cout,)
  const float* res;      // (N, H, W, Cout) or null
  float* out;            // (N, H, W, Cout)
  long long M;           // N*H*W
  int H, W, C, Cout, K;  // K = 9*C
  int relu;
};

struct __align__(16) Ring {
  int8_t a[STAGES][BM][LDS];   // pixel rows, K contiguous
  int8_t b[STAGES][BN][LDS];   // channel rows, K contiguous
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One thread's share of filling a ring stage: two 16-byte pieces of A
// (rows r0 and r0 + 32, piece q) and two of B (channel rows r0, r0 + 32).
template <bool VEC>
struct Loader {
  const Args& a;
  int q;                 // piece of the 64-byte row: bytes q*16 .. +15
  int r0;                // first of this thread's two rows
  const int8_t* pix[2];  // its pixels' rows of x
  int ph[2], pw[2];
  bool valid[2];
  int n0;

  __device__ __forceinline__ Loader(const Args& args, long long m0, int n0_)
      : a(args), n0(n0_) {
    q = threadIdx.x & 3;
    r0 = threadIdx.x >> 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long m = m0 + r0 + 32 * i;
      valid[i] = m < a.M;
      pw[i] = valid[i] ? (int)(m % a.W) : 0;
      ph[i] = valid[i] ? (int)((m / a.W) % a.H) : 0;
      pix[i] = a.x + (valid[i] ? m : 0) * a.C;
    }
  }

  __device__ __forceinline__ void load(Ring& s, int stage, int kt) const {
    const int k = kt * BK + q * 16;
    if constexpr (VEC) {
      const bool kin = k < a.K;
      const int tap = kin ? k / a.C : 0;
      const int c = k - tap * a.C;
      const int dh = tap / 3 - 1, dw = tap % 3 - 1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ih = ph[i] + dh, iw = pw[i] + dw;
        const bool ok = kin && valid[i] && ih >= 0 && ih < a.H && iw >= 0 &&
                        iw < a.W;
        const int8_t* src =
            ok ? pix[i] + ((long long)dh * a.W + dw) * a.C + c : a.x;
        cp_async16(&s.a[stage][r0 + 32 * i][q * 16], src, ok);
        const int n = n0 + r0 + 32 * i;
        const bool okb = kin && n < a.Cout;
        cp_async16(&s.b[stage][r0 + 32 * i][q * 16],
                   okb ? a.wt + (long long)n * a.K + k : a.wt, okb);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t va[4] = {0u, 0u, 0u, 0u}, vb[4] = {0u, 0u, 0u, 0u};
        const int n = n0 + r0 + 32 * i;
        for (int e = 0; e < 16; ++e) {
          const int kk = k + e;
          if (kk >= a.K) break;
          const int tap = kk / a.C;
          const int c = kk - tap * a.C;
          const int dh = tap / 3 - 1, dw = tap % 3 - 1;
          const int ih = ph[i] + dh, iw = pw[i] + dw;
          if (valid[i] && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W) {
            const uint32_t v = (uint8_t)pix[i][((long long)dh * a.W + dw) *
                                                   a.C + c];
            va[e >> 2] |= v << (8 * (e & 3));
          }
          if (n < a.Cout) {
            const uint32_t v = (uint8_t)a.wt[(long long)n * a.K + kk];
            vb[e >> 2] |= v << (8 * (e & 3));
          }
        }
        *reinterpret_cast<uint4*>(&s.a[stage][r0 + 32 * i][q * 16]) =
            make_uint4(va[0], va[1], va[2], va[3]);
        *reinterpret_cast<uint4*>(&s.b[stage][r0 + 32 * i][q * 16]) =
            make_uint4(vb[0], vb[1], vb[2], vb[3]);
      }
    }
  }
};

__device__ __forceinline__ float epilogue(int acc, float sc, float sh,
                                          const float* res, long long at,
                                          int relu) {
  float y = __fadd_rn(__fmul_rn((float)acc, sc), sh);
  if (res) y = __fadd_rn(y, res[at]);
  return relu ? (y > 0.f ? y : 0.f) : y;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
qconv_affine_kernel(const Args a) {
  __shared__ Ring ring;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;   // 32-row, 32-column quarter
  const int g = lane >> 2, t = lane & 3;     // mma fragment coordinates
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nk = (a.K + BK - 1) / BK;

  Loader<VEC> ld(a, m0, n0);
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) ld.load(ring, st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage refilled here was read in iteration kt - 1, which every
    // thread finished before the barrier above
    const int pre = kt + STAGES - 1;
    if (pre < nk) ld.load(ring, pre % STAGES, pre);
    cp_async_commit();
    const int s = kt % STAGES;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int kb = ks * 32 + t * 4;
      uint32_t fa[2][4], fb[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        fa[mi][0] = ld32(&ring.a[s][r][kb]);
        fa[mi][1] = ld32(&ring.a[s][r + 8][kb]);
        fa[mi][2] = ld32(&ring.a[s][r][kb + 16]);
        fa[mi][3] = ld32(&ring.a[s][r + 8][kb + 16]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cn = wn * 32 + ni * 8 + g;
        fb[ni][0] = ld32(&ring.b[s][cn][kb]);
        fb[ni][1] = ld32(&ring.b[s][cn][kb + 16]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], fa[mi], fb[ni]);
    }
  }
  cp_async_wait<0>();

  // epilogue: thread (g, t) holds rows g and g + 8, columns 2t and 2t + 1
  // of each 16 x 8 fragment
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + t * 2;
    if (col >= a.Cout) continue;
    const bool two = col + 1 < a.Cout;
    const float sc0 = a.scale[col], sh0 = a.shift[col];
    const float sc1 = two ? a.scale[col + 1] : 0.f;
    const float sh1 = two ? a.shift[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * 32 + mi * 16 + g + h * 8;
        if (m >= a.M) continue;
        const long long at = m * a.Cout + col;
        const float y0 =
            epilogue(acc[mi][ni][2 * h], sc0, sh0, a.res, at, a.relu);
        if (VEC) {   // Cout even, 8-byte aligned: both columns at once
          const float y1 = epilogue(acc[mi][ni][2 * h + 1], sc1, sh1, a.res,
                                    at + 1, a.relu);
          *reinterpret_cast<float2*>(a.out + at) = make_float2(y0, y1);
        } else {
          a.out[at] = y0;
          if (two)
            a.out[at + 1] = epilogue(acc[mi][ni][2 * h + 1], sc1, sh1, a.res,
                                     at + 1, a.relu);
        }
      }
  }
}

}  // namespace

// x (N, H, W, C) int8, wt (Cout, 9C) int8, scale/shift (Cout,) f32, res
// and out (N, H, W, Cout) f32, all contiguous; res may be null.  vec != 0
// asks for 16-byte copies and paired stores: the host checked
// C % 16 == 0, Cout % 2 == 0 and 16-byte aligned bases.
extern "C" int mxt_qconv_affine_s8(const void* x, const void* wt,
                                   const void* scale, const void* shift,
                                   const void* res, void* out, int N, int H,
                                   int W, int C, int Cout, int relu, int vec,
                                   void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 ||
      9LL * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.wt = static_cast<const int8_t*>(wt);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.res = static_cast<const float*>(res);
  a.out = static_cast<float*>(out);
  a.M = (long long)N * H * W;
  a.H = H; a.W = W; a.C = C; a.Cout = Cout; a.K = 9 * C;
  a.relu = relu;
  const long long mb = (a.M + BM - 1) / BM;
  if (mb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)mb, (unsigned)((Cout + BN - 1) / BN));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    qconv_affine_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else
    qconv_affine_kernel<false><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
