// The weight gradient of the 3x3/s1/p1 convolution, fp32 in and out, on
// Hopper's tensor cores in 3xTF32:
//
//   dW[tap*C + c][co] = sum over pixels m of x[m + tap offset][c] * dy[m][co]
//
// x (N, H, W, C) and dy (N, H, W, Cout) NHWC, dW (3, 3, C, Cout) HWIO read
// as the row-major (9C, Cout) matrix patches^T . dy, the halo zero.
//
// Replaces: mxnet_tpu/ops/pallas_block.py `_wgrad_kernel` (:381, launched
// by `conv3x3_wgrad` :444), the dW of the backward of
// `residual_block_fused`: 16 launches a ResNet-50 v1 training step.
//
// Bounds on an H100, at batch 64 of any ResNet-50 stage: 2 * N*H*W * 9C *
// Cout = 14.8 GFLOP, 0.2209 ms at the 67 TFLOP/s fp32 CUDA-core peak.  This
// kernel does three TF32 products for each fp32 one: 44.4 GFLOP, 0.0897 ms
// at the 495 TFLOP/s dense TF32 tensor-core peak.  Bytes (x and dy read
// once, dW written once): 103 MB at 56x56x64 (0.031 ms at 3.35 TB/s), 22 MB
// at 7x7x512 (0.007 ms).  Operations bound it at every stage.
//
// Design.
// - 3xTF32 (CUTLASS's "fast fp32", the helpers of tf32x3.cuh): every
//   fp32 operand v is split on its way from shared memory into registers
//   into TF32 hi and lo (v's top 11 significant bits by a mask, and the
//   rest), and each product is lo*hi' + hi*lo' + hi*hi', small terms
//   first, by `mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32`.  The dropped
//   lo*lo' and the truncation of lo leave an error of fp32's order (one
//   TF32 product alone errs by ~2^-11).  The tensor core truncates its
//   own fp32 sums, so a chunk's products gather in a run accumulator from
//   zero, added to the block's sums with IEEE adds (see mma_chunk).
// - Tiles: a block of 8 warps owns 128 patch columns (k) x BN output
//   channels (BN 64 for Cout <= 64, else 128); a warp owns 32 x BN/2 as
//   2 x BN/16 fragments, in two sets (sums and run) of registers: 210-232
//   registers a thread at BN 128, one block an SM; two at BN 64.  The
//   next step's fragments are read while this step's products run.
// - Data: the reduction runs over pixels in chunks of 32 through a
//   three-stage ring in shared memory filled by 16-byte `cp.async` copies
//   (4-byte ones when C or Cout is not a multiple of 4); halo taps and pixels past the range are zero-filled with a source
//   size of 0.  Both ring tiles are pixel-major, as NHWC gives them, with
//   rows 8 banks apart, so the fragment reads of a warp hit 32 banks.
// - Index math: a thread copies one fixed 4-wide k (or co) piece of
//   BK / 8 pixel rows, so its tap offset is computed once a segment; the rows'
//   (h, w) start from one division a segment and step by 32 pixels with
//   a precomputed (32 / W, 32 % W) and a carry: no division in the loop.
// - Split-K in whole waves (stream-K): the tiles x chunks of work are cut
//   into exactly `ranges` = 132 x (blocks an SM, from the occupancy API)
//   ranges of whole chunks, one a block, so the grid is one full wave.  A
//   range that crosses a tile boundary is two segments.  Each segment
//   writes its partial tile to its own slot; wgrad_reduce_kernel then sums
//   a tile's slots in a fixed order (no float atomics), so dW is bitwise
//   the same from run to run.  Whole waves of uniform per-tile splits
//   would need 11 splits at 7x7 (104 MB of partials); the ranges write
//   about (ranges + tiles) partial tiles, 9-18 MB at batch 64.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

extern __shared__ __align__(16) unsigned char mxt_wgrad_smem[];

namespace {

using namespace mxt_tf32;

constexpr int BM = 128;        // patch columns (k = tap*C + c) a tile
constexpr int BK = 32;         // pixels a chunk
constexpr int STAGES = 3;
constexpr int kThreads = 256;  // 8 warps: 4 along k x 2 along co
constexpr int LDA = BM + 8;    // ring row strides in floats

template <int BN>
struct Ring {
  float a[STAGES][BK][LDA];      // x patches: pixel rows, k contiguous
  float b[STAGES][BK][BN + 8];   // dy: pixel rows, channels contiguous
};

struct Args {
  const float* x;       // (N, H, W, C)
  const float* dy;      // (N, H, W, Cout)
  float* part;          // (tiles, jmax, BM, BN) partial tiles
  long long M;          // N*H*W
  long long nch;        // chunks a tile: ceil(M / BK)
  long long total;      // tiles * nch units of work
  int H, W, C, Cout, K; // K = 9*C
  int tiles_n;          // tiles along Cout
  int ranges;           // blocks: the work is cut into this many ranges
  int jmax;             // partial slots a tile
  int qw, rw;           // BK / W and BK % W: one chunk's step in (h, w)
};

// The range of block b is units [b*total/ranges, (b+1)*total/ranges);
// unit u lies in range ((u+1)*ranges - 1) / total.
__device__ __forceinline__ long long range_of(const Args& a, long long u) {
  return ((u + 1) * a.ranges - 1) / a.total;
}

// One thread's share of filling a ring stage with one chunk: piece q
// (k0 + 4q .. +3 of x's patch row, n0 + 4q .. +3 of dy's row) of pixel
// rows r0 + 8i, i < ROWS.  VEC: C % 4 == 0 and Cout % 4 == 0 (a piece lies
// in one tap and is wholly in or out), 16-byte aligned bases: one 16-byte
// copy a piece; otherwise four 4-byte copies, each with its own tap.
template <int BN, bool VEC>
struct Loader {
  static constexpr int NE = VEC ? 1 : 4;   // taps held a piece
  static constexpr int ROWS = BK / 8;      // pixel rows a thread copies
  const Args& a;
  long long m;          // first pixel of the next chunk to copy
  long long mend;       // end of the segment's pixels
  int q, r0;
  int nq;               // dy column of the piece
  bool b_on;            // this thread copies a dy piece
  int h[ROWS], w[ROWS]; // (h, w) of pixel m + r0 + 8i
  int dh[NE], dw[NE];
  long long off[NE];    // x offset of the tap and channel from the pixel's
  bool kin[NE];

  __device__ __forceinline__ Loader(const Args& args, int k0, int n0,
                                    long long mbeg, long long mlim)
      : a(args), m(mbeg), mend(mlim) {
    q = threadIdx.x & 31;
    r0 = threadIdx.x >> 5;
    nq = n0 + 4 * q;
    b_on = 4 * q < BN;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int k = k0 + 4 * q + e;
      kin[e] = k < a.K;
      const int tap = kin[e] ? k / a.C : 0;
      const int c = k - tap * a.C;
      dh[e] = tap / 3 - 1;
      dw[e] = tap % 3 - 1;
      off[e] = ((long long)dh[e] * a.W + dw[e]) * a.C + c;
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const long long p = mbeg + r0 + 8 * i;
      w[i] = (int)(p % a.W);
      h[i] = (int)((p / a.W) % a.H);
    }
  }

  // copy the next chunk into stage st and step to the one after
  __device__ __forceinline__ void load(Ring<BN>& s, int st) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = r0 + 8 * i;
      const long long p = m + row;
      const bool pin = p < mend;
      float* da = &s.a[st][row][4 * q];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int ih = h[i] + dh[e], iw = w[i] + dw[e];
        const bool ok = pin && kin[e] && (unsigned)ih < (unsigned)a.H &&
                        (unsigned)iw < (unsigned)a.W;
        const float* src = ok ? a.x + p * a.C + off[e] : a.x;
        if constexpr (VEC)
          cp_async16(da, src, ok);
        else
          cp_async4(da + e, src, ok);
      }
      if (b_on) {
        float* db = &s.b[st][row][4 * q];
        if constexpr (VEC) {
          const bool ok = pin && nq < a.Cout;
          cp_async16(db, ok ? a.dy + p * a.Cout + nq : a.dy, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = pin && nq + e < a.Cout;
            cp_async4(db + e, ok ? a.dy + p * a.Cout + nq + e : a.dy, ok);
          }
        }
      }
    }
    m += BK;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      w[i] += a.rw;
      h[i] += a.qw;
      if (w[i] >= a.W) {
        w[i] -= a.W;
        ++h[i];
      }
      while (h[i] >= a.H) h[i] -= a.H;
    }
  }
};

// A warp's fp32 fragments of one 8-pixel step: a[mi] the 16 x 8 A
// fragment of rows wk*32 + mi*16 .., b[ni] the 8 x 8 B fragment of
// columns wn*BN/2 + ni*8 ..
template <int BN>
struct Frags {
  float a[2][4];
  float b[BN / 16][2];
};

template <int BN>
__device__ __forceinline__ void load_frags(const Ring<BN>& s, int st, int ks,
                                           int wk, int wn, int g, int t,
                                           Frags<BN>& f) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = wk * 32 + mi * 16 + g;
    f.a[mi][0] = s.a[st][ks + t][r];
    f.a[mi][1] = s.a[st][ks + t][r + 8];
    f.a[mi][2] = s.a[st][ks + t + 4][r];
    f.a[mi][3] = s.a[st][ks + t + 4][r + 8];
  }
#pragma unroll
  for (int ni = 0; ni < BN / 16; ++ni) {
    const int cn = wn * (BN / 2) + ni * 8 + g;
    f.b[ni][0] = s.b[st][ks + t][cn];
    f.b[ni][1] = s.b[st][ks + t + 4][cn];
  }
}

// acc += this warp's 32 x BN/2 share of the chunk in stage st.  The
// chunk's four steps accumulate into run, from zero, and run is added to
// acc with IEEE adds: the tensor core truncates its fp32 sums, which on
// one accumulator over a whole range (~1,400 products at 56x56) drifts
// to ~3e-5 of dW; twelve products a chain keep dW at fp32's accuracy.
// The next step's fragments are read from shared memory while this
// step's products run.
template <int BN>
__device__ __forceinline__ void mma_chunk(const Ring<BN>& s, int st,
                                          int wk, int wn, int g, int t,
                                          float (&acc)[2][BN / 16][4]) {
  float run[2][BN / 16][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[mi][ni][e] = 0.f;
  Frags<BN> f[2];
  load_frags<BN>(s, st, 0, wk, wn, g, t, f[0]);
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    if (ks + 1 < BK / 8)
      load_frags<BN>(s, st, (ks + 1) * 8, wk, wn, g, t, f[(ks + 1) & 1]);
    mma_step(f[ks & 1].a, f[ks & 1].b, run);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], run[mi][ni][e]);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_wgrad_kernel(const Args a) {
  Ring<BN>& s = *reinterpret_cast<Ring<BN>*>(mxt_wgrad_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wk = warp >> 1, wn = warp & 1;   // 32-row, BN/2-column share
  const int g = lane >> 2, t = lane & 3;     // mma fragment coordinates
  const long long b = blockIdx.x;
  const long long u1 = (b + 1) * a.total / a.ranges;

  for (long long u = b * a.total / a.ranges; u < u1;) {
    const long long tile = u / a.nch;
    const long long c0 = u - tile * a.nch;
    const long long send =
        u1 < (tile + 1) * a.nch ? u1 : (tile + 1) * a.nch;
    const int nk = (int)(send - u);
    const int k0 = (int)(tile / a.tiles_n) * BM;
    const int n0 = (int)(tile % a.tiles_n) * BN;
    const long long mlim = (c0 + nk) * BK < a.M ? (c0 + nk) * BK : a.M;
    const bool active = k0 + wk * 32 < a.K;   // warp-uniform

    float acc[2][BN / 16][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    Loader<BN, VEC> ld(a, k0, n0, c0 * BK, mlim);
    __syncthreads();   // every warp is done with the ring's last segment
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk) ld.load(s, st);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      // the stage refilled here was read in iteration kt - 1, which every
      // thread finished before the barrier above
      const int pre = kt + STAGES - 1;
      if (pre < nk) ld.load(s, pre % STAGES);
      cp_async_commit();
      if (active) mma_chunk<BN>(s, kt % STAGES, wk, wn, g, t, acc);
    }
    cp_async_wait<0>();

    // this segment's slot of the tile: the ranges before it that touch
    // the tile hold the slots below
    const long long j = b - range_of(a, tile * a.nch);
    float* p = a.part + (tile * a.jmax + j) * (long long)(BM * BN);
    if (active) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < BN / 16; ++ni) {
          const int r = wk * 32 + mi * 16 + g;
          const int c = wn * (BN / 2) + ni * 8 + 2 * t;
          if (k0 + r < a.K)
            *reinterpret_cast<float2*>(p + r * BN + c) =
                make_float2(acc[mi][ni][0], acc[mi][ni][1]);
          if (k0 + r + 8 < a.K)
            *reinterpret_cast<float2*>(p + (r + 8) * BN + c) =
                make_float2(acc[mi][ni][2], acc[mi][ni][3]);
        }
    }
    u = send;
  }
}

// dW of tile blockIdx.y: its slots summed in slot order, 4 values a
// thread.  VEC: Cout % 4 == 0 and dw 16-byte aligned.
template <int BN, bool VEC>
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const Args a, float* __restrict__ dw) {
  const long long tile = blockIdx.y;
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= BM * BN) return;
  const int k = (int)(tile / a.tiles_n) * BM + e / BN;
  const int n = (int)(tile % a.tiles_n) * BN + e % BN;
  if (k >= a.K || n >= a.Cout) return;
  const long long first = range_of(a, tile * a.nch);
  const int segs = (int)(range_of(a, (tile + 1) * a.nch - 1) - first + 1);
  const float* p = a.part + tile * a.jmax * (long long)(BM * BN) + e;
  float4 sum = *reinterpret_cast<const float4*>(p);
  for (int j = 1; j < segs; ++j) {
    const float4 v =
        *reinterpret_cast<const float4*>(p + j * (long long)(BM * BN));
    sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
  }
  float* o = dw + (long long)k * a.Cout + n;
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(o) = sum;
  } else {
    const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n + i < a.Cout) o[i] = sv[i];
  }
}

template <int BN, bool VEC>
cudaError_t prepare(int* per_sm) {
  const int bytes = (int)sizeof(Ring<BN>);
  cudaError_t err = cudaFuncSetAttribute(
      conv_wgrad_kernel<BN, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess || !per_sm) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, conv_wgrad_kernel<BN, VEC>, kThreads, bytes);
}

cudaError_t prepare_any(int bn, int vec, int* per_sm) {
  if (bn == 64) return vec ? prepare<64, true>(per_sm)
                           : prepare<64, false>(per_sm);
  return vec ? prepare<128, true>(per_sm) : prepare<128, false>(per_sm);
}

template <int BN, bool VEC>
void launch(const Args& a, float* dw, cudaStream_t s) {
  conv_wgrad_kernel<BN, VEC>
      <<<(unsigned)a.ranges, kThreads, sizeof(Ring<BN>), s>>>(a);
  const dim3 grid(BM * BN / 4 / 256, (unsigned)(a.total / a.nch));
  wgrad_reduce_kernel<BN, VEC><<<grid, 256, 0, s>>>(a, dw);
}

}  // namespace

// Blocks of conv_wgrad_kernel<bn, vec> that fit an SM of the current
// device, into *out (the host cuts the work into 132 x this many ranges).
extern "C" int mxt_conv_wgrad_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any(bn, vec, out);
}

// x (N, H, W, C), dy (N, H, W, Cout), dw (3, 3, C, Cout) == (9C, Cout),
// all contiguous fp32; part (tiles, jmax, 128, bn) fp32 scratch, tiles =
// ceil(9C / 128) * ceil(Cout / bn).  The tiles x ceil(N*H*W / 32) units of
// work are cut into `ranges` ranges, one a block; jmax must be at least the
// most ranges that touch one tile.  The plan (bn, ranges, jmax) is the
// caller's: mxnet_tpu_torch/ops/conv_block.py wgrad_splits.  vec != 0:
// C % 4 == 0, Cout % 4 == 0 and 16-byte aligned x, dy, dw.
extern "C" int mxt_conv_wgrad_f32(const void* x, const void* dy, void* part,
                                  void* dw, int N, int H, int W, int C,
                                  int Cout, int bn, int ranges, int jmax,
                                  int vec, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || ranges <= 0 ||
      jmax <= 0 || (bn != 64 && bn != 128) || 9LL * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.dy = static_cast<const float*>(dy);
  a.part = static_cast<float*>(part);
  a.M = (long long)N * H * W;
  a.H = H; a.W = W; a.C = C; a.Cout = Cout; a.K = 9 * C;
  a.tiles_n = (Cout + bn - 1) / bn;
  const long long tiles = (long long)((a.K + BM - 1) / BM) * a.tiles_n;
  a.nch = (a.M + BK - 1) / BK;
  a.total = tiles * a.nch;
  a.ranges = ranges;
  a.jmax = jmax;
  a.qw = BK / W;
  a.rw = BK % W;
  if (tiles > 65535 || ranges > a.total) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_any(bn, vec, nullptr);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(dw);
  if (bn == 64) {
    if (vec) launch<64, true>(a, o, s); else launch<64, false>(a, o, s);
  } else {
    if (vec) launch<128, true>(a, o, s); else launch<128, false>(a, o, s);
  }
  return (int)cudaGetLastError();
}
