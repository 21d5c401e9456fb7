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

//
// The bf16 instance (the bf16 training slice; `_wgrad_kernel` takes bf16
// x and dy and accumulates dW in f32, which `_conv_bwd` then casts to the
// weight's dtype): x and dy bf16, dW fp32, the same ranges, slots and
// fixed-order reduce.  A 16-byte copy moves 8 halves (C % 8 == 0 and
// Cout % 8 == 0 for the vector path; otherwise each element on its own,
// a plain 2-byte load and store, as cp.async has no 2-byte copy), and
// each 16-pixel step of a chunk is one
// `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32` product, exact in fp32.
// That product wants two consecutive pixels (its k) in one register for
// A = patches^T and for B = dy alike, while both ring tiles are
// pixel-major: `ldmatrix.trans` reads them transposed, four 8 x 8
// matrices a call (rows 272 or 144 bytes apart: 16-byte aligned, and the
// eight rows of a matrix on distinct banks).  The chains are as long as
// the fp32 instance's (N*H*W = 401,408 pixels at batch 128 and 56x56), so
// a chunk's products gather in the run accumulator and are added with
// IEEE adds as there.  Bound at (128, 56, 56, 64 -> 64): 29.6 GFLOP,
// 0.0299 ms at the 989 TFLOP/s dense bf16 peak; 103 MB, 0.0307 ms at 3.35
// TB/s: bytes bind, barely.
//
// The fp16 instance (the fp16 training slice): the bf16 instance's code
// on `__half` x and dy, each step one
// `mma.sync.m16n8k16.row.col.f32.f16.f16.f32` product on the same
// ldmatrix.trans fragments, exact in fp32; dW fp32.  The path's fp16
// shapes take conv_bf16_wgmma.cu's fp16 instance; this one the rest (C =
// 20, say).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

extern __shared__ __align__(16) unsigned char mxt_wgrad_smem[];

namespace {

using namespace mxt_tf32;

constexpr int BM = 128;        // patch columns (k = tap*C + c) a tile
constexpr int BK = 32;         // pixels a chunk
constexpr int STAGES = 3;
constexpr int kThreads = 256;  // 8 warps: 4 along k x 2 along co
constexpr int LDA = BM + 8;    // ring row strides in elements

using bf16 = __nv_bfloat16;
using f16 = __half;

// T: the storage type of x and dy, fp32, bf16 or fp16
template <int BN, typename T = float>
struct Ring {
  T a[STAGES][BK][LDA];          // x patches: pixel rows, k contiguous
  T b[STAGES][BK][BN + 8];       // dy: pixel rows, channels contiguous
};

template <typename T>
struct ArgsT {
  const T* x;           // (N, H, W, C)
  const T* dy;          // (N, H, W, Cout)
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

using Args = ArgsT<float>;

// The range of block b is units [b*total/ranges, (b+1)*total/ranges);
// unit u lies in range ((u+1)*ranges - 1) / total.
template <typename T>
__device__ __forceinline__ long long range_of(const ArgsT<T>& a,
                                              long long u) {
  return ((u + 1) * a.ranges - 1) / a.total;
}

// One thread's share of filling a ring stage with one chunk.  A piece is
// 16 bytes: PW = 4 floats or 8 halves.  Piece q (k0 + PW*q .. of x's
// patch row, n0 + PW*q .. of dy's row) of pixel rows r0 + RSTEP*i, i <
// ROWS (fp32: 32 pieces a row, rows 8 apart; bf16: 16 pieces, rows 16
// apart).  VEC: C % PW == 0 and Cout % PW == 0 (a piece lies in one tap
// and is wholly in or out), 16-byte aligned bases: one 16-byte copy a
// piece; otherwise each element on its own, with its own tap (fp32:
// 4-byte copies; bf16: a plain load and store, which the ring's barriers
// order like the copies).
template <int BN, bool VEC, typename T = float>
struct Loader {
  static constexpr int PW = 16 / (int)sizeof(T);
  static constexpr int QN = BM / PW;           // pieces along a patch row
  static constexpr int RSTEP = kThreads / QN;  // rows between a thread's
  static constexpr int NE = VEC ? 1 : PW;      // taps held a piece
  static constexpr int ROWS = BK / RSTEP;      // pixel rows a thread copies
  const ArgsT<T>& a;
  long long m;          // first pixel of the next chunk to copy
  long long mend;       // end of the segment's pixels
  int q, r0;
  int nq;               // dy column of the piece
  bool b_on;            // this thread copies a dy piece
  int h[ROWS], w[ROWS]; // (h, w) of pixel m + r0 + RSTEP*i
  int dh[NE], dw[NE];
  long long off[NE];    // x offset of the tap and channel from the pixel's
  bool kin[NE];

  __device__ __forceinline__ Loader(const ArgsT<T>& args, int k0, int n0,
                                    long long mbeg, long long mlim)
      : a(args), m(mbeg), mend(mlim) {
    q = threadIdx.x % QN;
    r0 = threadIdx.x / QN;
    nq = n0 + PW * q;
    b_on = PW * q < BN;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int k = k0 + PW * q + e;
      kin[e] = k < a.K;
      const int tap = kin[e] ? k / a.C : 0;
      const int c = k - tap * a.C;
      dh[e] = tap / 3 - 1;
      dw[e] = tap % 3 - 1;
      off[e] = ((long long)dh[e] * a.W + dw[e]) * a.C + c;
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const long long p = mbeg + r0 + RSTEP * i;
      w[i] = (int)(p % a.W);
      h[i] = (int)((p / a.W) % a.H);
    }
  }

  // one element of T, or 0, without cp.async (bf16's scalar path)
  __device__ __forceinline__ static void put(T* dst, const T* src,
                                             bool ok) {
    *reinterpret_cast<uint16_t*>(dst) =
        ok ? *reinterpret_cast<const uint16_t*>(src) : (uint16_t)0;
  }

  // one element on the scalar path
  __device__ __forceinline__ static void copy1(T* dst, const T* src,
                                               bool ok) {
    if constexpr (sizeof(T) == 4)
      cp_async4(dst, src, ok);
    else
      put(dst, src, ok);
  }

  // copy the next chunk into stage st and step to the one after
  __device__ __forceinline__ void load(Ring<BN, T>& s, int st) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = r0 + RSTEP * i;
      const long long p = m + row;
      const bool pin = p < mend;
      T* da = &s.a[st][row][PW * q];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int ih = h[i] + dh[e], iw = w[i] + dw[e];
        const bool ok = pin && kin[e] && (unsigned)ih < (unsigned)a.H &&
                        (unsigned)iw < (unsigned)a.W;
        const T* src = ok ? a.x + p * a.C + off[e] : a.x;
        if constexpr (VEC)
          cp_async16(da, src, ok);
        else
          copy1(da + e, src, ok);
      }
      if (b_on) {
        T* db = &s.b[st][row][PW * q];
        if constexpr (VEC) {
          const bool ok = pin && nq < a.Cout;
          cp_async16(db, ok ? a.dy + p * a.Cout + nq : a.dy, ok);
        } else {
#pragma unroll
          for (int e = 0; e < PW; ++e) {
            const bool ok = pin && nq + e < a.Cout;
            copy1(db + e, ok ? a.dy + p * a.Cout + nq + e : a.dy, ok);
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

// The half instances of mma_chunk (T bf16 or fp16): the chunk's two
// 16-pixel steps, each one half product a fragment pair, gathered in the
// run accumulator and added with IEEE adds.  Lane l reads row l % 8 of
// matrix l / 8 of each ldmatrix.trans: A's matrices are (pixels ks .. +
// 7, k rows r .. + 7), (ks .., r + 8 ..), (ks + 8 .., r ..), (ks + 8 ..,
// r + 8 ..), its four registers in the fragment's order; B's are (ks ..,
// channels of n-step j), (ks + 8 .., j), (ks .., j + 1), (ks + 8 .., j +
// 1): two fragments.
template <int BN, typename T>
__device__ __forceinline__ void mma_chunk(const Ring<BN, T>& s, int st,
                                          int wk, int wn, int g, int t,
                                          float (&acc)[2][BN / 16][4]) {
  float run[2][BN / 16][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[mi][ni][e] = 0.f;
  const int lane = g * 4 + t;
  const int mat = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4_trans(af[mi], &s.a[st][ks + rr + 8 * (mat >> 1)]
                                [wk * 32 + mi * 16 + 8 * (mat & 1)]);
#pragma unroll
    for (int j = 0; j < BN / 16; j += 2) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, &s.b[st][ks + rr + 8 * (mat & 1)]
                            [wn * (BN / 2) + (j + (mat >> 1)) * 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        Half<T>::mma(run[mi][j], af[mi], bf);
        Half<T>::mma(run[mi][j + 1], af[mi], bf + 2);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], run[mi][ni][e]);
}

template <int BN, bool VEC, typename T>
__device__ __forceinline__ void wgrad_ranges(const ArgsT<T>& a) {
  Ring<BN, T>& s = *reinterpret_cast<Ring<BN, T>*>(mxt_wgrad_smem);
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

    Loader<BN, VEC, T> ld(a, k0, n0, c0 * BK, mlim);
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

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_wgrad_kernel(const Args a) {
  wgrad_ranges<BN, VEC>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_wgrad_bf16_kernel(const ArgsT<bf16> a) {
  wgrad_ranges<BN, VEC>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_wgrad_f16_kernel(const ArgsT<f16> a) {
  wgrad_ranges<BN, VEC>(a);
}

template <int BN, bool VEC, typename T>
auto main_kernel() {
  if constexpr (std::is_same_v<T, float>)
    return conv_wgrad_kernel<BN, VEC>;
  else if constexpr (std::is_same_v<T, bf16>)
    return conv_wgrad_bf16_kernel<BN, VEC>;
  else
    return conv_wgrad_f16_kernel<BN, VEC>;
}

// dW of tile blockIdx.y: its slots summed in slot order, 4 values a
// thread.  VEC: Cout % 4 == 0 and dw 16-byte aligned.
template <int BN, bool VEC, typename T>
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const ArgsT<T> a, float* __restrict__ dw) {
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

template <int BN, bool VEC, typename T>
cudaError_t prepare(int* per_sm) {
  const int bytes = (int)sizeof(Ring<BN, T>);
  const auto kernel = main_kernel<BN, VEC, T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess || !per_sm) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, bytes);
}

template <typename T>
cudaError_t prepare_any(int bn, int vec, int* per_sm) {
  if (bn == 64) return vec ? prepare<64, true, T>(per_sm)
                           : prepare<64, false, T>(per_sm);
  return vec ? prepare<128, true, T>(per_sm)
             : prepare<128, false, T>(per_sm);
}

template <int BN, bool VEC, typename T>
void launch(const ArgsT<T>& a, float* dw, cudaStream_t s) {
  main_kernel<BN, VEC, T>()
      <<<(unsigned)a.ranges, kThreads, sizeof(Ring<BN, T>), s>>>(a);
  const dim3 grid(BM * BN / 4 / 256, (unsigned)(a.total / a.nch));
  wgrad_reduce_kernel<BN, VEC, T><<<grid, 256, 0, s>>>(a, dw);
}

// conv_wgrad of storage type T (x, dy); dw fp32.
template <typename T>
int wgrad_any(const void* x, const void* dy, void* part, void* dw, int N,
              int H, int W, int C, int Cout, int bn, int ranges, int jmax,
              int vec, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || ranges <= 0 ||
      jmax <= 0 || (bn != 64 && bn != 128) || 9LL * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ArgsT<T> a;
  a.x = static_cast<const T*>(x);
  a.dy = static_cast<const T*>(dy);
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
  cudaError_t err = prepare_any<T>(bn, vec, nullptr);
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

}  // namespace

// Blocks of conv_wgrad_kernel<bn, vec> that fit an SM of the current
// device, into *out (the host cuts the work into 132 x this many ranges).
extern "C" int mxt_conv_wgrad_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<float>(bn, vec, out);
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
  return wgrad_any<float>(x, dy, part, dw, N, H, W, C, Cout, bn, ranges,
                          jmax, vec, stream);
}

// The same for conv_wgrad_bf16_kernel<bn, vec>.
extern "C" int mxt_conv_wgrad_bf16_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<bf16>(bn, vec, out);
}

// conv_wgrad on bf16 x and dy: dw fp32 (the caller casts it to the
// weight's dtype), everything else as mxt_conv_wgrad_f32; vec != 0: C % 8
// == 0, Cout % 8 == 0 and 16-byte aligned x, dy, dw.  The plan comes from
// mxt_conv_wgrad_bf16_blocks_per_sm.
extern "C" int mxt_conv_wgrad_bf16(const void* x, const void* dy,
                                   void* part, void* dw, int N, int H,
                                   int W, int C, int Cout, int bn,
                                   int ranges, int jmax, int vec,
                                   void* stream) {
  return wgrad_any<bf16>(x, dy, part, dw, N, H, W, C, Cout, bn, ranges,
                         jmax, vec, stream);
}

// The same for conv_wgrad_f16_kernel<bn, vec>, and conv_wgrad on fp16 x
// and dy (dw fp32), everything else as mxt_conv_wgrad_bf16.
extern "C" int mxt_conv_wgrad_f16_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<f16>(bn, vec, out);
}

extern "C" int mxt_conv_wgrad_f16(const void* x, const void* dy, void* part,
                                  void* dw, int N, int H, int W, int C,
                                  int Cout, int bn, int ranges, int jmax,
                                  int vec, void* stream) {
  return wgrad_any<f16>(x, dy, part, dw, N, H, W, C, Cout, bn, ranges, jmax,
                        vec, stream);
}
