// The 3x3/s1/p1 convolution, fp32 in and out, on Hopper's tensor cores in
// 3xTF32, with one of three epilogues: none (conv3x3), the per-channel
// batch statistics read off the accumulator (conv_stats), or a folded
// frozen BatchNorm (+ residual) (+ ReLU) (conv_affine):
//
//   z[m][co] = sum over k of patches[m][k] * w[k][co]
//   stats[0][co] = sum over m of z[m][co], stats[1][co] = ... z^2
//   out[m][co] = act(z[m][co] * scale[co] + shift[co] (+ res[m][co]))
//   scale = gamma * rsqrt(var + eps),  shift = beta - mean * scale
//
// m runs over the N*H*W output pixels, k = tap*C + c tap-major, x (N, H,
// W, C) NHWC with a zero halo, w (3, 3, C, Cout) HWIO read as the
// row-major (9C, Cout) matrix, out (N, H, W, Cout).  With the weight
// rotated 180 degrees and IO-transposed it is the data gradient (dgrad).
//
// Replaces: mxnet_tpu/ops/pallas_block.py `_conv_kernel` (:318, launched
// by `conv3x3` :419 and `conv3x3_dgrad` :438): the dx of the backward of
// `residual_block_fused` (16 launches a ResNet-50 v1 training step) and
// the frozen backward's recompute of z; `_conv_stats_kernel` (:343,
// `pallas_call` at :496): the training forward's z and its sums (16
// launches a step); and `_conv_affine_kernel` (:325, launched by
// `_conv_affine` :465, with `_fold` :539 and the frozen branch of
// `_fused_fwd` :551), reached through mxnet_tpu/ops/nn.py
// `residual_block` from Gluon's `fused_conv_bn_relu`: the 3x3 mid conv
// of every ResNet-50 v1 bottleneck at inference (16 launches a forward).
//
// Bounds on an H100, at batch 64 of any ResNet-50 stage: 2 * N*H*W * 9C *
// Cout = 14.8 GFLOP, 0.2209 ms at the 67 TFLOP/s fp32 CUDA-core peak.  This
// kernel does three TF32 products for each fp32 one: 44.4 GFLOP, 0.0897 ms
// at the 495 TFLOP/s dense TF32 tensor-core peak (0.137 ms at the 323.8
// TFLOP/s `mma.sync` TF32 ceiling measured on the card).  Bytes (x and w
// read once, out written once): 103 MB at 56x56x64 (0.031 ms at 3.35
// TB/s), 22 MB at 7x7x512 (0.007 ms); the statistics add 8 * Cout bytes,
// the affine 16 * Cout and a residual as large as out.  Operations bound
// it at every stage and batch 8 (1/8 of the above); at batch 1 on
// 7x7x512 the 9.4 MB weight read does (0.0028 ms).
//
// Design.
// - An implicit GEMM, 3xTF32 (tf32x3.cuh): every fp32 operand is split
//   on its way from shared memory into registers into TF32 hi and lo and
//   each product is lo*hi' + hi*lo' + hi*hi' on
//   `mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32`.  A chunk's products
//   (12 a chain) gather in a run accumulator from zero that is added to
//   the tile's sums with IEEE adds: the tensor core truncates its own
//   fp32 sums, and the chain here is K = 576-4608 long.
// - Tiles: a block of 8 warps owns 128 pixels x BN output channels (BN
//   64 for Cout <= 64, else 128); a warp owns 32 x BN/2 as 2 x BN/16
//   fragments.  The next step's fragments are read while this step's
//   products run.
// - Data: the reduction runs over k in chunks of 32 through a four-stage
//   ring in shared memory filled by 16-byte `cp.async` copies (4-byte
//   ones when C or Cout is not a multiple of 4).  For one tap a pixel's
//   channels are contiguous in NHWC, so a 4-wide piece of k is one copy;
//   halo taps, pixels past N*H*W and k past 9C are zero-filled with a
//   source size of 0.  A is stored pixel-major (rows 36 floats apart),
//   B k-major (rows BN + 8 apart), so the fragment reads of a warp hit
//   32 banks.
// - Index math: a thread copies one fixed 4-wide k piece of 4 pixel rows
//   and one 4-wide channel piece of B; the pixels' (h, w) come from one
//   division a segment, and the piece's (tap, c) steps by 32 a chunk with
//   a carry: no division in the loop.
// - Work split in one wave (stream-K, as conv_wgrad.cu): the tiles x
//   chunks of work are cut into `ranges` = 132 x (blocks an SM, from the
//   occupancy API of the instance that runs) ranges of whole chunks, one
//   a block.  A segment that covers a whole tile writes it to out; a cut
//   one writes its partial tile's rows < N*H*W to a slot of its range
//   (the first segment of range b to slot 2b, the last to 2b + 1), and a
//   second kernel sums a cut tile's slots in range order (no float
//   atomics), so out is bitwise the same from run to run.  At 7x7x512
//   (100 tiles of 128 x 128 at batch 64, 16 at batch 8, 4 at batch 1)
//   the grid is one full wave where the tiles alone would leave most SMs
//   idle; at 56x56 and 28x28 at batch 64 only ~ranges tiles are cut, ~17
//   MB of partials.
// - The statistics (conv_stats, the STATS instance of the same body; no
//   float atomics, the same sums on every run): a whole tile sums each
//   of its BN columns over its rows < M from the fp32 accumulator before
//   it leaves the registers, in a fixed order (each lane its four rows,
//   an xor-shuffle over the 8 row groups of the fragments, then the 4
//   pixel-warps in order through shared memory), into its row of the
//   per-tile partials (ceil(M/128), 2, Cout).  A cut tile has no finished
//   z in registers: conv_stats_cut_kernel, one block a cut tile, sums its
//   slots in range order exactly as conv3x3_reduce_kernel does (so z is
//   the conv3x3 kernel's bit for bit when the plans agree), writes z, and
//   sums the finished values of each column in a fixed order into the
//   tile's row.  conv_stats_sum_kernel then adds the ceil(M/128) rows of
//   each column in a fixed order (0.8 MB at 56x56x64).
// - The affine (conv_affine, the AFFINE instance): a whole tile folds the
//   BatchNorm of its two columns of each fragment once, into registers,
//   and applies scale, shift, the residual (read in the same float2
//   pairs as the store) and the ReLU to the fp32 accumulator before it
//   leaves the registers, so out makes one trip to device memory.  A cut
//   tile's slots are summed by conv_affine_reduce_kernel exactly as
//   conv3x3_reduce_kernel sums them, which then applies the same
//   epilogue four values a thread (16-byte residual loads and stores
//   where VEC holds).  At batch 8 nearly every tile is cut: 196 tiles of
//   18 chunks at 56x56 in 264 ranges.
// - Each instance's plan comes from its own occupancy entry.
//
// The bf16 instances (conv_affine since the bf16 serving slice; conv3x3,
// also as dgrad, and conv_stats since the bf16 training slice; the
// reference's kernels take bf16 operands with an fp32 accumulator and
// write out_ref.dtype): the same ranges, ring, reduce and epilogues, with
// x, w, the BatchNorm vectors, res and out (z) in bf16.  A 16-byte copy
// moves 8 channels (C % 8 == 0 and Cout % 8 == 0 for the vector path; the
// scalar path loads and stores each element, as cp.async has no 2-byte
// copy), the ring's A rows are 40 halves apart, and each 16-deep step of
// a chunk is one `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32` product,
// exact in fp32, in place of three TF32 ones; the partial slots and their
// fixed-order reduce stay fp32, so a relaunch is bitwise.  The BatchNorm
// is folded in fp32 from the bf16 vectors (as _fold casts them), the
// residual widened to fp32, and each output rounded once to bf16 at the
// store.  conv_stats sums each column's fp32 values before z is rounded:
// a whole tile from its accumulator, a cut tile from its summed slots
// (conv_stats_cut_kernel), as _conv_stats_kernel sums its f32
// accumulator.  Bound at batch 8 of a ResNet-50 stage: 1.85 GFLOP, 0.0019
// ms at the 989 TFLOP/s dense bf16 peak; 2.8-6.5 MB, 0.0008-0.0019 ms at
// 3.35 TB/s; at batch 128 (the bf16 training step) 29.6 GFLOP, 0.0299 ms,
// and 0.0307 ms of bytes at 56x56x64, where bytes bind.
//
// The fp16 instances (the fp16 training slice; the reference's kernels
// take fp16 operands as they take bf16): the same code on `__half`
// storage (`Half<T>` of tf32x3.cuh), each 16-deep step one
// `mma.sync.m16n8k16.row.col.f32.f16.f16.f32` product, exact in fp32;
// the outputs rounded to nearest even (overflowing to +-inf past 65504,
// subnormals kept), conv_stats' sums of the fp32 values before that.  On
// both half types conv_affine takes each BatchNorm vector in the half
// type or in fp32 (a bit each in `vf32`: a half step keeps its running
// statistics fp32).  The path's fp16 shapes (C and Cout multiples of 8,
// aligned) take conv_bf16_wgmma.cu's fp16 instances; these take the rest
// (C = 20, say).  Bound as the bf16 instances'.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

extern __shared__ __align__(16) unsigned char mxt_conv3x3_smem[];

namespace {

using namespace mxt_tf32;

constexpr int BM = 128;        // output pixels a tile
constexpr int BK = 32;         // patch columns (k) a chunk
constexpr int STAGES = 4;
constexpr int kThreads = 256;  // 8 warps: 4 along pixels x 2 along co

using bf16 = __nv_bfloat16;
using f16 = __half;

// what a finished tile gets on its way out
enum class Epi { kNone, kStats, kAffine };

// The ring's A row stride in elements of T: 36 floats, 40 halves (80
// bytes: the fragment reads of a warp still hit 32 banks).
template <typename T>
constexpr int lda() {
  return sizeof(T) == 4 ? BK + 4 : BK + 8;
}

template <int BN, typename T = float>
struct Ring {
  T a[STAGES][BM][lda<T>()];     // patches: pixel rows, k contiguous
  T b[STAGES][BK][BN + 8];       // weight: k rows, channels contiguous
};

// fp32 and half values as fp32 (a half instance widens on the way out
// of shared memory or device memory; its products are exact in fp32)
__device__ __forceinline__ float wide(float v) { return v; }
__device__ __forceinline__ float wide(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float wide(f16 v) { return __half2float(v); }

// T is the storage type of x, w, res and out: fp32, bf16 or fp16 (every
// instance); the BatchNorm vectors are T too, or on a half T each fp32
// where its bit of vf32 says so; the partial tiles and the statistics are
// fp32 in all.
template <typename T>
struct ArgsT {
  const T* x;           // (N, H, W, C)
  const T* w;           // (9C, Cout)
  T* out;               // (N*H*W, Cout)
  float* part;          // (2 * ranges, BM, BN) partial tiles
  float* tstats;        // conv_stats: (ceil(M / BM), 2, Cout) tile sums
  const T* gamma;       // conv_affine: (Cout,) each
  const T* beta;
  const T* mean;
  const T* var;
  const T* res;         // conv_affine: (N*H*W, Cout) or null
  float eps;
  int relu;
  int vf32;             // half T: fp32 vectors, 1 gamma 2 beta 4 mean 8 var
  long long nch;        // chunks a tile: ceil(K / BK)
  long long total;      // tiles * nch units of work
  int M;                // N*H*W
  int H, W, C, Cout, K; // K = 9*C
  int tiles_n;          // tiles along Cout
  int ranges;           // blocks: the work is cut into this many ranges
};

using Args = ArgsT<float>;

// The range of block b is units [b*total/ranges, (b+1)*total/ranges);
// unit u lies in range ((u+1)*ranges - 1) / total.
template <typename A>
__device__ __forceinline__ long long range_start(const A& a, long long b) {
  return b * a.total / a.ranges;
}

template <typename A>
__device__ __forceinline__ long long range_of(const A& a, long long u) {
  return ((u + 1) * a.ranges - 1) / a.total;
}

// One thread's share of filling a ring stage with one chunk.  A piece is
// 16 bytes: PW = 4 floats or 8 halves.  A: piece q (k = kc + PW*q ..) of
// pixel rows r0 + RS*i, i < AROWS (fp32: 8 pieces a row, rows 32 apart;
// bf16: 4 pieces, rows 64 apart).  B: piece nb (channels n0 + PW*nb ..)
// of k rows rb + BSTEP*i.  VEC: C % PW == 0 and Cout % PW == 0 (a piece
// lies in one tap and is wholly in or out), 16-byte aligned bases: one
// 16-byte copy a piece; otherwise each element on its own, with its own
// tap (fp32: 4-byte copies; bf16, which cp.async cannot copy 2 bytes at a
// time: a plain load and store, which the ring's barriers order like the
// copies).
template <int BN, bool VEC, typename T = float>
struct Loader {
  static constexpr int PW = 16 / (int)sizeof(T);
  static constexpr int KP = BK / PW;           // pieces along k a row
  static constexpr int RS = kThreads / KP;     // rows between a thread's
  static constexpr int NE = VEC ? 1 : PW;      // taps held a piece
  static constexpr int AROWS = BM / RS;
  static constexpr int NBP = BN / PW;          // pieces along B's row
  static constexpr int BSTEP = kThreads / NBP;
  static constexpr int BROWS = BK / BSTEP;
  const ArgsT<T>& a;
  int q, r0, nb, rb;
  int n;                // B's first channel of the piece
  int kc;               // first k of the next chunk to copy
  int p[AROWS];         // pixel of row r0 + 32i
  int h[AROWS], w[AROWS];
  int th[NE], tw[NE], c[NE];   // tap (row, column) and channel of k + e

  __device__ __forceinline__ Loader(const ArgsT<T>& args, int m0, int n0,
                                    int kbeg)
      : a(args), kc(kbeg) {
    q = threadIdx.x % KP;
    r0 = threadIdx.x / KP;
    nb = threadIdx.x % NBP;
    rb = threadIdx.x / NBP;
    n = n0 + PW * nb;
#pragma unroll
    for (int i = 0; i < AROWS; ++i) {
      p[i] = m0 + r0 + RS * i;
      w[i] = p[i] % a.W;
      // a pixel past the range gets an h no tap can bring into [0, H)
      h[i] = p[i] < a.M ? (p[i] / a.W) % a.H : -4;
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int k = kbeg + PW * q + e;
      const int tap = k / a.C;
      c[e] = k - tap * a.C;
      th[e] = tap / 3;   // 3 or more: k past 9C, zero-filled
      tw[e] = tap % 3;
    }
  }

  // one element of T, or 0, without cp.async (bf16's scalar path)
  __device__ __forceinline__ static void put(T* dst, const T* src,
                                             bool ok) {
    *reinterpret_cast<uint16_t*>(dst) =
        ok ? *reinterpret_cast<const uint16_t*>(src) : (uint16_t)0;
  }

  // copy the chunk at kc into stage st and step to the next one
  __device__ __forceinline__ void load(Ring<BN, T>& s, int st) {
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const long long off =
          ((long long)(th[e] - 1) * a.W + (tw[e] - 1)) * a.C + c[e];
#pragma unroll
      for (int i = 0; i < AROWS; ++i) {
        const int ih = h[i] + th[e] - 1, iw = w[i] + tw[e] - 1;
        const bool ok = th[e] < 3 && (unsigned)ih < (unsigned)a.H &&
                        (unsigned)iw < (unsigned)a.W;
        const T* src = ok ? a.x + (long long)p[i] * a.C + off : a.x;
        T* dst = &s.a[st][r0 + RS * i][PW * q + e];
        if constexpr (VEC)
          cp_async16(dst, src, ok);
        else if constexpr (sizeof(T) == 4)
          cp_async4(dst, src, ok);
        else
          put(dst, src, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < BROWS; ++i) {
      const int row = rb + BSTEP * i;
      const int k = kc + row;
      T* db = &s.b[st][row][PW * nb];
      const T* wrow = a.w + (long long)k * a.Cout;
      if constexpr (VEC) {
        const bool ok = k < a.K && n < a.Cout;
        cp_async16(db, ok ? wrow + n : a.w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < PW; ++e) {
          const bool ok = k < a.K && n + e < a.Cout;
          if constexpr (sizeof(T) == 4)
            cp_async4(db + e, ok ? wrow + n + e : a.w, ok);
          else
            put(db + e, ok ? wrow + n + e : a.w, ok);
        }
      }
    }
    kc += BK;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      c[e] += BK;
      while (c[e] >= a.C) {   // once a chunk when C >= 32
        c[e] -= a.C;
        if (++tw[e] == 3) {
          tw[e] = 0;
          ++th[e];
        }
      }
    }
  }
};

// A warp's fp32 fragments of one 8-deep k step: a[mi] the 16 x 8 A
// fragment of pixel rows wm*32 + mi*16 .., b[ni] the 8 x 8 B fragment of
// channels wn*BN/2 + ni*8 ..
template <int BN>
struct Frags {
  float a[2][4];
  float b[BN / 16][2];
};

template <int BN>
__device__ __forceinline__ void load_frags(const Ring<BN>& s, int st, int ks,
                                           int wm, int wn, int g, int t,
                                           Frags<BN>& f) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = wm * 32 + mi * 16 + g;
    f.a[mi][0] = s.a[st][r][ks + t];
    f.a[mi][1] = s.a[st][r + 8][ks + t];
    f.a[mi][2] = s.a[st][r][ks + t + 4];
    f.a[mi][3] = s.a[st][r + 8][ks + t + 4];
  }
#pragma unroll
  for (int ni = 0; ni < BN / 16; ++ni) {
    const int cn = wn * (BN / 2) + ni * 8 + g;
    f.b[ni][0] = s.b[st][ks + t][cn];
    f.b[ni][1] = s.b[st][ks + t + 4][cn];
  }
}

// acc += this warp's 32 x BN/2 share of the chunk in stage st, its four
// steps gathered in a run accumulator from zero and added with IEEE adds
template <int BN>
__device__ __forceinline__ void mma_chunk(const Ring<BN>& s, int st,
                                          int wm, int wn, int g, int t,
                                          float (&acc)[2][BN / 16][4]) {
  float run[2][BN / 16][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[mi][ni][e] = 0.f;
  Frags<BN> f[2];
  load_frags<BN>(s, st, 0, wm, wn, g, t, f[0]);
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    if (ks + 1 < BK / 8)
      load_frags<BN>(s, st, (ks + 1) * 8, wm, wn, g, t, f[(ks + 1) & 1]);
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

template <typename T>
__device__ __forceinline__ uint32_t ld_pair(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ uint32_t pack_pair(T lo, T hi) {
  return (uint32_t)Half<T>::bits(lo) | (uint32_t)Half<T>::bits(hi) << 16;
}

// The half instances of mma_chunk (T bf16 or fp16): acc += this warp's 32
// x BN/2 share of the chunk in stage st as two 16-deep steps of one half
// product each (the products are exact in fp32), gathered in a run
// accumulator from zero and added with IEEE adds.  A's pairs are
// contiguous in k (one 4-byte read); B's two k of a pair lie a row apart
// (two 2-byte reads).
template <int BN, typename T>
__device__ __forceinline__ void mma_chunk(const Ring<BN, T>& s, int st,
                                          int wm, int wn, int g, int t,
                                          float (&acc)[2][BN / 16][4]) {
  float run[2][BN / 16][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[mi][ni][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      af[mi][0] = ld_pair(&s.a[st][r][ks + 2 * t]);
      af[mi][1] = ld_pair(&s.a[st][r + 8][ks + 2 * t]);
      af[mi][2] = ld_pair(&s.a[st][r][ks + 2 * t + 8]);
      af[mi][3] = ld_pair(&s.a[st][r + 8][ks + 2 * t + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < BN / 16; ++ni) {
      const int cn = wn * (BN / 2) + ni * 8 + g;
      const uint32_t bf[2] = {
          pack_pair(s.b[st][ks + 2 * t][cn], s.b[st][ks + 2 * t + 1][cn]),
          pack_pair(s.b[st][ks + 2 * t + 8][cn],
                    s.b[st][ks + 2 * t + 9][cn])};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) Half<T>::mma(run[mi][ni], af[mi], bf);
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

// Sum and sum of squares of each of a whole tile's BN columns over its
// rows < M, from the fp32 accumulator, in a fixed order: each lane its
// four rows (mi, hf) in turn, an xor-shuffle over the 8 row groups g,
// then the 4 pixel-warps wm in order through shared memory (the ring,
// free once every warp has read its last chunk).  Writes the tile's row
// m0 / BM of tstats for its columns n0 ..
template <int BN, typename T>
__device__ __forceinline__ void tile_stats(const ArgsT<T>& a,
                                           const float (&acc)[2][BN / 16][4],
                                           int m0, int n0, int wm, int wn,
                                           int g, int t) {
  float(*red)[2][BN] = reinterpret_cast<float(*)[2][BN]>(mxt_conv3x3_smem);
  __syncthreads();   // every warp is done with the ring
#pragma unroll
  for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (m0 + wm * 32 + mi * 16 + g + 8 * hf < a.M) {
            const float v = acc[mi][ni][2 * hf + j];
            s1 += v;
            s2 = fmaf(v, v, s2);
          }
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (g == 0) {
        const int cl = wn * (BN / 2) + ni * 8 + 2 * t + j;
        red[wm][0][cl] = s1;
        red[wm][1][cl] = s2;
      }
    }
  __syncthreads();
  if (threadIdx.x < 2 * BN) {
    const int which = threadIdx.x / BN, c = threadIdx.x % BN;
    float v = red[0][which][c];
#pragma unroll
    for (int q = 1; q < 4; ++q) v += red[q][which][c];
    if (n0 + c < a.Cout)
      a.tstats[((long long)(m0 / BM) * 2 + which) * a.Cout + n0 + c] = v;
  }
}

// Element n of BatchNorm vector p as fp32: on a half T, read as fp32
// where bit `bit` of vf32 is set, else widened (as _fold casts them).
template <typename T>
__device__ __forceinline__ float vec_at(const ArgsT<T>& a, const T* p,
                                        int bit, int n) {
  if constexpr (sizeof(T) == 2)
    if (a.vf32 & bit) return reinterpret_cast<const float*>(p)[n];
  return wide(p[n]);
}

// The folded frozen BatchNorm of channel n, in fp32 from the vectors as
// stored: scale = gamma * rsqrt(var + eps), shift = beta - mean * scale.
template <typename T>
__device__ __forceinline__ void fold(const ArgsT<T>& a, int n, float& sc,
                                     float& sh) {
  sc = vec_at(a, a.gamma, 1, n) * rsqrtf(vec_at(a, a.var, 8, n) + a.eps);
  sh = vec_at(a, a.beta, 2, n) - vec_at(a, a.mean, 4, n) * sc;
}

template <typename T>
__device__ __forceinline__ float affine(const ArgsT<T>& a, float v, float sc,
                                        float sh, float r) {
  v = v * sc + sh;
  if (a.res) v += r;
  return a.relu ? (v > 0.f ? v : 0.f) : v;
}

// Store a whole tile's out[m][n], out[m][n + 1] (m < M checked by the
// caller), through the affine epilogue when EPI is kAffine (sc, sh: the
// two columns' folded BatchNorm).  VEC: Cout % 4 == 0 and 16-byte aligned
// bases, so n < Cout implies n + 1 < Cout and the pair is one float2.
// A half T (bf16, fp16): the residual pair widened to fp32, the result
// rounded once to a pair of T at the store (VEC: Cout % 8 == 0).
template <bool VEC, Epi EPI, typename T>
__device__ __forceinline__ void store2(const ArgsT<T>& a, int m, int n,
                                       float v0, float v1,
                                       const float (&sc)[2],
                                       const float (&sh)[2]) {
  using T2 = typename Half<T>::T2;
  const long long at = (long long)m * a.Cout + n;
  if constexpr (VEC) {
    if (n >= a.Cout) return;
    if constexpr (EPI == Epi::kAffine) {
      float2 r = make_float2(0.f, 0.f);
      if (a.res)
        r = Half<T>::wide2(*reinterpret_cast<const T2*>(a.res + at));
      v0 = affine(a, v0, sc[0], sh[0], r.x);
      v1 = affine(a, v1, sc[1], sh[1], r.y);
    }
    *reinterpret_cast<T2*>(a.out + at) = Half<T>::narrow2(v0, v1);
  } else {
    const float v[2] = {v0, v1};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (n + j >= a.Cout) continue;
      float o = v[j];
      if constexpr (EPI == Epi::kAffine)
        o = affine(a, o, sc[j], sh[j], a.res ? wide(a.res[at + j]) : 0.f);
      a.out[at + j] = Half<T>::narrow(o);
    }
  }
}

template <bool VEC, Epi EPI>
__device__ __forceinline__ void store2(const Args& a, int m, int n,
                                       float v0, float v1,
                                       const float (&sc)[2],
                                       const float (&sh)[2]) {
  const long long at = (long long)m * a.Cout + n;
  if constexpr (VEC) {
    if (n >= a.Cout) return;
    if constexpr (EPI == Epi::kAffine) {
      float2 r = make_float2(0.f, 0.f);
      if (a.res) r = *reinterpret_cast<const float2*>(a.res + at);
      v0 = affine(a, v0, sc[0], sh[0], r.x);
      v1 = affine(a, v1, sc[1], sh[1], r.y);
    }
    *reinterpret_cast<float2*>(a.out + at) = make_float2(v0, v1);
  } else {
    const float v[2] = {v0, v1};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (n + j >= a.Cout) continue;
      float o = v[j];
      if constexpr (EPI == Epi::kAffine)
        o = affine(a, o, sc[j], sh[j], a.res ? a.res[at + j] : 0.f);
      a.out[at + j] = o;
    }
  }
}

// The body of the three kernels: the segments of range blockIdx.x, each
// into out (a whole tile) or a slot (a cut one).  kStats: a whole tile
// also writes its row of per-tile sums; kAffine: a whole tile goes out
// through the folded BatchNorm (+ residual) (+ ReLU).
template <int BN, bool VEC, Epi EPI, typename T = float>
__device__ __forceinline__ void conv_ranges(const ArgsT<T>& a) {
  Ring<BN, T>& s = *reinterpret_cast<Ring<BN, T>*>(mxt_conv3x3_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;   // 32-row, BN/2-column share
  const int g = lane >> 2, t = lane & 3;     // mma fragment coordinates
  const long long b = blockIdx.x;
  const long long u0 = range_start(a, b);
  const long long u1 = range_start(a, b + 1);

  for (long long u = u0; u < u1;) {
    const long long tile = u / a.nch;
    const int c0 = (int)(u - tile * a.nch);
    const long long send =
        u1 < (tile + 1) * a.nch ? u1 : (tile + 1) * a.nch;
    const int nk = (int)(send - u);
    const int m0 = (int)(tile / a.tiles_n) * BM;
    const int n0 = (int)(tile % a.tiles_n) * BN;

    float acc[2][BN / 16][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    Loader<BN, VEC, T> ld(a, m0, n0, c0 * BK);
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
      mma_chunk<BN>(s, kt % STAGES, wm, wn, g, t, acc);
    }
    cp_async_wait<0>();

    // a whole tile goes to out; the rows < M of a cut one to its range's
    // first (2b) or last (2b + 1) slot (no kernel that sums slots uses
    // other rows)
    const bool whole = c0 == 0 && nk == a.nch;
    float* slot = a.part + (2 * b + (u == u0 ? 0 : 1)) * (long long)(BM * BN);
#pragma unroll
    for (int ni = 0; ni < BN / 16; ++ni) {
      const int cl = wn * (BN / 2) + ni * 8 + 2 * t;
      const int nn = n0 + cl;
      float sc[2] = {1.f, 1.f}, sh[2] = {0.f, 0.f};
      if constexpr (EPI == Epi::kAffine) {
        // the BatchNorm of this fragment's two columns, folded once a tile
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (whole && nn + j < a.Cout) fold(a, nn + j, sc[j], sh[j]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = wm * 32 + mi * 16 + g + 8 * hf;
          const float v0 = acc[mi][ni][2 * hf], v1 = acc[mi][ni][2 * hf + 1];
          if (m0 + r >= a.M) continue;
          if (whole)
            store2<VEC, EPI>(a, m0 + r, nn, v0, v1, sc, sh);
          else
            *reinterpret_cast<float2*>(slot + r * BN + cl) =
                make_float2(v0, v1);
        }
    }
    if constexpr (EPI == Epi::kStats) {
      if (whole) tile_stats<BN>(a, acc, m0, n0, wm, wn, g, t);
    }
    u = send;
  }
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv3x3_tc_kernel(const Args a) {
  conv_ranges<BN, VEC, Epi::kNone>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_stats_tc_kernel(const Args a) {
  conv_ranges<BN, VEC, Epi::kStats>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_affine_tc_kernel(const Args a) {
  conv_ranges<BN, VEC, Epi::kAffine>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_affine_bf16_kernel(const ArgsT<bf16> a) {
  conv_ranges<BN, VEC, Epi::kAffine, bf16>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv3x3_bf16_kernel(const ArgsT<bf16> a) {
  conv_ranges<BN, VEC, Epi::kNone, bf16>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_stats_bf16_kernel(const ArgsT<bf16> a) {
  conv_ranges<BN, VEC, Epi::kStats, bf16>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_affine_f16_kernel(const ArgsT<f16> a) {
  conv_ranges<BN, VEC, Epi::kAffine, f16>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv3x3_f16_kernel(const ArgsT<f16> a) {
  conv_ranges<BN, VEC, Epi::kNone, f16>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_stats_f16_kernel(const ArgsT<f16> a) {
  conv_ranges<BN, VEC, Epi::kStats, f16>(a);
}

// The main kernel of an epilogue and storage type.
template <int BN, bool VEC, Epi EPI, typename T = float>
auto main_kernel() {
  if constexpr (std::is_same_v<T, bf16>) {
    if constexpr (EPI == Epi::kNone)
      return conv3x3_bf16_kernel<BN, VEC>;
    else if constexpr (EPI == Epi::kStats)
      return conv_stats_bf16_kernel<BN, VEC>;
    else
      return conv_affine_bf16_kernel<BN, VEC>;
  } else if constexpr (std::is_same_v<T, f16>) {
    if constexpr (EPI == Epi::kNone)
      return conv3x3_f16_kernel<BN, VEC>;
    else if constexpr (EPI == Epi::kStats)
      return conv_stats_f16_kernel<BN, VEC>;
    else
      return conv_affine_f16_kernel<BN, VEC>;
  } else if constexpr (EPI == Epi::kNone) {
    return conv3x3_tc_kernel<BN, VEC>;
  } else if constexpr (EPI == Epi::kStats) {
    return conv_stats_tc_kernel<BN, VEC>;
  } else {
    return conv_affine_tc_kernel<BN, VEC>;
  }
}

constexpr int SLOT_BATCH = 8;   // partial slots a reduce loads at once

// The tile cut at the start of range r >= 1 if that is the first range
// start inside it, else -1.
template <typename A>
__device__ __forceinline__ long long cut_tile(const A& a, long long r) {
  const long long sr = range_start(a, r);
  if (sr % a.nch == 0) return -1;              // starts on a tile edge
  const long long tile = sr / a.nch;
  if (range_of(a, tile * a.nch) != r - 1) return -1;   // an earlier start
  return tile;
}

// Store out[m][n .. n + 3] (m < M checked by the caller).  VEC: Cout % 4
// == 0 and out 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void store4(const Args& a, int m, int n,
                                       float4 v) {
  float* o = a.out + (long long)m * a.Cout + n;
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(o) = v;
  } else {
    const float sv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n + i < a.Cout) o[i] = sv[i];
  }
}

// The same for half out, each value rounded once (VEC: Cout % 8 == 0, so
// the four are one 8-byte store).
template <bool VEC, typename T>
__device__ __forceinline__ void store4(const ArgsT<T>& a, int m, int n,
                                       float4 v) {
  T* o = a.out + (long long)m * a.Cout + n;
  if constexpr (VEC) {
    typename Half<T>::T2 h[2] = {Half<T>::narrow2(v.x, v.y),
                                 Half<T>::narrow2(v.z, v.w)};
    *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(h);
  } else {
    const float sv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n + i < a.Cout) o[i] = Half<T>::narrow(sv[i]);
  }
}

// res[at .. at + 3] as fp32 (VEC: one 16-byte or, for a half T, 8-byte
// load)
template <bool VEC, typename T>
__device__ __forceinline__ void load4(const T* res, long long at, int n,
                                      int Cout, float (&r)[4]) {
  if constexpr (VEC && sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(res + at);
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else if constexpr (VEC) {
    using T2 = typename Half<T>::T2;
    const uint2 q = *reinterpret_cast<const uint2*>(res + at);
    const float2 lo = Half<T>::wide2(*reinterpret_cast<const T2*>(&q.x));
    const float2 hi = Half<T>::wide2(*reinterpret_cast<const T2*>(&q.y));
    r[0] = lo.x; r[1] = lo.y; r[2] = hi.x; r[3] = hi.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n + i < Cout) r[i] = wide(res[at + i]);
  }
}

// out[m][n .. n + 3] of a cut tile from its summed slots v, through the
// affine epilogue (the four columns' BatchNorm folded here) for kAffine.
template <bool VEC, Epi EPI, typename T>
__device__ __forceinline__ void finish4(const ArgsT<T>& a, int m, int n,
                                        float4 v) {
  if constexpr (EPI == Epi::kAffine) {
    const long long at = (long long)m * a.Cout + n;
    float r[4] = {0.f, 0.f, 0.f, 0.f};
    if (a.res) load4<VEC>(a.res, at, n, a.Cout, r);
    float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (n + i >= a.Cout) continue;
      float sc, sh;
      fold(a, n + i, sc, sh);
      e[i] = affine(a, e[i], sc, sh, r[i]);
    }
    v = make_float4(e[0], e[1], e[2], e[3]);
  }
  store4<VEC>(a, m, n, v);
}

// The tile cut at the start of range blockIdx.y + 1, if that range owns
// it (cut_tile): its slots summed, 4 values a thread, then finished.
template <int BN, bool VEC, Epi EPI, typename T = float>
__device__ __forceinline__ void reduce_cut(const ArgsT<T>& a) {
  const long long r = (long long)blockIdx.y + 1;
  const long long tile = cut_tile(a, r);
  if (tile < 0) return;
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= BM * BN) return;
  const int m = (int)(tile / a.tiles_n) * BM + e / BN;
  const int n = (int)(tile % a.tiles_n) * BN + e % BN;
  if (m >= a.M || n >= a.Cout) return;
  const long long t0 = tile * a.nch;
  const long long last = range_of(a, t0 + a.nch - 1);
  // the segment of range r - 1 is its first one iff it starts in the
  // tile (at its first unit); ranges r .. last start in it
  const long long first =
      2 * (r - 1) + (range_start(a, r - 1) >= t0 ? 0 : 1);
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  // SLOT_BATCH slots loaded before they are added, in range order (one at
  // a time, a thread would wait on memory for every slot)
  for (long long q0 = r - 1; q0 <= last; q0 += SLOT_BATCH) {
    float4 v[SLOT_BATCH];
#pragma unroll
    for (int i = 0; i < SLOT_BATCH; ++i) {
      const long long q = q0 + i;
      if (q > last) break;
      const long long slot = q == r - 1 ? first : 2 * q;
      v[i] = *reinterpret_cast<const float4*>(
          a.part + slot * (long long)(BM * BN) + e);
    }
#pragma unroll
    for (int i = 0; i < SLOT_BATCH; ++i) {
      if (q0 + i > last) break;
      if (q0 + i == r - 1) {
        sum = v[i];
      } else {
        sum.x += v[i].x; sum.y += v[i].y; sum.z += v[i].z; sum.w += v[i].w;
      }
    }
  }
  finish4<VEC, EPI>(a, m, n, sum);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(256)
conv3x3_reduce_kernel(const Args a) {
  reduce_cut<BN, VEC, Epi::kNone>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(256)
conv_affine_reduce_kernel(const Args a) {
  reduce_cut<BN, VEC, Epi::kAffine>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(256)
conv_affine_bf16_reduce_kernel(const ArgsT<bf16> a) {
  reduce_cut<BN, VEC, Epi::kAffine, bf16>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(256)
conv3x3_bf16_reduce_kernel(const ArgsT<bf16> a) {
  reduce_cut<BN, VEC, Epi::kNone, bf16>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(256)
conv_affine_f16_reduce_kernel(const ArgsT<f16> a) {
  reduce_cut<BN, VEC, Epi::kAffine, f16>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(256)
conv3x3_f16_reduce_kernel(const ArgsT<f16> a) {
  reduce_cut<BN, VEC, Epi::kNone, f16>(a);
}

// conv_stats' cut tiles: block blockIdx.x finds the tile cut at the start
// of range blockIdx.x + 1 (cut_tile), sums its slots in range order as
// conv3x3_reduce_kernel does (a slot at a time, each thread its RPT rows
// of one 4-column piece), writes z, and sums each column's finished
// values over the rows < M in a fixed order (a thread its rows rg, rg +
// RG, ... in turn, then the RG row groups in order through shared
// memory) into the tile's row of tstats.  bf16: the sums are of the fp32
// values summed from the slots, before z is rounded at its store, as a
// whole tile's are of its fp32 accumulator.
template <int BN, bool VEC, typename T = float>
__global__ void __launch_bounds__(1024)
conv_stats_cut_kernel(const ArgsT<T> a) {
  constexpr int CQ = BN / 4;        // 4-column pieces of a row
  constexpr int RG = 1024 / CQ;     // row groups: 32 (BN 128), 64 (BN 64)
  constexpr int RPT = BM / RG;      // rows a thread: 4 or 2
  __shared__ float red[2][RG][BN];  // 32 KB
  const long long r = (long long)blockIdx.x + 1;
  const long long tile = cut_tile(a, r);
  if (tile < 0) return;
  const int cq = threadIdx.x % CQ, rg = threadIdx.x / CQ;
  const int m0 = (int)(tile / a.tiles_n) * BM;
  const int n0 = (int)(tile % a.tiles_n) * BN;
  const int n = n0 + 4 * cq;
  const long long t0 = tile * a.nch;
  const long long last = range_of(a, t0 + a.nch - 1);
  // the segment of range r - 1 is its first one iff it starts in the
  // tile (at its first unit); ranges r .. last start in it
  const long long first =
      2 * (r - 1) + (range_start(a, r - 1) >= t0 ? 0 : 1);
  float4 v[RPT];
  for (long long q = r - 1; q <= last; ++q) {
    const long long slot = q == r - 1 ? first : 2 * q;
    const float* ps = a.part + slot * (long long)(BM * BN) + 4 * cq;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float4 p =
          *reinterpret_cast<const float4*>(ps + (rg + RG * i) * BN);
      if (q == r - 1) {
        v[i] = p;
      } else {
        v[i].x += p.x; v[i].y += p.y; v[i].z += p.z; v[i].w += p.w;
      }
    }
  }
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + rg + RG * i;
    if (m >= a.M) continue;
    if (n < a.Cout) store4<VEC>(a, m, n, v[i]);
    const float sv[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s1[j] += sv[j];
      s2[j] = fmaf(sv[j], sv[j], s2[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][rg][4 * cq + j] = s1[j];
    red[1][rg][4 * cq + j] = s2[j];
  }
  __syncthreads();
  if (threadIdx.x < 2 * BN) {
    const int which = threadIdx.x / BN, c = threadIdx.x % BN;
    float t = red[which][0][c];
    for (int q = 1; q < RG; ++q) t += red[which][q][c];
    if (n0 + c < a.Cout)
      a.tstats[((long long)(m0 / BM) * 2 + which) * a.Cout + n0 + c] = t;
  }
}

// stats[c] = sum over r < rows of tstats[r][c] (c < cols = 2 * Cout), in a
// fixed order: thread (x, y) of a 32 x 32 block adds rows y, y + 32, ...
// of its column in turn, loading SUM_BATCH of them before it adds them
// (one row at a time, it would wait on memory for every row), then thread
// (x, 0) adds the 32 partials in order.
constexpr int SUM_BATCH = 8;

__global__ void __launch_bounds__(1024)
conv_stats_sum_kernel(const float* __restrict__ tstats,
                      float* __restrict__ stats, int rows, int cols) {
  __shared__ float red[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (c < cols) {
    for (int r0 = threadIdx.y; r0 < rows; r0 += 32 * SUM_BATCH) {
      float t[SUM_BATCH];
#pragma unroll
      for (int i = 0; i < SUM_BATCH; ++i) {
        const int r = r0 + 32 * i;
        t[i] = r < rows ? tstats[(long long)r * cols + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < SUM_BATCH; ++i)
        if (r0 + 32 * i < rows) v += t[i];
    }
  }
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float u = 0.f;
    for (int r = 0; r < 32; ++r) u += red[r][threadIdx.x];
    stats[c] = u;
  }
}

template <int BN, bool VEC, Epi EPI, typename T = float>
cudaError_t prepare(int* per_sm) {
  const int bytes = (int)sizeof(Ring<BN, T>);
  const auto kernel = main_kernel<BN, VEC, EPI, T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess || !per_sm) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, bytes);
}

// f(integral_constant<int, BN>, bool_constant<VEC>) for a runtime (bn,
// vec); bn is 64 or 128
template <typename F>
auto with_tile(int bn, int vec, F f) {
  using B64 = std::integral_constant<int, 64>;
  using B128 = std::integral_constant<int, 128>;
  if (bn == 64) return vec ? f(B64(), std::true_type())
                           : f(B64(), std::false_type());
  return vec ? f(B128(), std::true_type()) : f(B128(), std::false_type());
}

template <Epi EPI, typename T = float>
cudaError_t prepare_any(int bn, int vec, int* per_sm) {
  return with_tile(bn, vec, [&](auto BN, auto VEC) {
    return prepare<decltype(BN)::value, decltype(VEC)::value, EPI, T>(
        per_sm);
  });
}

// The main kernel, then the one that finishes the cut tiles.
template <int BN, bool VEC, Epi EPI, typename T = float>
void launch(const ArgsT<T>& a, cudaStream_t s) {
  const auto kernel = main_kernel<BN, VEC, EPI, T>();
  kernel<<<(unsigned)a.ranges, kThreads, sizeof(Ring<BN, T>), s>>>(a);
  if (a.ranges == 1) return;
  if constexpr (EPI == Epi::kStats) {
    conv_stats_cut_kernel<BN, VEC, T>
        <<<(unsigned)(a.ranges - 1), 1024, 0, s>>>(a);
  } else {
    const dim3 grid(BM * BN / 4 / 256, (unsigned)(a.ranges - 1));
    if constexpr (std::is_same_v<T, bf16>) {
      if constexpr (EPI == Epi::kNone)
        conv3x3_bf16_reduce_kernel<BN, VEC><<<grid, 256, 0, s>>>(a);
      else
        conv_affine_bf16_reduce_kernel<BN, VEC><<<grid, 256, 0, s>>>(a);
    } else if constexpr (std::is_same_v<T, f16>) {
      if constexpr (EPI == Epi::kNone)
        conv3x3_f16_reduce_kernel<BN, VEC><<<grid, 256, 0, s>>>(a);
      else
        conv_affine_f16_reduce_kernel<BN, VEC><<<grid, 256, 0, s>>>(a);
    } else if constexpr (EPI == Epi::kNone) {
      conv3x3_reduce_kernel<BN, VEC><<<grid, 256, 0, s>>>(a);
    } else {
      conv_affine_reduce_kernel<BN, VEC><<<grid, 256, 0, s>>>(a);
    }
  }
}

template <Epi EPI, typename T = float>
cudaError_t launch_any(const ArgsT<T>& a, int bn, int vec, cudaStream_t s) {
  cudaError_t err = prepare_any<EPI, T>(bn, vec, nullptr);
  if (err != cudaSuccess) return err;
  with_tile(bn, vec, [&](auto BN, auto VEC) {
    launch<decltype(BN)::value, decltype(VEC)::value, EPI, T>(a, s);
    return 0;
  });
  return cudaGetLastError();
}

// Fill a (the plan's geometry) or return false for shapes the kernels do
// not take.
template <typename T>
bool plan_args(ArgsT<T>& a, const void* x, const void* w, void* part,
               void* out, int N, int H, int W, int C, int Cout, int bn,
               int ranges) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || ranges <= 0 ||
      (bn != 64 && bn != 128) || 9LL * C > 0x7fffffffLL ||
      (long long)N * H * W + BM > 0x7fffffffLL)
    return false;
  a.x = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.out = static_cast<T*>(out);
  a.part = static_cast<float*>(part);
  a.tstats = nullptr;
  a.gamma = a.beta = a.mean = a.var = a.res = nullptr;
  a.eps = 0.f;
  a.relu = 0;
  a.vf32 = 0;
  a.M = N * H * W;
  a.H = H; a.W = W; a.C = C; a.Cout = Cout; a.K = 9 * C;
  a.tiles_n = (Cout + bn - 1) / bn;
  const long long tiles = (long long)((a.M + BM - 1) / BM) * a.tiles_n;
  a.nch = (a.K + BK - 1) / BK;
  a.total = tiles * a.nch;
  a.ranges = ranges;
  return ranges <= a.total && ranges <= 65536;
}

// conv_stats of storage type T: the main kernel and the cut tiles' into
// tstats, then their sum into stats.
template <typename T>
int conv_stats_any(const void* x, const void* w, void* part, void* z,
                   void* tstats, void* stats, int N, int H, int W, int C,
                   int Cout, int bn, int ranges, int vec, void* stream) {
  ArgsT<T> a;
  if (!plan_args(a, x, w, part, z, N, H, W, C, Cout, bn, ranges))
    return (int)cudaErrorInvalidValue;
  a.tstats = static_cast<float*>(tstats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_any<Epi::kStats, T>(a, bn, vec, s);
  if (err != cudaSuccess) return (int)err;
  const int rows = (a.M + BM - 1) / BM, cols = 2 * Cout;
  conv_stats_sum_kernel<<<(unsigned)((cols + 31) / 32), dim3(32, 32), 0,
                          s>>>(a.tstats, static_cast<float*>(stats), rows,
                               cols);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of conv3x3_tc_kernel<bn, vec> that fit an SM of the current
// device, into *out (the host cuts the work into 132 x this many ranges).
extern "C" int mxt_conv3x3_tc_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<Epi::kNone>(bn, vec, out);
}

// The same for conv_stats_tc_kernel<bn, vec>.
extern "C" int mxt_conv_stats_tc_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<Epi::kStats>(bn, vec, out);
}

// The same for conv_affine_tc_kernel<bn, vec>.
extern "C" int mxt_conv_affine_tc_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<Epi::kAffine>(bn, vec, out);
}

// x (N, H, W, C), w (3, 3, C, Cout) == (9C, Cout), out (N, H, W, Cout),
// all contiguous fp32; part (2 * ranges, 128, bn) fp32 scratch.  The
// tiles (ceil(N*H*W / 128) x ceil(Cout / bn)) x ceil(9C / 32) units of work
// are cut into `ranges` ranges, one a block.  The plan (bn, ranges) is the
// caller's: mxnet_tpu_torch/ops/conv_block.py conv3x3_splits.  vec != 0:
// C % 4 == 0, Cout % 4 == 0 and 16-byte aligned x, w, out.
extern "C" int mxt_conv3x3_tc_f32(const void* x, const void* w, void* part,
                                  void* out, int N, int H, int W, int C,
                                  int Cout, int bn, int ranges, int vec,
                                  void* stream) {
  Args a;
  if (!plan_args(a, x, w, part, out, N, H, W, C, Cout, bn, ranges))
    return (int)cudaErrorInvalidValue;
  return (int)launch_any<Epi::kNone>(a, bn, vec,
                                     static_cast<cudaStream_t>(stream));
}

// conv_stats: z = out as mxt_conv3x3_tc_f32 computes it, plus tstats
// (ceil(N*H*W / 128), 2, Cout) fp32 scratch (a row of per-tile sums) and
// stats (2, Cout): sum(z) then sum(z^2) per channel.  The plan comes from
// mxt_conv_stats_tc_blocks_per_sm.
extern "C" int mxt_conv_stats_tc_f32(const void* x, const void* w,
                                     void* part, void* z, void* tstats,
                                     void* stats, int N, int H, int W,
                                     int C, int Cout, int bn, int ranges,
                                     int vec, void* stream) {
  return conv_stats_any<float>(x, w, part, z, tstats, stats, N, H, W, C,
                               Cout, bn, ranges, vec, stream);
}

// conv_affine: out = act(z * scale + shift (+ res)) with z as
// mxt_conv3x3_tc_f32 computes it and the BatchNorm folded from gamma,
// beta, mean, var (Cout,) fp32 and eps; res (N, H, W, Cout) fp32 or null;
// relu != 0 applies the ReLU.  The plan comes from
// mxt_conv_affine_tc_blocks_per_sm; vec != 0 also needs a 16-byte
// aligned res.
extern "C" int mxt_conv_affine_f32(const void* x, const void* w,
                                   const void* gamma, const void* beta,
                                   const void* mean, const void* var,
                                   const void* res, void* part, void* out,
                                   int N, int H, int W, int C, int Cout,
                                   float eps, int relu, int bn, int ranges,
                                   int vec, void* stream) {
  Args a;
  if (!plan_args(a, x, w, part, out, N, H, W, C, Cout, bn, ranges))
    return (int)cudaErrorInvalidValue;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.mean = static_cast<const float*>(mean);
  a.var = static_cast<const float*>(var);
  a.res = static_cast<const float*>(res);
  a.eps = eps;
  a.relu = relu;
  return (int)launch_any<Epi::kAffine>(a, bn, vec,
                                       static_cast<cudaStream_t>(stream));
}

// Blocks of conv_affine_bf16_kernel<bn, vec> that fit an SM of the current
// device, into *out.
extern "C" int mxt_conv_affine_bf16_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<Epi::kAffine, bf16>(bn, vec, out);
}

namespace {

// conv_affine on the half type T (bf16, fp16)
template <typename T>
int conv_affine_half(const void* x, const void* w, const void* gamma,
                     const void* beta, const void* mean, const void* var,
                     const void* res, void* part, void* out, int N, int H,
                     int W, int C, int Cout, float eps, int relu, int vf32,
                     int bn, int ranges, int vec, void* stream) {
  ArgsT<T> a;
  if (!plan_args(a, x, w, part, out, N, H, W, C, Cout, bn, ranges) ||
      vf32 < 0 || vf32 > 15)
    return (int)cudaErrorInvalidValue;
  a.gamma = static_cast<const T*>(gamma);
  a.beta = static_cast<const T*>(beta);
  a.mean = static_cast<const T*>(mean);
  a.var = static_cast<const T*>(var);
  a.res = static_cast<const T*>(res);
  a.eps = eps;
  a.relu = relu;
  a.vf32 = vf32;
  return (int)launch_any<Epi::kAffine, T>(a, bn, vec,
                                          static_cast<cudaStream_t>(stream));
}

}  // namespace

// conv_affine on bf16: x, w, res (or null) and out bf16, the four
// BatchNorm vectors bf16 or, where their bit of vf32 is set (1 gamma, 2
// beta, 4 mean, 8 var), fp32; everything else as mxt_conv_affine_f32.
// The products are exact bf16 products summed in fp32 (mma.sync
// m16n8k16), the BatchNorm folded in fp32, the residual widened to fp32,
// and each output rounded once to bf16.  vec != 0: C % 8 == 0, Cout % 8
// == 0 and 16-byte aligned x, w, res and out.  The plan comes from
// mxt_conv_affine_bf16_blocks_per_sm.
extern "C" int mxt_conv_affine_bf16(const void* x, const void* w,
                                    const void* gamma, const void* beta,
                                    const void* mean, const void* var,
                                    const void* res, void* part, void* out,
                                    int N, int H, int W, int C, int Cout,
                                    float eps, int relu, int vf32, int bn,
                                    int ranges, int vec, void* stream) {
  return conv_affine_half<bf16>(x, w, gamma, beta, mean, var, res, part,
                                out, N, H, W, C, Cout, eps, relu, vf32, bn,
                                ranges, vec, stream);
}

// Blocks of conv3x3_bf16_kernel<bn, vec> that fit an SM of the current
// device, into *out.
extern "C" int mxt_conv3x3_bf16_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<Epi::kNone, bf16>(bn, vec, out);
}

// The same for conv_stats_bf16_kernel<bn, vec>.
extern "C" int mxt_conv_stats_bf16_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<Epi::kStats, bf16>(bn, vec, out);
}

// conv3x3 on bf16: x, w and out bf16, everything else as
// mxt_conv3x3_tc_f32; each output is the fp32 sum of exact bf16 products
// rounded once to bf16 (also the dgrad, on the rotated bf16 weight).  vec
// != 0: C % 8 == 0, Cout % 8 == 0 and 16-byte aligned x, w, out.  The plan
// comes from mxt_conv3x3_bf16_blocks_per_sm.
extern "C" int mxt_conv3x3_tc_bf16(const void* x, const void* w, void* part,
                                   void* out, int N, int H, int W, int C,
                                   int Cout, int bn, int ranges, int vec,
                                   void* stream) {
  ArgsT<bf16> a;
  if (!plan_args(a, x, w, part, out, N, H, W, C, Cout, bn, ranges))
    return (int)cudaErrorInvalidValue;
  return (int)launch_any<Epi::kNone, bf16>(a, bn, vec,
                                           static_cast<cudaStream_t>(stream));
}

// conv_stats on bf16: x, w and z bf16; tstats and stats fp32, the sums of
// the fp32 accumulator before z is rounded (as _conv_stats_kernel sums
// its f32 MXU accumulator).  vec as mxt_conv3x3_tc_bf16; the plan comes
// from mxt_conv_stats_bf16_blocks_per_sm.
extern "C" int mxt_conv_stats_tc_bf16(const void* x, const void* w,
                                      void* part, void* z, void* tstats,
                                      void* stats, int N, int H, int W,
                                      int C, int Cout, int bn, int ranges,
                                      int vec, void* stream) {
  return conv_stats_any<bf16>(x, w, part, z, tstats, stats, N, H, W, C,
                              Cout, bn, ranges, vec, stream);
}

// The fp16 instances: the entries of the bf16 ones above on fp16 x, w,
// res, out (z) and BatchNorm vectors (each fp16 or, by vf32, fp32), each
// product one mma.sync m16n8k16 f16 product, exact in fp32; each output
// rounded once to fp16 (to nearest even, +-inf past 65504).
extern "C" int mxt_conv_affine_f16_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<Epi::kAffine, f16>(bn, vec, out);
}

extern "C" int mxt_conv_affine_f16(const void* x, const void* w,
                                   const void* gamma, const void* beta,
                                   const void* mean, const void* var,
                                   const void* res, void* part, void* out,
                                   int N, int H, int W, int C, int Cout,
                                   float eps, int relu, int vf32, int bn,
                                   int ranges, int vec, void* stream) {
  return conv_affine_half<f16>(x, w, gamma, beta, mean, var, res, part, out,
                               N, H, W, C, Cout, eps, relu, vf32, bn, ranges,
                               vec, stream);
}

extern "C" int mxt_conv3x3_f16_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<Epi::kNone, f16>(bn, vec, out);
}

extern "C" int mxt_conv_stats_f16_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<Epi::kStats, f16>(bn, vec, out);
}

extern "C" int mxt_conv3x3_tc_f16(const void* x, const void* w, void* part,
                                  void* out, int N, int H, int W, int C,
                                  int Cout, int bn, int ranges, int vec,
                                  void* stream) {
  ArgsT<f16> a;
  if (!plan_args(a, x, w, part, out, N, H, W, C, Cout, bn, ranges))
    return (int)cudaErrorInvalidValue;
  return (int)launch_any<Epi::kNone, f16>(a, bn, vec,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" int mxt_conv_stats_tc_f16(const void* x, const void* w,
                                     void* part, void* z, void* tstats,
                                     void* stats, int N, int H, int W,
                                     int C, int Cout, int bn, int ranges,
                                     int vec, void* stream) {
  return conv_stats_any<f16>(x, w, part, z, tstats, stats, N, H, W, C,
                             Cout, bn, ranges, vec, stream);
}
