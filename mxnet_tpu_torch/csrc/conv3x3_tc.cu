// The 3x3/s1/p1 convolution, fp32 in and out, on Hopper's tensor cores in
// 3xTF32, with no epilogue (conv3x3) or with the per-channel batch
// statistics read off the accumulator (conv_stats):
//
//   out[m][co] = sum over k of patches[m][k] * w[k][co]
//   stats[0][co] = sum over m of out[m][co], stats[1][co] = ... out^2
//
// m runs over the N*H*W output pixels, k = tap*C + c tap-major, x (N, H,
// W, C) NHWC with a zero halo, w (3, 3, C, Cout) HWIO read as the
// row-major (9C, Cout) matrix, out (N, H, W, Cout).  With the weight
// rotated 180 degrees and IO-transposed it is the data gradient (dgrad).
//
// Replaces: mxnet_tpu/ops/pallas_block.py `_conv_kernel` (:318, launched
// by `conv3x3` :419 and `conv3x3_dgrad` :438): the dx of the backward of
// `residual_block_fused` (16 launches a ResNet-50 v1 training step) and
// the frozen backward's recompute of z; and `_conv_stats_kernel` (:343,
// `pallas_call` at :496): the training forward's z and its sums (16
// launches a step).
//
// Bounds on an H100, at batch 64 of any ResNet-50 stage: 2 * N*H*W * 9C *
// Cout = 14.8 GFLOP, 0.2209 ms at the 67 TFLOP/s fp32 CUDA-core peak.  This
// kernel does three TF32 products for each fp32 one: 44.4 GFLOP, 0.0897 ms
// at the 495 TFLOP/s dense TF32 tensor-core peak (0.137 ms at the 323.8
// TFLOP/s `mma.sync` TF32 ceiling measured on the card).  Bytes (x and w
// read once, out written once): 103 MB at 56x56x64 (0.031 ms at 3.35
// TB/s), 22 MB at 7x7x512 (0.007 ms); the statistics add 8 * Cout bytes.
// Operations bound it at every stage.
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
//   occupancy API) ranges of whole chunks, one a block.  A segment that
//   covers a whole tile writes it to out; a cut one writes its partial
//   tile to a slot of its range (the first segment of range b to slot 2b,
//   the last to 2b + 1), and a second kernel sums a cut tile's slots in
//   range order (no float atomics), so out is bitwise the same from run
//   to run.  At 7x7x512 (100 tiles of 128 x 128) the grid is one full
//   wave where 100 whole tiles would leave 32 SMs idle; at 56x56 and
//   28x28 only ~ranges tiles are cut, ~17 MB of partials.
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
//   each column in a fixed order (0.8 MB at 56x56x64).  The plan comes
//   from the STATS instance's own occupancy.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

extern __shared__ __align__(16) unsigned char mxt_conv3x3_smem[];

namespace {

using namespace mxt_tf32;

constexpr int BM = 128;        // output pixels a tile
constexpr int BK = 32;         // patch columns (k) a chunk
constexpr int STAGES = 4;
constexpr int kThreads = 256;  // 8 warps: 4 along pixels x 2 along co
constexpr int LDA = BK + 4;    // ring row strides in floats

template <int BN>
struct Ring {
  float a[STAGES][BM][LDA];      // patches: pixel rows, k contiguous
  float b[STAGES][BK][BN + 8];   // weight: k rows, channels contiguous
};

struct Args {
  const float* x;       // (N, H, W, C)
  const float* w;       // (9C, Cout)
  float* out;           // (N*H*W, Cout)
  float* part;          // (2 * ranges, BM, BN) partial tiles
  float* tstats;        // conv_stats: (ceil(M / BM), 2, Cout) tile sums
  long long nch;        // chunks a tile: ceil(K / BK)
  long long total;      // tiles * nch units of work
  int M;                // N*H*W
  int H, W, C, Cout, K; // K = 9*C
  int tiles_n;          // tiles along Cout
  int ranges;           // blocks: the work is cut into this many ranges
};

// The range of block b is units [b*total/ranges, (b+1)*total/ranges);
// unit u lies in range ((u+1)*ranges - 1) / total.
__device__ __forceinline__ long long range_start(const Args& a,
                                                 long long b) {
  return b * a.total / a.ranges;
}

__device__ __forceinline__ long long range_of(const Args& a, long long u) {
  return ((u + 1) * a.ranges - 1) / a.total;
}

// One thread's share of filling a ring stage with one chunk.  A: piece q
// (k = kc + 4q .. +3) of pixel rows r0 + 32i, i < 4.  B: piece nb
// (channels n0 + 4nb .. +3) of k rows rb + BSTEP*i.  VEC: C % 4 == 0 and
// Cout % 4 == 0 (a piece lies in one tap and is wholly in or out), 16-byte
// aligned bases: one 16-byte copy a piece; otherwise four 4-byte copies,
// each with its own tap.
template <int BN, bool VEC>
struct Loader {
  static constexpr int NE = VEC ? 1 : 4;       // taps held a piece
  static constexpr int AROWS = BM * 8 / kThreads;
  static constexpr int BSTEP = kThreads / (BN / 4);
  static constexpr int BROWS = BK / BSTEP;
  const Args& a;
  int q, r0, nb, rb;
  int n;                // B's first channel of the piece
  int kc;               // first k of the next chunk to copy
  int p[AROWS];         // pixel of row r0 + 32i
  int h[AROWS], w[AROWS];
  int th[NE], tw[NE], c[NE];   // tap (row, column) and channel of k + e

  __device__ __forceinline__ Loader(const Args& args, int m0, int n0,
                                    int kbeg)
      : a(args), kc(kbeg) {
    q = threadIdx.x & 7;
    r0 = threadIdx.x >> 3;
    nb = threadIdx.x % (BN / 4);
    rb = threadIdx.x / (BN / 4);
    n = n0 + 4 * nb;
#pragma unroll
    for (int i = 0; i < AROWS; ++i) {
      p[i] = m0 + r0 + 32 * i;
      w[i] = p[i] % a.W;
      // a pixel past the range gets an h no tap can bring into [0, H)
      h[i] = p[i] < a.M ? (p[i] / a.W) % a.H : -4;
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int k = kbeg + 4 * q + e;
      const int tap = k / a.C;
      c[e] = k - tap * a.C;
      th[e] = tap / 3;   // 3 or more: k past 9C, zero-filled
      tw[e] = tap % 3;
    }
  }

  // copy the chunk at kc into stage st and step to the next one
  __device__ __forceinline__ void load(Ring<BN>& s, int st) {
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const long long off =
          ((long long)(th[e] - 1) * a.W + (tw[e] - 1)) * a.C + c[e];
#pragma unroll
      for (int i = 0; i < AROWS; ++i) {
        const int ih = h[i] + th[e] - 1, iw = w[i] + tw[e] - 1;
        const bool ok = th[e] < 3 && (unsigned)ih < (unsigned)a.H &&
                        (unsigned)iw < (unsigned)a.W;
        const float* src = ok ? a.x + (long long)p[i] * a.C + off : a.x;
        float* dst = &s.a[st][r0 + 32 * i][4 * q + e];
        if constexpr (VEC)
          cp_async16(dst, src, ok);
        else
          cp_async4(dst, src, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < BROWS; ++i) {
      const int row = rb + BSTEP * i;
      const int k = kc + row;
      float* db = &s.b[st][row][4 * nb];
      const float* wrow = a.w + (long long)k * a.Cout;
      if constexpr (VEC) {
        const bool ok = k < a.K && n < a.Cout;
        cp_async16(db, ok ? wrow + n : a.w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k < a.K && n + e < a.Cout;
          cp_async4(db + e, ok ? wrow + n + e : a.w, ok);
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

// Sum and sum of squares of each of a whole tile's BN columns over its
// rows < M, from the fp32 accumulator, in a fixed order: each lane its
// four rows (mi, hf) in turn, an xor-shuffle over the 8 row groups g,
// then the 4 pixel-warps wm in order through shared memory (the ring,
// free once every warp has read its last chunk).  Writes the tile's row
// m0 / BM of tstats for its columns n0 ..
template <int BN>
__device__ __forceinline__ void tile_stats(const Args& a,
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

// The body of both kernels: the segments of range blockIdx.x, each into
// out (a whole tile) or a slot (a cut one).  STATS: a whole tile also
// writes its row of per-tile sums.
template <int BN, bool VEC, bool STATS>
__device__ __forceinline__ void conv_ranges(const Args& a) {
  Ring<BN>& s = *reinterpret_cast<Ring<BN>*>(mxt_conv3x3_smem);
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

    Loader<BN, VEC> ld(a, m0, n0, c0 * BK);
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

    // a whole tile goes to out; a cut one to its range's first (2b) or
    // last (2b + 1) slot
    const bool whole = c0 == 0 && nk == a.nch;
    float* p = whole ? a.out
                     : a.part + (2 * b + (u == u0 ? 0 : 1)) *
                                    (long long)(BM * BN);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = wm * 32 + mi * 16 + g + 8 * hf;
          const int cl = wn * (BN / 2) + ni * 8 + 2 * t;
          const float v0 = acc[mi][ni][2 * hf], v1 = acc[mi][ni][2 * hf + 1];
          if (!whole) {
            *reinterpret_cast<float2*>(p + r * BN + cl) = make_float2(v0, v1);
            continue;
          }
          const int m = m0 + r, nn = n0 + cl;
          if (m >= a.M) continue;
          float* o = p + (long long)m * a.Cout + nn;
          if constexpr (VEC) {
            if (nn < a.Cout)
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            if (nn < a.Cout) o[0] = v0;
            if (nn + 1 < a.Cout) o[1] = v1;
          }
        }
    if constexpr (STATS) {
      if (whole) tile_stats<BN>(a, acc, m0, n0, wm, wn, g, t);
    }
    u = send;
  }
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv3x3_tc_kernel(const Args a) {
  conv_ranges<BN, VEC, false>(a);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_stats_tc_kernel(const Args a) {
  conv_ranges<BN, VEC, true>(a);
}

// The tile cut at the start of range r >= 1 if that is the first range
// start inside it, else -1.
__device__ __forceinline__ long long cut_tile(const Args& a, long long r) {
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

// The tile cut at the start of range blockIdx.y + 1, if that range owns
// it (cut_tile): its slots summed, 4 values a thread.
template <int BN, bool VEC>
__global__ void __launch_bounds__(256)
conv3x3_reduce_kernel(const Args a) {
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
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long q = r - 1; q <= last; ++q) {
    // range q's segment in the tile is its first one iff q starts in it
    const long long slot = 2 * q + (range_start(a, q) >= t0 ? 0 : 1);
    const float4 v = *reinterpret_cast<const float4*>(
        a.part + slot * (long long)(BM * BN) + e);
    if (q == r - 1) {
      sum = v;
    } else {
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
  }
  store4<VEC>(a, m, n, sum);
}

// conv_stats' cut tiles: block blockIdx.x finds the tile cut at the start
// of range blockIdx.x + 1 (cut_tile), sums its slots in range order as
// conv3x3_reduce_kernel does (a slot at a time, each thread its RPT rows
// of one 4-column piece), writes z, and sums each column's finished
// values over the rows < M in a fixed order (a thread its rows rg, rg +
// RG, ... in turn, then the RG row groups in order through shared
// memory) into the tile's row of tstats.
template <int BN, bool VEC>
__global__ void __launch_bounds__(1024)
conv_stats_cut_kernel(const Args a) {
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
  float4 v[RPT];
  for (long long q = r - 1; q <= last; ++q) {
    // range q's segment in the tile is its first one iff q starts in it
    const long long slot = 2 * q + (range_start(a, q) >= t0 ? 0 : 1);
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

template <int BN, bool VEC, bool STATS>
cudaError_t prepare(int* per_sm) {
  const int bytes = (int)sizeof(Ring<BN>);
  const auto kernel = STATS ? conv_stats_tc_kernel<BN, VEC>
                            : conv3x3_tc_kernel<BN, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess || !per_sm) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, bytes);
}

template <bool STATS>
cudaError_t prepare_any(int bn, int vec, int* per_sm) {
  if (bn == 64) return vec ? prepare<64, true, STATS>(per_sm)
                           : prepare<64, false, STATS>(per_sm);
  return vec ? prepare<128, true, STATS>(per_sm)
             : prepare<128, false, STATS>(per_sm);
}

template <int BN, bool VEC>
void launch(const Args& a, cudaStream_t s) {
  conv3x3_tc_kernel<BN, VEC>
      <<<(unsigned)a.ranges, kThreads, sizeof(Ring<BN>), s>>>(a);
  if (a.ranges > 1) {
    const dim3 grid(BM * BN / 4 / 256, (unsigned)(a.ranges - 1));
    conv3x3_reduce_kernel<BN, VEC><<<grid, 256, 0, s>>>(a);
  }
}

template <int BN, bool VEC>
void launch_stats(const Args& a, cudaStream_t s) {
  conv_stats_tc_kernel<BN, VEC>
      <<<(unsigned)a.ranges, kThreads, sizeof(Ring<BN>), s>>>(a);
  if (a.ranges > 1)
    conv_stats_cut_kernel<BN, VEC>
        <<<(unsigned)(a.ranges - 1), 1024, 0, s>>>(a);
}

// Fill a (the plan's geometry) or return false for shapes the kernels do
// not take.
bool plan_args(Args& a, const void* x, const void* w, void* part, void* out,
               int N, int H, int W, int C, int Cout, int bn, int ranges) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || ranges <= 0 ||
      (bn != 64 && bn != 128) || 9LL * C > 0x7fffffffLL ||
      (long long)N * H * W + BM > 0x7fffffffLL)
    return false;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.tstats = nullptr;
  a.M = N * H * W;
  a.H = H; a.W = W; a.C = C; a.Cout = Cout; a.K = 9 * C;
  a.tiles_n = (Cout + bn - 1) / bn;
  const long long tiles = (long long)((a.M + BM - 1) / BM) * a.tiles_n;
  a.nch = (a.K + BK - 1) / BK;
  a.total = tiles * a.nch;
  a.ranges = ranges;
  return ranges <= a.total && ranges <= 65536;
}

}  // namespace

// Blocks of conv3x3_tc_kernel<bn, vec> that fit an SM of the current
// device, into *out (the host cuts the work into 132 x this many ranges).
extern "C" int mxt_conv3x3_tc_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<false>(bn, vec, out);
}

// The same for conv_stats_tc_kernel<bn, vec>.
extern "C" int mxt_conv_stats_tc_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<true>(bn, vec, out);
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
  cudaError_t err = prepare_any<false>(bn, vec, nullptr);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) {
    if (vec) launch<64, true>(a, s); else launch<64, false>(a, s);
  } else {
    if (vec) launch<128, true>(a, s); else launch<128, false>(a, s);
  }
  return (int)cudaGetLastError();
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
  Args a;
  if (!plan_args(a, x, w, part, z, N, H, W, C, Cout, bn, ranges))
    return (int)cudaErrorInvalidValue;
  a.tstats = static_cast<float*>(tstats);
  cudaError_t err = prepare_any<true>(bn, vec, nullptr);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) {
    if (vec) launch_stats<64, true>(a, s); else launch_stats<64, false>(a, s);
  } else {
    if (vec) launch_stats<128, true>(a, s);
    else launch_stats<128, false>(a, s);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = (a.M + BM - 1) / BM, cols = 2 * Cout;
  conv_stats_sum_kernel<<<(unsigned)((cols + 31) / 32), dim3(32, 32), 0,
                          s>>>(a.tstats, static_cast<float*>(stats), rows,
                               cols);
  return (int)cudaGetLastError();
}
