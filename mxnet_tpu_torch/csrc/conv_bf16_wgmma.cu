// The bf16 and fp16 instances (this file holds both half types; its name
// is the first one's) of the 3x3/s1/p1 convolution (conv3x3, also as the
// dgrad), of the same conv with a statistics epilogue (conv_stats) or a
// folded frozen BatchNorm epilogue (conv_affine), and of its weight
// gradient (conv_wgrad) for Hopper: wgmma products on tiles that TMA
// copies into a ring of shared-memory stages:
//
//   conv3x3:     out[m][co] = z[m][co] = sum over k of patches[m][k] w[k][co]
//   conv_stats:  z, and sum over m of z[m][co] and of z[m][co]^2
//   conv_affine: out[m][co] = act(z[m][co] * scale[co] + shift[co]
//                                 (+ res[m][co]))
//   conv_wgrad:  dW[k][co]  = sum over m of patches[m][k] * dy[m][co]
//
// m runs over the N*H*W pixels, k = tap*C + c tap-major, x (N, H, W, C)
// NHWC with a zero halo, w (3, 3, C, Cout) HWIO = the row-major (9C, Cout)
// matrix, dy, z, res and out (N, H, W, Cout), dW (9C, Cout) fp32.  Half
// operands (bf16 or fp16), their products exact in fp32 (8 + 8 or 11 + 11
// significant bits), fp32 sums; conv3x3, conv_stats and conv_affine round
// each output once to the operands' type (the sums of conv_stats are of
// the fp32 values before that rounding; conv_affine's fold, residual and
// ReLU act on them in fp32), conv_wgrad writes fp32 (the caller casts dW
// to the weight's dtype).  The dgrad is conv3x3 of dy with the rotated
// weight.
//
// Replaces, on half operands with C % 8 == 0 and Cout % 8 == 0 and
// 16-byte aligned tensors: mxnet_tpu/ops/pallas_block.py `_conv_kernel` (:318,
// launched by `conv3x3` :419 and `conv3x3_dgrad` :438; 16 dgrads a bf16
// ResNet-50 v1 training step, 10 forwards a bf16 Inception-v3 forward),
// `_conv_stats_kernel` (:343, `_conv_stats` :488; 16 a bf16 ResNet-50
// step), `_conv_affine_kernel` (:325, `_conv_affine` :465 with `_fold`
// :539; 16 a bf16 ResNet-50 serving forward) and `_wgrad_kernel` (:381,
// launched by `conv3x3_wgrad` :444; 16 a step), each the same in an fp16
// step (`FusedTrainStep(dtype="float16")`) and under `amp.init("float16")`.
// Other half shapes keep the mma.sync instances of conv3x3_tc.cu and
// conv_wgrad.cu.
//
// fp16 against bf16: one traits type (BF16, F16) carries the storage and
// pair types, the product's `.bf16.bf16` / `.f16.f16`, the tensor maps'
// BFLOAT16 / FLOAT16 and the conversions; the ring, the descriptors, the
// swizzle, the runs and the plans are one code.  fp16's range ends at
// 65504: each output is rounded to nearest even from its fp32 value and
// overflows to +-inf there as the reference's cast does, while
// conv_stats' sums, taken before that rounding, stay finite.  Its
// subnormals (below 6.1e-5) are kept: the build has no --use_fast_math,
// so nothing in the fp32 epilogue flushes them.  conv_affine's four
// BatchNorm vectors are each the half type or fp32 (a bit each in the
// epilogue's parameter): a half step keeps its running statistics fp32.
//
// Bound on an H100 at batch 128 of a ResNet-50 stage: 2 * N*H*W * 9C * Cout
// = 29.6 GFLOP, 0.0299 ms at the 989 TFLOP/s dense bf16 peak; bytes (x and
// w or dy read once, out or dW written once) 103 MB at 56x56x64, 0.0307 ms
// at 3.35 TB/s (bytes bind, barely), 18-22 MB at 7x7x512 (operations bind).
//
// Design.
// - One block an SM of 288 threads: two consumer warpgroups, each the 64
//   rows of a 128-row tile in fp32 registers (BN/2 a thread), and one
//   producer warp whose first lane keeps TMA loads in flight into a ring
//   of 5 (BN 128) or 6 (BN 64) stages, each stage guarded by a `full`
//   mbarrier (the copies' bytes) and an `empty` one (one arrival from
//   each of the 8 consumer warps).  No thread computes an address for the
//   copies: the maps do.  The warpgroup index is read through a shuffle
//   and the barrier wait loops inside its asm, so the compiler sees every
//   wgmma on a warp-uniform path (otherwise ptxas serializes the products
//   and says so, C7518).
// - Products: `wgmma.mma_async.m64nNk16.f32.bf16.bf16` (or `.f16.f16`;
//   N = BN = 64 when
//   Cout <= 64, else 128) on 128-byte-swizzled tiles behind descriptors,
//   four 16-deep steps a 64-deep chunk.  conv3x3: A = patches K-major (a
//   pixel's 64 channels of one tap along a 128-byte row), B = the weight
//   MN-major (64 output channels along a row, k down the rows).
//   conv_wgrad: A = patches^T and B = dy, both MN-major (channels along a
//   row, pixels down the rows: NHWC as it lies), read through wgmma's
//   transpose bits, so no fragment is transposed by hand.
// - Copies: x in TMA im2col mode over (N, H, W, C) with the pad-1 window
//   (bounding-box corners -1, -1): one load a chunk and tap brings the
//   64-channel slab of 128 (conv3x3) or 64 (conv_wgrad) consecutive pixels
//   shifted by the tap, the out-of-image taps zero-filled, running over
//   image rows and images with no index math.  conv3x3's weight comes by a
//   3-D tiled map over (9, C, Cout) (boxes of 64 c x 64 co), conv_wgrad's
//   dy by a 2-D one over (N*H*W, Cout) (64 pixels x 64 co); channels and
//   pixels past the tensor arrive as zeros.  A chunk is one (tap, 64-channel
//   slab) for conv3x3 (9 * ceil(C / 64) a tile) and 64 pixels for
//   conv_wgrad, whose 128 tile rows are two slabs (k = tap*C + slab*64 +
//   i), one a warpgroup; a slab past 9 * ceil(C / 64) is neither loaded
//   nor multiplied.
// - A warpgroup issues a chunk's products before it waits for the
//   previous chunk's (`wgmma.wait_group 1`), then releases that chunk's
//   stage, so the tensor cores always hold the next products.
// - The tensor core truncates its fp32 sums: the products gather in a run
//   accumulator from zero (the run's first step's scale-d is 0), which is
//   waited for (`wgmma.wait_group 0`) and added to the tile's sums with
//   IEEE adds (`__fadd_rn`) every 8 chunks and at a segment's end: a run
//   is 512 k (conv3x3) or 512 pixels (conv_wgrad).  chip_smoke.py
//   (bf16_train_kernels, `parts`) holds dW at the four ResNet-50 stages
//   against the plain version with these runs and with one run a segment
//   (up to 15,000 pixels at 56x56); PERF.md has both errors.
// - Work split in one wave (stream-K, as the mma.sync instances): the
//   tiles x chunks units are cut into `ranges` = 132 x (blocks an SM, from
//   the occupancy entry) ranges, one a block; the producer and the
//   consumers walk the same units.  conv3x3, conv_stats, conv_affine: a
//   range's segment that covers a whole tile finishes it from the
//   registers; a cut tile's segments store fp32 slots (range b's first to
//   2b, its last to 2b + 1) that a second kernel sums in range order and
//   finishes (conv3x3_wgmma_reduce_kernel, conv_stats_wgmma_cut_kernel,
//   conv_affine_wgmma_reduce_kernel).  conv_wgrad: each segment stores its
//   partial tile to its slot and conv_wgrad_wgmma_reduce_kernel sums a
//   tile's slots in order.  No float atomics: a relaunch is bitwise equal.
// - The loop (`wgmma_ranges`) is one body for all four: the operation
//   picks the loads, the A descriptor and the epilogue, the half type the
//   product and the stores.
//   conv_stats, conv_affine and conv3x3 run the same loads, products and
//   runs, so where their plans agree conv_stats' z is conv3x3's bit for
//   bit.
// - STATS: a whole tile stores z and sums its fp32 values over its rows <
//   M in a fixed order (each thread its two rows, an xor-shuffle over a
//   warp's 8 row groups, then the 8 consumer warps in order through a
//   shared-memory region of its own: the producer is already filling the
//   ring for the next tile, so the ring cannot hold them, and the two
//   warpgroups meet at a named barrier of their 256 threads, never
//   __syncthreads) into the tile's row of tstats (ceil(M / 128), 2, Cout);
//   the cut kernel sums a cut tile's slots, stores z and writes its row
//   from the summed fp32 values; conv_stats_wgmma_sum_kernel adds the rows
//   in a fixed order into stats (2, Cout).
// - AFFINE: a whole tile folds each of its thread's column pairs inside
//   the store loop (scale = gamma * rsqrt(var + eps), shift = beta - mean
//   * scale, from the vectors widened, in fp32 with no fused
//   multiply-add, as the plain version rounds), applies it to the fp32
//   sums, adds the residual read as half pairs at the store's addresses,
//   the ReLU, and rounds once; the reduce kernel does the same to a cut
//   tile's summed slots.
// - Tensor maps are encoded on the host and kept in a small cache keyed by
//   every argument of the encoding (the encoding is a pure function of
//   them, so a hit is exact); a map is a 128-byte kernel parameter, which
//   a CUDA graph keeps by value.
//
// ptxas (sm_90a, CUDA 12.8, `-Xptxas -v`): conv3x3_wgmma_kernel 148
// registers at BN 128, 96 at BN 64; conv_wgrad_wgmma_kernel 139 and 96;
// conv_stats_wgmma_kernel 168 and 118; conv_affine_wgmma_kernel 168 and
// 114; no spills; the reduce kernels 58 (conv3x3, conv_affine) and 36,
// the STATS cut kernel 47 and 32, its sum kernel 32.  Shared memory a
// block (dynamic, with 1 KB to align the ring): 165,888 bytes at BN 128,
// 149,504 at BN 64 (conv_stats: 174,080 and 153,600, its sums after the
// ring); one block an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "wgmma_ring.cuh"

extern __shared__ __align__(1024) unsigned char mxt_wgmma_smem[];

namespace {

using namespace mxt_wgmma;

// The two half types the kernels take (every kernel below is an instance
// of one of them): the storage and pair types, the wgmma product's and
// the tensor maps' type names, the widening to fp32 and the pair's
// rounding from it (round to nearest even: fp16 overflows to +-inf past
// 65504 and keeps its subnormals, as a cast of the fp32 value does).
struct BF16 {
  using T = __nv_bfloat16;
  using T2 = __nv_bfloat162;
  static constexpr bool kF16 = false;
  static constexpr CUtensorMapDataType kMap =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static float wide(T v) { return __bfloat162float(v); }
  __device__ static float2 wide2(T2 v) { return __bfloat1622float2(v); }
  __device__ static T2 narrow2(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};

struct F16 {
  using T = __half;
  using T2 = __half2;
  static constexpr bool kF16 = true;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static float wide(T v) { return __half2float(v); }
  __device__ static float2 wide2(T2 v) { return __half22float2(v); }
  __device__ static T2 narrow2(float a, float b) {
    return __floats2half2_rn(a, b);
  }
};

constexpr int BM = 128;       // tile rows: conv3x3 pixels, wgrad patch rows
constexpr int SLAB = 64;      // channels a box: 128 bytes of halves
constexpr int BK = 64;        // a chunk: conv3x3 k, wgrad pixels
constexpr int kConsumers = 2;                    // warpgroups, 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int BOX = 64 * 64 * 2;                 // bytes of a 64 x 64 box

// kConv, kStats and kAffine are the conv with three epilogues; kWgrad dW
enum class Op { kConv, kStats, kAffine, kWgrad };

template <int BN>
constexpr int kStages = BN == 64 ? 6 : 5;
constexpr int kRun = 8;       // chunks a run: 512 k (conv3x3) or pixels

// One ring stage: A's two 64-row halves (conv3x3: pixels 0-63 and 64-127
// of the tile, one im2col box; wgrad: the tile's two slabs, pixel rows)
// and B's 64-column boxes (k or pixel rows), each 128-byte swizzled.
template <int BN>
struct alignas(1024) Stage {
  uint16_t a[2][64][64];        // 2-byte halves: bf16 or fp16
  uint16_t b[BN / 64][64][64];
};

template <int BN>
struct Smem {
  Stage<BN> st[kStages<BN>];
  uint64_t full[kStages<BN>];
  uint64_t empty[kStages<BN>];
};

// kStats' cross-warp sums, after the ring: [8 consumer warps][2][BN]
template <Op OP, int BN>
constexpr int red_bytes() {
  return OP == Op::kStats ? 4 * kConsumers * 2 * BN * (int)sizeof(float)
                          : 0;
}

template <Op OP, int BN>
constexpr int smem_bytes() {
  // + room to align the base
  return (int)sizeof(Smem<BN>) + red_bytes<OP, BN>() + 1024;
}

struct Geo {
  void* out;          // conv3x3, conv_stats (z), conv_affine: (N*H*W, Cout)
  float* part;        // conv: (2 * ranges, BM, BN); wgrad: (tiles, jmax,
                      // BM, BN)
  float* dw;          // wgrad: (9C, Cout)
  long long total;    // tiles * nch units of work
  int nch;            // chunks a tile
  int ranges;         // blocks: the work is cut into this many ranges
  int tiles_n;        // tiles along Cout
  int M, H, W, C, Cout;
  int cs;             // 64-channel slabs a tap: ceil(C / 64)
  int slabs;          // 9 * cs
  int jmax;           // wgrad: partial slots a tile
};

// The operands of the STATS and AFFINE epilogues: a kernel parameter of
// their own, so conv3x3's and conv_wgrad's kernels keep theirs.
struct Epi {
  float* tstats;      // conv_stats: (ceil(M / BM), 2, Cout)
  const void* gamma;  // conv_affine: the BatchNorm (Cout,) each, in x's
  const void* beta;   // half type or fp32 (the bits of vf32)
  const void* mean;
  const void* var;
  const void* res;    // conv_affine: (N*H*W, Cout) in x's type, or null
  float eps;
  int relu;
  int vf32;           // fp32 vectors: 1 gamma, 2 beta, 4 mean, 8 var
};

// Range b holds units [b*total/ranges, (b+1)*total/ranges); unit u lies in
// range ((u+1)*ranges - 1) / total.
__device__ __forceinline__ long long range_start(const Geo& g, long long b) {
  return b * g.total / g.ranges;
}

__device__ __forceinline__ long long range_of(const Geo& g, long long u) {
  return ((u + 1) * g.ranges - 1) / g.total;
}

// (n, h, w) of pixel p
__device__ __forceinline__ void pixel(const Geo& g, int p, int& n, int& h,
                                      int& w) {
  const int hw = g.H * g.W;
  n = p / hw;
  const int r = p - n * hw;
  h = r / g.W;
  w = r - h * g.W;
}

// Issue the copies of unit u (tile u / nch, chunk u % nch) into stage s.
template <Op OP, int BN>
__device__ __forceinline__ void load_unit(const Geo& g, const CUtensorMap* ta,
                                          const CUtensorMap* tb, Stage<BN>& s,
                                          uint64_t* full, long long u) {
  const long long tile = u / g.nch;
  const int c = (int)(u - tile * g.nch);
  const int tm = (int)(tile / g.tiles_n), tn = (int)(tile % g.tiles_n);
  int n, h, w;
  if constexpr (OP != Op::kWgrad) {
    const int tap = c / g.cs, c0 = (c - tap * g.cs) * SLAB;
    pixel(g, tm * BM, n, h, w);
    bar_expect(full, BOX * (2 + BN / 64));
    tma_im2col(&s.a[0][0][0], ta, full, c0, w - 1, h - 1, n,
               (uint16_t)(tap % 3), (uint16_t)(tap / 3));
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_3d(&s.b[j][0][0], tb, full, tn * BN + 64 * j, c0, tap);
  } else {
    const int p0 = c * BK;
    pixel(g, p0, n, h, w);
    const int halves = 2 * tm + 1 < g.slabs ? 2 : 1;
    bar_expect(full, BOX * (halves + BN / 64));
    for (int i = 0; i < halves; ++i) {
      const int sl = 2 * tm + i, tap = sl / g.cs;
      tma_im2col(&s.a[i][0][0], ta, full, (sl - tap * g.cs) * SLAB, w - 1,
                 h - 1, n, (uint16_t)(tap % 3), (uint16_t)(tap / 3));
    }
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_2d(&s.b[j][0][0], tb, full, tn * BN + 64 * j, p0);
  }
}

// The producer: lane 0 of the last warp walks the block's units, each into
// the next stage once the consumers have released it.
template <Op OP, int BN>
__device__ __forceinline__ void produce(const Geo& g, const CUtensorMap* ta,
                                        const CUtensorMap* tb, Smem<BN>& sm) {
  constexpr int S = kStages<BN>;
  tma_prefetch(ta);
  tma_prefetch(tb);
  const long long b = blockIdx.x;
  const long long u1 = range_start(g, b + 1);
  int st = 0;
  uint32_t ph = 0;
  for (long long u = range_start(g, b); u < u1; ++u) {
    bar_wait(&sm.empty[st], ph ^ 1);
    load_unit<OP, BN>(g, ta, tb, sm.st[st], &sm.full[st], u);
    if (++st == S) {
      st = 0;
      ph ^= 1;
    }
  }
}

// Issue this warpgroup's 64 x BN products of the chunk in stage s into
// run: four 16-deep steps, the first from zero when `fresh` (a new run).
template <typename H, Op OP, int BN>
__device__ __forceinline__ void mma_chunk(const Stage<BN>& s, int wg,
                                          bool fresh, float (&run)[BN / 2]) {
  const uint32_t a = smem_u32(&s.a[wg][0][0]);
  const uint32_t b = smem_u32(&s.b[0][0][0]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // conv3x3: A K-major, 32 bytes a step along the row; wgrad: A
    // MN-major, 16 pixel rows a step.  B MN-major, 16 rows a step, its
    // 64-column boxes BOX bytes apart.
    const uint64_t da = OP != Op::kWgrad
                            ? desc_sw128(a + 32 * kk, 16, 1024)
                            : desc_sw128(a + 2048 * kk, BOX, 1024);
    const uint64_t db = desc_sw128(b + 2048 * kk, BOX, 1024);
    mma<BN, OP == Op::kWgrad ? 1 : 0, 1, H::kF16>(run, da, db,
                                                  kk > 0 || !fresh);
  }
  wg_commit();
}

// Element n of a BatchNorm vector as fp32: read as fp32 where `f32`, else
// as H's half type widened.
template <typename H>
__device__ __forceinline__ float vec_at(const void* p, int f32, int n) {
  return f32 ? static_cast<const float*>(p)[n]
             : H::wide(static_cast<const typename H::T*>(p)[n]);
}

// The folded frozen BatchNorm of channel n from the vectors widened (each
// fp32 or in x's half type, as vf32 says: a half step keeps its running
// statistics fp32), in fp32 as the plain version rounds it (no fused
// multiply-add): scale = gamma * rsqrt(var + eps), shift = beta - mean *
// scale.
template <typename H>
__device__ __forceinline__ void fold(const Epi& e, int n, float& sc,
                                     float& sh) {
  sc = __fmul_rn(vec_at<H>(e.gamma, e.vf32 & 1, n),
                 rsqrtf(__fadd_rn(vec_at<H>(e.var, e.vf32 & 8, n), e.eps)));
  sh = __fsub_rn(vec_at<H>(e.beta, e.vf32 & 2, n),
                 __fmul_rn(vec_at<H>(e.mean, e.vf32 & 4, n), sc));
}

// act(v * sc + sh (+ r)) in fp32, each operation rounded on its own
__device__ __forceinline__ float affine(const Epi& e, float v, float sc,
                                        float sh, float r) {
  v = __fadd_rn(__fmul_rn(v, sc), sh);
  if (e.res) v = __fadd_rn(v, r);
  return e.relu ? (v > 0.f ? v : 0.f) : v;
}

// out[m][n], out[m][n + 1] of a whole tile from their fp32 values, through
// the folded BatchNorm (+ the residual pair at the same addresses) (+
// ReLU) for kAffine, rounded once to a pair of H's halves (Cout % 8 == 0:
// n < Cout implies n + 1 < Cout).
template <typename H, Op OP>
__device__ __forceinline__ void store2(const Geo& g, const Epi& e, int m,
                                       int n, float v0, float v1,
                                       const float (&sc)[2],
                                       const float (&sh)[2]) {
  using T2 = typename H::T2;
  const long long at = (long long)m * g.Cout + n;
  if constexpr (OP == Op::kAffine) {
    float2 r = make_float2(0.f, 0.f);
    if (e.res)
      r = H::wide2(*reinterpret_cast<const T2*>(
          static_cast<const typename H::T*>(e.res) + at));
    v0 = affine(e, v0, sc[0], sh[0], r.x);
    v1 = affine(e, v1, sc[1], sh[1], r.y);
  }
  *reinterpret_cast<T2*>(static_cast<typename H::T*>(g.out) + at) =
      H::narrow2(v0, v1);
}

// the two consumer warpgroups meet (named barrier 1 of their 256 threads;
// the producer warp never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(128 * kConsumers) : "memory");
}

// Sum and sum of squares of each of a whole tile's BN columns over its
// rows < M, from the fp32 accumulator, in a fixed order: each thread its
// two rows (r, r + 8), an xor-shuffle over the warp's 8 row groups, then
// the 8 consumer warps in order (warpgroup 0's four, then warpgroup 1's)
// through `red`.  Writes the tile's row of tstats for its columns < Cout.
// Both warpgroups call it for the same tiles; the second barrier keeps a
// warpgroup from writing `red` for its next tile before it has been read.
template <int BN>
__device__ __forceinline__ void tile_stats(const Geo& g, const Epi& e,
                                           long long tile, int wg,
                                           const float (&acc)[BN / 2],
                                           float* red) {
  const int t = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int warp = wg * 4 + (t >> 5);
  const int tm = (int)(tile / g.tiles_n), tn = (int)(tile % g.tiles_n);
  const int m = tm * BM + wg * 64 + (t >> 5) * 16 + (lane >> 2);
  const bool in0 = m < g.M, in1 = m + 8 < g.M;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float v0 = acc[4 * j + k], v1 = acc[4 * j + 2 + k];
      float s1 = 0.f, s2 = 0.f;
      if (in0) {
        s1 += v0;
        s2 = fmaf(v0, v0, s2);
      }
      if (in1) {
        s1 += v1;
        s2 = fmaf(v1, v1, s2);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (lane < 4) {
        const int col = 8 * j + 2 * lane + k;
        red[(warp * 2 + 0) * BN + col] = s1;
        red[(warp * 2 + 1) * BN + col] = s2;
      }
    }
  consumers_sync();
  if (threadIdx.x < 2 * BN) {
    const int which = threadIdx.x / BN, c = threadIdx.x % BN;
    float v = red[which * BN + c];
#pragma unroll
    for (int q = 1; q < 4 * kConsumers; ++q) v += red[(q * 2 + which) * BN + c];
    if (tn * BN + c < g.Cout)
      e.tstats[((long long)tm * 2 + which) * g.Cout + tn * BN + c] = v;
  }
  consumers_sync();
}

// A finished segment [us, ue) of tile `tile` out of this warpgroup's
// registers.  conv3x3, conv_stats, conv_affine: a whole tile goes out in
// H's half type (conv_affine through its epilogue; conv_stats also writes
// its row of per-tile sums), a cut one's rows < M to its range's slot;
// wgrad stores its partial tile to its slot.
template <typename H, Op OP, int BN>
__device__ __forceinline__ void store_segment(const Geo& g, const Epi& e,
                                              long long tile, long long us,
                                              long long ue, long long u0,
                                              int wg,
                                              const float (&acc)[BN / 2],
                                              float* red) {
  const int t = threadIdx.x & 127;
  const int r = wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);  // tile row
  const int cl = 2 * (t & 3);
  const long long b = blockIdx.x;
  const int tm = (int)(tile / g.tiles_n), tn = (int)(tile % g.tiles_n);
  if constexpr (OP != Op::kWgrad) {
    const long long t0 = tile * g.nch;
    const bool whole = us == t0 && ue == t0 + g.nch;
    float* slot = g.part + (2 * b + (us == u0 ? 0 : 1)) * (long long)(BM * BN);
    if constexpr (OP == Op::kAffine) {
      // column pairs outside, so each is folded once a tile
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + cl;
        const int nn = tn * BN + col;
        float sc[2] = {1.f, 1.f}, sh[2] = {0.f, 0.f};
        if (whole && nn < g.Cout) {
          fold<H>(e, nn, sc[0], sh[0]);
          fold<H>(e, nn + 1, sc[1], sh[1]);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r + 8 * hf;
          const int m = tm * BM + row;
          if (m >= g.M) continue;
          const float v0 = acc[4 * j + 2 * hf], v1 = acc[4 * j + 2 * hf + 1];
          if (whole) {
            if (nn < g.Cout) store2<H, OP>(g, e, m, nn, v0, v1, sc, sh);
          } else {
            *reinterpret_cast<float2*>(slot + row * BN + col) =
                make_float2(v0, v1);
          }
        }
      }
    } else {
      const float one[2] = {1.f, 1.f}, zero[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r + 8 * hf;
        const int m = tm * BM + row;
        if (m >= g.M) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float v0 = acc[4 * j + 2 * hf], v1 = acc[4 * j + 2 * hf + 1];
          const int col = 8 * j + cl;
          if (whole) {
            const int nn = tn * BN + col;
            if (nn < g.Cout) store2<H, OP>(g, e, m, nn, v0, v1, one, zero);
          } else {
            *reinterpret_cast<float2*>(slot + row * BN + col) =
                make_float2(v0, v1);
          }
        }
      }
    }
    if constexpr (OP == Op::kStats) {
      if (whole) tile_stats<BN>(g, e, tile, wg, acc, red);
    }
  } else {
    const long long j = b - range_of(g, tile * g.nch);
    float* p = g.part + (tile * g.jmax + j) * (long long)(BM * BN);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
        *reinterpret_cast<float2*>(p + (r + 8 * hf) * BN + 8 * jn + cl) =
            make_float2(acc[4 * jn + 2 * hf], acc[4 * jn + 2 * hf + 1]);
  }
}

// The consumers: warpgroup wg walks the block's units with the producer,
// one segment of a tile at a time.  A chunk's products are issued before
// the previous chunk's are waited for (its stage is released then), so
// the tensor cores always have the next products queued; every kRun
// chunks, and at the segment's end, the run is waited for and added to
// the tile's sums with IEEE adds.
template <typename H, Op OP, int BN>
__device__ __forceinline__ void consume(const Geo& g, const Epi& e,
                                        Smem<BN>& sm, int wg, float* red) {
  constexpr int S = kStages<BN>;
  const long long b = blockIdx.x;
  const long long u0 = range_start(g, b), u1 = range_start(g, b + 1);
  // one lane a warp releases a stage, once its warp's products are done
  const bool lane0 = (threadIdx.x & 31) == 0;
  int st = 0;
  uint32_t ph = 0;
  for (long long u = u0; u < u1;) {
    const long long tile = u / g.nch;
    const long long ue = u1 < (tile + 1) * g.nch ? u1 : (tile + 1) * g.nch;
    // warpgroup-uniform: a wgrad slab past the last is not multiplied
    const bool active =
        OP != Op::kWgrad || 2 * (int)(tile / g.tiles_n) + wg < g.slabs;
    float acc[BN / 2], run[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_regs(run);
    int in_run = 0, prev = -1;   // chunks in the run; stage in flight
    for (long long v = u; v < ue; ++v) {
      bar_wait(&sm.full[st], ph);
      if (active) {
        mma_chunk<H, OP, BN>(sm.st[st], wg, in_run == 0, run);
        wg_wait<1>();            // the previous chunk's products are done
        if (prev >= 0 && lane0) bar_arrive(&sm.empty[prev]);
        prev = st;
        if (++in_run == kRun || v + 1 == ue) {
          wg_wait<0>();
          fence_regs(run);
          if (lane0) bar_arrive(&sm.empty[prev]);
          prev = -1;
          in_run = 0;
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], run[i]);
        }
      } else if (lane0) {
        bar_arrive(&sm.empty[st]);
      }
      if (++st == S) {
        st = 0;
        ph ^= 1;
      }
    }
    if (active)
      store_segment<H, OP, BN>(g, e, tile, u, ue, u0, wg, acc, red);
    u = ue;
  }
}

template <typename H, Op OP, int BN>
__device__ __forceinline__ void wgmma_ranges(const CUtensorMap* ta,
                                             const CUtensorMap* tb,
                                             const Geo& g, const Epi& e) {
  constexpr int S = kStages<BN>;
  const uint32_t base = smem_u32(mxt_wgmma_smem);
  Smem<BN>& sm = *reinterpret_cast<Smem<BN>*>(
      mxt_wgmma_smem + ((1024 - (base & 1023)) & 1023));
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], 4 * kConsumers);
    }
    bar_fence_init();
  }
  __syncthreads();
  // the warpgroup, known warp-uniform to the compiler (a role picked by
  // threadIdx.x alone is a divergent path, and wgmma in one is serialized)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    if (threadIdx.x == 128 * kConsumers) produce<OP, BN>(g, ta, tb, sm);
  } else {
    // kStats' cross-warp sums sit after the ring (Smem is 1024-aligned)
    consume<H, OP, BN>(g, e, sm, wg, reinterpret_cast<float*>(&sm + 1));
  }
}

template <typename H, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, const Geo g) {
  wgmma_ranges<H, Op::kConv, BN>(&ta, &tb, g, Epi{});
}

template <typename H, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_stats_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, const Geo g,
                        const Epi e) {
  wgmma_ranges<H, Op::kStats, BN>(&ta, &tb, g, e);
}

template <typename H, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_affine_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb, const Geo g,
                         const Epi e) {
  wgmma_ranges<H, Op::kAffine, BN>(&ta, &tb, g, e);
}

template <typename H, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, const Geo g) {
  wgmma_ranges<H, Op::kWgrad, BN>(&ta, &tb, g, Epi{});
}

template <typename H, Op OP, int BN>
auto main_kernel() {
  if constexpr (OP == Op::kConv)
    return conv3x3_wgmma_kernel<H, BN>;
  else if constexpr (OP == Op::kStats)
    return conv_stats_wgmma_kernel<H, BN>;
  else if constexpr (OP == Op::kAffine)
    return conv_affine_wgmma_kernel<H, BN>;
  else
    return conv_wgrad_wgmma_kernel<H, BN>;
}

constexpr int SLOT_BATCH = 8;   // partial slots a reduce loads at once

// The tile cut at the start of range r >= 1 if that is the first range
// start inside it, else -1.
__device__ __forceinline__ long long cut_tile(const Geo& g, long long r) {
  const long long sr = range_start(g, r);
  if (sr % g.nch == 0) return -1;
  const long long tile = sr / g.nch;
  if (range_of(g, tile * g.nch) != r - 1) return -1;
  return tile;
}

// The cut tiles of conv3x3 (OP kConv) and conv_affine (kAffine): the tile
// cut at the start of range blockIdx.y + 1, if that range owns it, its
// slots summed in range order 4 values a thread (conv3x3_tc.cu's
// reduce_cut, on this kernel's slots), then for kAffine the four columns'
// folded BatchNorm, the residual and the ReLU, each value rounded once to
// H's half type.
template <typename H, Op OP, int BN>
__device__ __forceinline__ void reduce_cut(const Geo& g, const Epi& ep) {
  using T2 = typename H::T2;
  const long long r = (long long)blockIdx.y + 1;
  const long long tile = cut_tile(g, r);
  if (tile < 0) return;
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= BM * BN) return;
  const int m = (int)(tile / g.tiles_n) * BM + e / BN;
  const int n = (int)(tile % g.tiles_n) * BN + e % BN;
  if (m >= g.M || n >= g.Cout) return;
  const long long t0 = tile * g.nch;
  const long long last = range_of(g, t0 + g.nch - 1);
  // range r - 1's segment is its first iff it starts in the tile
  const long long first =
      2 * (r - 1) + (range_start(g, r - 1) >= t0 ? 0 : 1);
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long q0 = r - 1; q0 <= last; q0 += SLOT_BATCH) {
    float4 v[SLOT_BATCH];
#pragma unroll
    for (int i = 0; i < SLOT_BATCH; ++i) {
      const long long q = q0 + i;
      if (q > last) break;
      const long long slot = q == r - 1 ? first : 2 * q;
      v[i] = *reinterpret_cast<const float4*>(
          g.part + slot * (long long)(BM * BN) + e);
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
  const long long at = (long long)m * g.Cout + n;
  if constexpr (OP == Op::kAffine) {
    // Cout % 8 == 0: the four columns lie inside Cout, the residual's
    // four values are one 8-byte load
    float rv[4] = {0.f, 0.f, 0.f, 0.f};
    if (ep.res) {
      const uint2 q = *reinterpret_cast<const uint2*>(
          static_cast<const typename H::T*>(ep.res) + at);
      const float2 lo = H::wide2(*reinterpret_cast<const T2*>(&q.x));
      const float2 hi = H::wide2(*reinterpret_cast<const T2*>(&q.y));
      rv[0] = lo.x; rv[1] = lo.y; rv[2] = hi.x; rv[3] = hi.y;
    }
    float o[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sc, sh;
      fold<H>(ep, n + i, sc, sh);
      o[i] = affine(ep, o[i], sc, sh, rv[i]);
    }
    sum = make_float4(o[0], o[1], o[2], o[3]);
  }
  T2 h[2] = {H::narrow2(sum.x, sum.y), H::narrow2(sum.z, sum.w)};
  *reinterpret_cast<uint2*>(static_cast<typename H::T*>(g.out) + at) =
      *reinterpret_cast<const uint2*>(h);
}

template <typename H, int BN>
__global__ void __launch_bounds__(256)
conv3x3_wgmma_reduce_kernel(const Geo g) {
  reduce_cut<H, Op::kConv, BN>(g, Epi{});
}

template <typename H, int BN>
__global__ void __launch_bounds__(256)
conv_affine_wgmma_reduce_kernel(const Geo g, const Epi e) {
  reduce_cut<H, Op::kAffine, BN>(g, e);
}

// conv_stats' cut tiles (conv3x3_tc.cu's conv_stats_cut_kernel on this
// kernel's slots): block blockIdx.x finds the tile cut at the start of
// range blockIdx.x + 1 (cut_tile), sums its slots in range order as
// conv3x3_wgmma_reduce_kernel does (a slot at a time, each thread its RPT
// rows of one 4-column piece; the same order, so z is the same), stores
// z, and sums each column's fp32 values over the rows < M in a fixed order
// (a thread its rows rg, rg + RG, ... in turn, then the RG row groups in
// order through shared memory) into the tile's row of tstats.
template <typename H, int BN>
__global__ void __launch_bounds__(1024)
conv_stats_wgmma_cut_kernel(const Geo g, const Epi e) {
  using T2 = typename H::T2;
  constexpr int CQ = BN / 4;        // 4-column pieces of a row
  constexpr int RG = 1024 / CQ;     // row groups: 32 (BN 128), 64 (BN 64)
  constexpr int RPT = BM / RG;      // rows a thread: 4 or 2
  __shared__ float red[2][RG][BN];  // 32 KB
  const long long r = (long long)blockIdx.x + 1;
  const long long tile = cut_tile(g, r);
  if (tile < 0) return;
  const int cq = threadIdx.x % CQ, rg = threadIdx.x / CQ;
  const int m0 = (int)(tile / g.tiles_n) * BM;
  const int n0 = (int)(tile % g.tiles_n) * BN;
  const int n = n0 + 4 * cq;
  const long long t0 = tile * g.nch;
  const long long last = range_of(g, t0 + g.nch - 1);
  const long long first =
      2 * (r - 1) + (range_start(g, r - 1) >= t0 ? 0 : 1);
  float4 v[RPT];
  for (long long q = r - 1; q <= last; ++q) {
    const long long slot = q == r - 1 ? first : 2 * q;
    const float* ps = g.part + slot * (long long)(BM * BN) + 4 * cq;
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
    if (m >= g.M) continue;
    if (n < g.Cout) {
      T2 h[2] = {H::narrow2(v[i].x, v[i].y), H::narrow2(v[i].z, v[i].w)};
      *reinterpret_cast<uint2*>(static_cast<typename H::T*>(g.out) +
                                (long long)m * g.Cout + n) =
          *reinterpret_cast<const uint2*>(h);
    }
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
    if (n0 + c < g.Cout)
      e.tstats[((long long)(m0 / BM) * 2 + which) * g.Cout + n0 + c] = t;
  }
}

// stats[c] = sum over r < rows of tstats[r][c] (c < cols = 2 * Cout,
// a multiple of 16), in a fixed order: a block of SUM_COLS columns x
// SUM_ROWS row groups, thread (x, y) adding rows y, y + SUM_ROWS, ... of
// its column in turn (SUM_BATCH of them loaded before they are added),
// then a column's SUM_ROWS partials meeting in a fixed binary tree in
// shared memory.  (conv3x3_tc.cu's sum kernel gives a block 32 columns:
// 4 blocks in all at 56x56x64, on 4 of the card's SMs.)
constexpr int SUM_BATCH = 8, SUM_COLS = 8, SUM_ROWS = 128;

__global__ void __launch_bounds__(SUM_COLS * SUM_ROWS)
conv_stats_wgmma_sum_kernel(const float* __restrict__ tstats,
                            float* __restrict__ stats, int rows, int cols) {
  __shared__ float red[SUM_ROWS][SUM_COLS];
  const int x = threadIdx.x % SUM_COLS, y = threadIdx.x / SUM_COLS;
  const int c = blockIdx.x * SUM_COLS + x;
  float v = 0.f;
  for (int r0 = y; r0 < rows; r0 += SUM_ROWS * SUM_BATCH) {
    float t[SUM_BATCH];
#pragma unroll
    for (int i = 0; i < SUM_BATCH; ++i) {
      const int r = r0 + SUM_ROWS * i;
      t[i] = r < rows ? tstats[(long long)r * cols + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < SUM_BATCH; ++i)
      if (r0 + SUM_ROWS * i < rows) v += t[i];
  }
  red[y][x] = v;
  __syncthreads();
#pragma unroll
  for (int h = SUM_ROWS / 2; h > 0; h >>= 1) {
    if (y < h) red[y][x] += red[y + h][x];
    __syncthreads();
  }
  if (y == 0) stats[c] = red[0][x];
}

// dW of tile blockIdx.y: its slots summed in slot order, 4 values a
// thread, each tile row (slab 2 * tile_m + row / 64, channel row % 64 of
// it) to its k = tap*C + c.
template <int BN>
__global__ void __launch_bounds__(256)
conv_wgrad_wgmma_reduce_kernel(const Geo g) {
  const long long tile = blockIdx.y;
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= BM * BN) return;
  const int row = e / BN;
  const int sl = (int)(tile / g.tiles_n) * 2 + row / 64;
  const int n = (int)(tile % g.tiles_n) * BN + e % BN;
  if (sl >= g.slabs || n >= g.Cout) return;
  const int tap = sl / g.cs;
  const int c = (sl - tap * g.cs) * SLAB + row % 64;
  if (c >= g.C) return;
  const long long first = range_of(g, tile * g.nch);
  const int segs = (int)(range_of(g, (tile + 1) * g.nch - 1) - first + 1);
  const float* p = g.part + tile * g.jmax * (long long)(BM * BN) + e;
  float4 sum = *reinterpret_cast<const float4*>(p);
  for (int j = 1; j < segs; ++j) {
    const float4 v =
        *reinterpret_cast<const float4*>(p + j * (long long)(BM * BN));
    sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
  }
  *reinterpret_cast<float4*>(g.dw + ((long long)tap * g.C + c) * g.Cout + n) =
      sum;
}

// The main kernel's shared-memory attribute, set once on each of the
// first 64 devices (a bit each in `ready`), and, where per_sm is given, the
// blocks of it an SM holds.
template <typename H, Op OP, int BN>
cudaError_t prepare(int* per_sm) {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  const auto kernel = main_kernel<H, OP, BN>();
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<OP, BN>());
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  if (!per_sm) return cudaSuccess;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, kThreads, smem_bytes<OP, BN>());
}

template <typename H, Op OP>
cudaError_t prepare_any(int bn, int* per_sm) {
  return bn == 64 ? prepare<H, OP, 64>(per_sm) : prepare<H, OP, 128>(per_sm);
}

// An encoder's failure as the entry's return value: 10000 + its CUresult
// (cudaError_t values stay below 1000).
constexpr int kEncodeError = 10000;

// The encoded maps of recent calls, by every argument of their encoding
// that varies (the mode, the element type, the base pointer, the rank, the
// dims, an im2col box's pixels; the strides, the box and the rest follow
// from these), so a hit is exactly the map an encoding would give.
// Bounded (kMapSlots entries, replaced in turn) and under one mutex; the
// hits and misses are read by mxt_wgmma_map_cache_stats.
struct MapKey {
  int im2col;         // 1: x in im2col mode; 0: tiled
  int dtype;          // the CUtensorMapDataType: bf16 or fp16
  int rank;
  int pixels;         // im2col: pixels a box
  const void* ptr;
  cuuint64_t dims[4];  // innermost first, unused ones 0
};

bool same_key(const MapKey& a, const MapKey& b) {
  if (a.im2col != b.im2col || a.dtype != b.dtype || a.rank != b.rank ||
      a.pixels != b.pixels || a.ptr != b.ptr)
    return false;
  for (int i = 0; i < 4; ++i)
    if (a.dims[i] != b.dims[i]) return false;
  return true;
}

constexpr int kMapSlots = 64;

struct MapCache {
  std::mutex mu;
  MapKey key[kMapSlots];
  CUtensorMap map[kMapSlots];
  int used = 0, next = 0;
  long long hits = 0, misses = 0;
};

MapCache& map_cache() {
  static MapCache c;
  return c;
}

// *map for key k: the cached one, or encode(map) (0 or an error) kept
template <typename F>
int cached_map(CUtensorMap* map, const MapKey& k, F encode) {
  MapCache& c = map_cache();
  std::lock_guard<std::mutex> lock(c.mu);
  for (int i = 0; i < c.used; ++i)
    if (same_key(c.key[i], k)) {
      *map = c.map[i];
      ++c.hits;
      return 0;
    }
  const int err = encode(map);
  if (err) return err;
  ++c.misses;
  c.key[c.next] = k;
  c.map[c.next] = *map;
  if (c.used < kMapSlots) ++c.used;
  c.next = (c.next + 1) % kMapSlots;
  return 0;
}

// x (N, H, W, C) of 2-byte halves of type dt in im2col mode: `pixels`
// pixels x 64 channels a box, the pad-1 3x3 window (corners -1, -1 in H
// and W).
int encode_x(CUtensorMap* map, CUtensorMapDataType dt, const void* x, int N,
             int H, int W, int C, int pixels) {
  const MapKey k = {1, (int)dt, 4, pixels, x,
                    {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                     (cuuint64_t)N}};
  return cached_map(map, k, [&](CUtensorMap* m) {
    const Encoders& enc = encoders();
    if (enc.err != cudaSuccess) return (int)enc.err;
    const cuuint64_t strides[3] = {2ull * C, 2ull * C * W,
                                   2ull * C * W * H};
    const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult r = enc.im2col(
        m, dt, 4, const_cast<void*>(x),
        k.dims, strides, lower, upper, SLAB, (cuuint32_t)pixels, estr,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
  });
}

// A tensor of 2-byte halves of type dt, `rank` (2 or 3) dims (innermost
// first), in 64 x 64 boxes (the rest 1), 128-byte swizzled.
int encode_tiled(CUtensorMap* map, CUtensorMapDataType dt, const void* t,
                 int rank, const cuuint64_t* dims) {
  MapKey k = {0, (int)dt, rank, 0, t, {0, 0, 0, 0}};
  for (int i = 0; i < rank; ++i) k.dims[i] = dims[i];
  return cached_map(map, k, [&](CUtensorMap* m) {
    const Encoders& enc = encoders();
    if (enc.err != cudaSuccess) return (int)enc.err;
    cuuint64_t strides[2];
    cuuint64_t s = 2;
    for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
    const cuuint32_t box[3] = {64, 64, 1}, estr[3] = {1, 1, 1};
    const CUresult r = enc.tiled(
        m, dt, (cuuint32_t)rank,
        const_cast<void*>(t), dims, strides, box, estr,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
  });
}

// The geometry all the kernels share, or false for what they do not take:
// C % 8 == 0 and Cout % 8 == 0 (TMA's 16-byte strides), bn 64 or 128.
bool geometry(Geo& g, int N, int H, int W, int C, int Cout, int bn,
              int ranges) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || ranges <= 0 ||
      C % 8 || Cout % 8 || (bn != 64 && bn != 128) ||
      (long long)N * H * W + 2 * BM > 0x7fffffffLL || C > 65536)
    return false;
  g.out = nullptr;
  g.part = g.dw = nullptr;
  g.M = N * H * W;
  g.H = H; g.W = W; g.C = C; g.Cout = Cout;
  g.cs = (C + SLAB - 1) / SLAB;
  g.slabs = 9 * g.cs;
  g.tiles_n = (Cout + bn - 1) / bn;
  g.ranges = ranges;
  g.jmax = 0;
  return true;
}

// The conv kernels' plan (conv3x3, conv_stats, conv_affine): tiles of
// 128 pixels x bn channels, 9 * ceil(C / 64) chunks of one tap's slab
// each; false where `ranges` does not fit it.
bool conv_plan(Geo& g) {
  g.nch = g.slabs;
  const long long tiles = (long long)((g.M + BM - 1) / BM) * g.tiles_n;
  g.total = tiles * g.nch;
  return g.ranges <= g.total && g.ranges <= 65536;
}

// The conv kernels' maps: x by im2col boxes of 128 pixels, w as the 3-D
// (9, C, Cout) tensor, both of type dt.
int conv_maps(CUtensorMap* ta, CUtensorMap* tb, CUtensorMapDataType dt,
              const void* x, const void* w, int N, int H, int W, int C,
              int Cout) {
  const cuuint64_t wdims[3] = {(cuuint64_t)Cout, (cuuint64_t)C, 9};
  const int err = encode_x(ta, dt, x, N, H, W, C, BM);
  return err ? err : encode_tiled(tb, dt, w, 3, wdims);
}

// A conv kernel, then the one that finishes its cut tiles.
template <typename H, Op OP, int BN>
void launch_conv(const CUtensorMap& ta, const CUtensorMap& tb, const Geo& g,
                 const Epi& e, cudaStream_t s) {
  const auto kernel = main_kernel<H, OP, BN>();
  const unsigned smem = smem_bytes<OP, BN>();
  const dim3 rgrid(BM * BN / 4 / 256, (unsigned)(g.ranges - 1));
  if constexpr (OP == Op::kConv) {
    kernel<<<(unsigned)g.ranges, kThreads, smem, s>>>(ta, tb, g);
    if (g.ranges > 1)
      conv3x3_wgmma_reduce_kernel<H, BN><<<rgrid, 256, 0, s>>>(g);
  } else if constexpr (OP == Op::kStats) {
    kernel<<<(unsigned)g.ranges, kThreads, smem, s>>>(ta, tb, g, e);
    if (g.ranges > 1)
      conv_stats_wgmma_cut_kernel<H, BN>
          <<<(unsigned)(g.ranges - 1), 1024, 0, s>>>(g, e);
  } else {
    kernel<<<(unsigned)g.ranges, kThreads, smem, s>>>(ta, tb, g, e);
    if (g.ranges > 1)
      conv_affine_wgmma_reduce_kernel<H, BN><<<rgrid, 256, 0, s>>>(g, e);
  }
}

// The maps, the kernels' attributes, the launches: an encoder's or a
// launch's error, else 0.
template <typename H, Op OP>
int run_conv(const void* x, const void* w, const Geo& g, const Epi& e, int N,
             int bn, void* stream) {
  CUtensorMap ta, tb;
  int err = conv_maps(&ta, &tb, H::kMap, x, w, N, g.H, g.W, g.C, g.Cout);
  if (err) return err;
  err = (int)prepare_any<H, OP>(bn, nullptr);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    launch_conv<H, OP, 64>(ta, tb, g, e, s);
  else
    launch_conv<H, OP, 128>(ta, tb, g, e, s);
  return (int)cudaGetLastError();
}

// The four operations on half type H, behind the C entries below.
template <typename H>
int conv3x3_entry(const void* x, const void* w, void* part, void* out,
                  int N, int H_, int W, int C, int Cout, int bn, int ranges,
                  void* stream) {
  Geo g;
  if (!geometry(g, N, H_, W, C, Cout, bn, ranges) || !conv_plan(g))
    return (int)cudaErrorInvalidValue;
  g.out = out;
  g.part = static_cast<float*>(part);
  return run_conv<H, Op::kConv>(x, w, g, Epi{}, N, bn, stream);
}

template <typename H>
int conv_stats_entry(const void* x, const void* w, void* part, void* z,
                     void* tstats, void* stats, int N, int H_, int W, int C,
                     int Cout, int bn, int ranges, void* stream) {
  Geo g;
  if (!geometry(g, N, H_, W, C, Cout, bn, ranges) || !conv_plan(g))
    return (int)cudaErrorInvalidValue;
  g.out = z;
  g.part = static_cast<float*>(part);
  Epi e{};
  e.tstats = static_cast<float*>(tstats);
  const int err = run_conv<H, Op::kStats>(x, w, g, e, N, bn, stream);
  if (err) return err;
  const int rows = (g.M + BM - 1) / BM, cols = 2 * Cout;
  conv_stats_wgmma_sum_kernel<<<(unsigned)(cols / SUM_COLS),
                                SUM_COLS * SUM_ROWS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      e.tstats, static_cast<float*>(stats), rows, cols);
  return (int)cudaGetLastError();
}

template <typename H>
int conv_affine_entry(const void* x, const void* w, const void* gamma,
                      const void* beta, const void* mean, const void* var,
                      const void* res, void* part, void* out, int N, int H_,
                      int W, int C, int Cout, float eps, int relu, int vf32,
                      int bn, int ranges, void* stream) {
  Geo g;
  if (!geometry(g, N, H_, W, C, Cout, bn, ranges) || !conv_plan(g) ||
      vf32 < 0 || vf32 > 15)
    return (int)cudaErrorInvalidValue;
  g.out = out;
  g.part = static_cast<float*>(part);
  Epi e{};
  e.gamma = gamma;
  e.beta = beta;
  e.mean = mean;
  e.var = var;
  e.res = res;
  e.eps = eps;
  e.relu = relu;
  e.vf32 = vf32;
  return run_conv<H, Op::kAffine>(x, w, g, e, N, bn, stream);
}

template <typename H>
int conv_wgrad_entry(const void* x, const void* dy, void* part, void* dw,
                     int N, int H_, int W, int C, int Cout, int bn,
                     int ranges, int jmax, void* stream) {
  Geo g;
  if (!geometry(g, N, H_, W, C, Cout, bn, ranges) || jmax <= 0)
    return (int)cudaErrorInvalidValue;
  g.part = static_cast<float*>(part);
  g.dw = static_cast<float*>(dw);
  g.jmax = jmax;
  g.nch = (g.M + BK - 1) / BK;
  const long long tiles = (long long)((g.slabs + 1) / 2) * g.tiles_n;
  g.total = tiles * g.nch;
  if (tiles > 65535 || ranges > g.total) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  const cuuint64_t ddims[2] = {(cuuint64_t)Cout, (cuuint64_t)g.M};
  int err = encode_x(&ta, H::kMap, x, N, H_, W, C, BK);
  if (!err) err = encode_tiled(&tb, H::kMap, dy, 2, ddims);
  if (err) return err;
  err = (int)prepare_any<H, Op::kWgrad>(bn, nullptr);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 rgrid(BM * bn / 4 / 256, (unsigned)tiles);
  if (bn == 64) {
    conv_wgrad_wgmma_kernel<H, 64>
        <<<(unsigned)ranges, kThreads, smem_bytes<Op::kWgrad, 64>(), s>>>(
            ta, tb, g);
    conv_wgrad_wgmma_reduce_kernel<64><<<rgrid, 256, 0, s>>>(g);
  } else {
    conv_wgrad_wgmma_kernel<H, 128>
        <<<(unsigned)ranges, kThreads, smem_bytes<Op::kWgrad, 128>(), s>>>(
            ta, tb, g);
    conv_wgrad_wgmma_reduce_kernel<128><<<rgrid, 256, 0, s>>>(g);
  }
  return (int)cudaGetLastError();
}

// The blocks of an operation's main kernel on H that fit an SM.
template <typename H, Op OP>
int blocks_per_sm(int bn, int vec, int* out) {
  if ((bn != 64 && bn != 128) || vec != 1) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<H, OP>(bn, out);
}

}  // namespace

// Blocks of conv3x3_wgmma_kernel<BF16, bn> that fit an SM of the current
// device, into *out (the host cuts the work into 132 x this many ranges);
// vec must be 1 (the kernel takes only C % 8 == 0, Cout % 8 == 0, aligned
// tensors).  The same for the other operations, and with _f16 for the
// fp16 instances.
extern "C" int mxt_conv3x3_wgmma_blocks_per_sm(int bn, int vec, int* out) {
  return blocks_per_sm<BF16, Op::kConv>(bn, vec, out);
}

extern "C" int mxt_conv_wgrad_wgmma_blocks_per_sm(int bn, int vec,
                                                  int* out) {
  return blocks_per_sm<BF16, Op::kWgrad>(bn, vec, out);
}

extern "C" int mxt_conv_stats_wgmma_blocks_per_sm(int bn, int vec,
                                                  int* out) {
  return blocks_per_sm<BF16, Op::kStats>(bn, vec, out);
}

extern "C" int mxt_conv_affine_wgmma_blocks_per_sm(int bn, int vec,
                                                   int* out) {
  return blocks_per_sm<BF16, Op::kAffine>(bn, vec, out);
}

extern "C" int mxt_conv3x3_wgmma_f16_blocks_per_sm(int bn, int vec,
                                                   int* out) {
  return blocks_per_sm<F16, Op::kConv>(bn, vec, out);
}

extern "C" int mxt_conv_wgrad_wgmma_f16_blocks_per_sm(int bn, int vec,
                                                      int* out) {
  return blocks_per_sm<F16, Op::kWgrad>(bn, vec, out);
}

extern "C" int mxt_conv_stats_wgmma_f16_blocks_per_sm(int bn, int vec,
                                                      int* out) {
  return blocks_per_sm<F16, Op::kStats>(bn, vec, out);
}

extern "C" int mxt_conv_affine_wgmma_f16_blocks_per_sm(int bn, int vec,
                                                       int* out) {
  return blocks_per_sm<F16, Op::kAffine>(bn, vec, out);
}

// The tensor-map cache's hits, misses and entries since the library was
// loaded, into out[0 .. 2].
extern "C" int mxt_wgmma_map_cache_stats(long long* out) {
  MapCache& c = map_cache();
  std::lock_guard<std::mutex> lock(c.mu);
  out[0] = c.hits;
  out[1] = c.misses;
  out[2] = c.used;
  return 0;
}

// conv3x3 on bf16: x (N, H, W, C), w (3, 3, C, Cout), out (N, H, W, Cout),
// contiguous and 16-byte aligned, C % 8 == 0, Cout % 8 == 0; part (2 *
// ranges, 128, bn) fp32 scratch.  The ceil(N*H*W / 128) * ceil(Cout / bn)
// tiles x 9 * ceil(C / 64) chunks are cut into `ranges` ranges, one a
// block: the plan (bn, ranges) is the caller's (mxnet_tpu_torch/ops/
// conv_block.py conv3x3_splits, per_sm from
// mxt_conv3x3_wgmma_blocks_per_sm).  Returns cudaGetLastError() after the
// launches, or 10000 + the CUresult of a tensor-map encoder that failed.
// The _f16 entries take fp16 where these take bf16, with everything else
// the same (their plans from the _f16 occupancy entries).
extern "C" int mxt_conv3x3_wgmma_bf16(const void* x, const void* w,
                                      void* part, void* out, int N, int H,
                                      int W, int C, int Cout, int bn,
                                      int ranges, void* stream) {
  return conv3x3_entry<BF16>(x, w, part, out, N, H, W, C, Cout, bn, ranges,
                             stream);
}

extern "C" int mxt_conv3x3_wgmma_f16(const void* x, const void* w,
                                     void* part, void* out, int N, int H,
                                     int W, int C, int Cout, int bn,
                                     int ranges, void* stream) {
  return conv3x3_entry<F16>(x, w, part, out, N, H, W, C, Cout, bn, ranges,
                            stream);
}

// conv_stats on bf16: z as mxt_conv3x3_wgmma_bf16 computes out, plus
// tstats (ceil(N*H*W / 128), 2, Cout) fp32 scratch (a row of per-tile
// sums) and stats (2, Cout) fp32: sum(z) then sum(z^2) per channel, of
// the fp32 values before z is rounded (as _conv_stats_kernel sums its f32
// accumulator; on fp16 a z that overflows to inf still adds its finite
// fp32 value).  The plan comes from mxt_conv_stats_wgmma_blocks_per_sm.
extern "C" int mxt_conv_stats_wgmma_bf16(const void* x, const void* w,
                                         void* part, void* z, void* tstats,
                                         void* stats, int N, int H, int W,
                                         int C, int Cout, int bn, int ranges,
                                         void* stream) {
  return conv_stats_entry<BF16>(x, w, part, z, tstats, stats, N, H, W, C,
                                Cout, bn, ranges, stream);
}

extern "C" int mxt_conv_stats_wgmma_f16(const void* x, const void* w,
                                        void* part, void* z, void* tstats,
                                        void* stats, int N, int H, int W,
                                        int C, int Cout, int bn, int ranges,
                                        void* stream) {
  return conv_stats_entry<F16>(x, w, part, z, tstats, stats, N, H, W, C,
                               Cout, bn, ranges, stream);
}

// conv_affine on bf16: out = act(z * scale + shift (+ res)) with z as
// mxt_conv3x3_wgmma_bf16 computes it (before its rounding) and the
// BatchNorm folded in fp32 from gamma, beta, mean, var (Cout,) and eps,
// each vector bf16 or, where its bit of vf32 is set (1 gamma, 2 beta, 4
// mean, 8 var), fp32; res (N, H, W, Cout) bf16, 16-byte aligned, or null;
// relu != 0 applies the ReLU; one rounding to bf16.  The plan comes from
// mxt_conv_affine_wgmma_blocks_per_sm.
extern "C" int mxt_conv_affine_wgmma_bf16(
    const void* x, const void* w, const void* gamma, const void* beta,
    const void* mean, const void* var, const void* res, void* part,
    void* out, int N, int H, int W, int C, int Cout, float eps, int relu,
    int vf32, int bn, int ranges, void* stream) {
  return conv_affine_entry<BF16>(x, w, gamma, beta, mean, var, res, part,
                                 out, N, H, W, C, Cout, eps, relu, vf32, bn,
                                 ranges, stream);
}

extern "C" int mxt_conv_affine_wgmma_f16(
    const void* x, const void* w, const void* gamma, const void* beta,
    const void* mean, const void* var, const void* res, void* part,
    void* out, int N, int H, int W, int C, int Cout, float eps, int relu,
    int vf32, int bn, int ranges, void* stream) {
  return conv_affine_entry<F16>(x, w, gamma, beta, mean, var, res, part,
                                out, N, H, W, C, Cout, eps, relu, vf32, bn,
                                ranges, stream);
}

// conv_wgrad on bf16 x (N, H, W, C) and dy (N, H, W, Cout), dw (3, 3, C,
// Cout) fp32, contiguous and 16-byte aligned, C % 8 == 0, Cout % 8 == 0;
// part (tiles, jmax, 128, bn) fp32 scratch, tiles = ceil(9 * ceil(C / 64)
// / 2) * ceil(Cout / bn).  The tiles x ceil(N*H*W / 64) units are cut into
// `ranges` ranges, one a block; jmax must be at least the most ranges that
// touch one tile.  The plan (bn, ranges, jmax) is the caller's
// (conv_block.py wgrad_splits, per_sm from
// mxt_conv_wgrad_wgmma_blocks_per_sm).  Returns as mxt_conv3x3_wgmma_bf16.
extern "C" int mxt_conv_wgrad_wgmma_bf16(const void* x, const void* dy,
                                         void* part, void* dw, int N, int H,
                                         int W, int C, int Cout, int bn,
                                         int ranges, int jmax, void* stream) {
  return conv_wgrad_entry<BF16>(x, dy, part, dw, N, H, W, C, Cout, bn,
                                ranges, jmax, stream);
}

extern "C" int mxt_conv_wgrad_wgmma_f16(const void* x, const void* dy,
                                        void* part, void* dw, int N, int H,
                                        int W, int C, int Cout, int bn,
                                        int ranges, int jmax, void* stream) {
  return conv_wgrad_entry<F16>(x, dy, part, dw, N, H, W, C, Cout, bn,
                               ranges, jmax, stream);
}
