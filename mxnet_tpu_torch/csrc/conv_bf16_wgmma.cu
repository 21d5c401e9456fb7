// The bf16 instances of the 3x3/s1/p1 convolution (conv3x3, also as the
// dgrad) and of its weight gradient (conv_wgrad) for Hopper: wgmma products
// on tiles that TMA copies into a ring of shared-memory stages:
//
//   conv3x3:    out[m][co] = sum over k of patches[m][k] * w[k][co]
//   conv_wgrad: dW[k][co]  = sum over m of patches[m][k] * dy[m][co]
//
// m runs over the N*H*W pixels, k = tap*C + c tap-major, x (N, H, W, C)
// NHWC with a zero halo, w (3, 3, C, Cout) HWIO = the row-major (9C, Cout)
// matrix, dy and out (N, H, W, Cout), dW (9C, Cout) fp32.  bf16 operands,
// their products exact in fp32, fp32 sums; conv3x3 rounds each output once
// to bf16, conv_wgrad writes fp32 (the caller casts dW to the weight's
// dtype).  The dgrad is conv3x3 of dy with the rotated weight.
//
// Replaces, on bf16 operands with C % 8 == 0 and Cout % 8 == 0 and 16-byte
// aligned tensors: mxnet_tpu/ops/pallas_block.py `_conv_kernel` (:318,
// launched by `conv3x3` :419 and `conv3x3_dgrad` :438; 16 dgrads a bf16
// ResNet-50 v1 training step, 10 forwards a bf16 Inception-v3 forward) and
// `_wgrad_kernel` (:381, launched by `conv3x3_wgrad` :444; 16 a step).
// Other bf16 shapes keep the mma.sync instances of conv3x3_tc.cu and
// conv_wgrad.cu.
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
// - Products: `wgmma.mma_async.m64nNk16.f32.bf16.bf16` (N = BN = 64 when
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
//   consumers walk the same units.  conv3x3: a range's segment that covers
//   a whole tile stores it (bf16); a cut tile's segments store fp32 slots
//   (range b's first to 2b, its last to 2b + 1) that
//   conv3x3_wgmma_reduce_kernel sums in range order.  conv_wgrad: each
//   segment stores its partial tile to its slot and
//   conv_wgrad_wgmma_reduce_kernel sums a tile's slots in order.  No float
//   atomics: a relaunch is bitwise equal.
// - The loop (`wgmma_ranges`) is one body for both: the operation picks
//   the loads, the A descriptor and the epilogue, so a STATS or AFFINE
//   epilogue, or an fp16 instance (the f16 wgmma has the same shapes), is
//   another instance of it.
// - Tensor maps are encoded on the host at each call (a 128-byte kernel
//   parameter each, which a CUDA graph keeps by value).
//
// ptxas (sm_90a, CUDA 12.8, `-Xptxas -v`): conv3x3_wgmma_kernel 148
// registers at BN 128, 96 at BN 64; conv_wgrad_wgmma_kernel 139 and 96;
// no spills; the reduce kernels 58 and 36.  Shared memory a block (dynamic,
// with 1 KB to align the ring): 165,888 bytes at BN 128, 149,504 at BN 64;
// one block an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_ring.cuh"

extern __shared__ __align__(1024) unsigned char mxt_wgmma_smem[];

namespace {

using namespace mxt_wgmma;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;       // tile rows: conv3x3 pixels, wgrad patch rows
constexpr int SLAB = 64;      // channels a box: 128 bytes of bf16
constexpr int BK = 64;        // a chunk: conv3x3 k, wgrad pixels
constexpr int kConsumers = 2;                    // warpgroups, 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int BOX = 64 * 64 * 2;                 // bytes of a 64 x 64 box

enum class Op { kConv, kWgrad };

template <int BN>
constexpr int kStages = BN == 64 ? 6 : 5;
constexpr int kRun = 8;       // chunks a run: 512 k (conv3x3) or pixels

// One ring stage: A's two 64-row halves (conv3x3: pixels 0-63 and 64-127
// of the tile, one im2col box; wgrad: the tile's two slabs, pixel rows)
// and B's 64-column boxes (k or pixel rows), each 128-byte swizzled.
template <int BN>
struct alignas(1024) Stage {
  bf16 a[2][64][64];
  bf16 b[BN / 64][64][64];
};

template <int BN>
struct Smem {
  Stage<BN> st[kStages<BN>];
  uint64_t full[kStages<BN>];
  uint64_t empty[kStages<BN>];
};

template <int BN>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<BN>) + 1024;   // + room to align the base
}

struct Geo {
  bf16* out;          // conv3x3: (N*H*W, Cout)
  float* part;        // conv3x3: (2 * ranges, BM, BN); wgrad: (tiles,
                      // jmax, BM, BN)
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
  if constexpr (OP == Op::kConv) {
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
template <Op OP, int BN>
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
    const uint64_t da = OP == Op::kConv
                            ? desc_sw128(a + 32 * kk, 16, 1024)
                            : desc_sw128(a + 2048 * kk, BOX, 1024);
    const uint64_t db = desc_sw128(b + 2048 * kk, BOX, 1024);
    mma<BN, OP == Op::kWgrad ? 1 : 0, 1>(run, da, db, kk > 0 || !fresh);
  }
  wg_commit();
}

// A finished segment [us, ue) of tile `tile` out of this warpgroup's
// registers: conv3x3 stores a whole tile in bf16, a cut one's rows < M to
// its range's slot; wgrad stores its partial tile to its slot.
template <Op OP, int BN>
__device__ __forceinline__ void store_segment(const Geo& g, long long tile,
                                              long long us, long long ue,
                                              long long u0, int wg,
                                              const float (&acc)[BN / 2]) {
  const int t = threadIdx.x & 127;
  const int r = wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);  // tile row
  const int cl = 2 * (t & 3);
  const long long b = blockIdx.x;
  const int tm = (int)(tile / g.tiles_n), tn = (int)(tile % g.tiles_n);
  if constexpr (OP == Op::kConv) {
    const long long t0 = tile * g.nch;
    const bool whole = us == t0 && ue == t0 + g.nch;
    float* slot = g.part + (2 * b + (us == u0 ? 0 : 1)) * (long long)(BM * BN);
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
          if (nn < g.Cout)
            *reinterpret_cast<__nv_bfloat162*>(g.out + (long long)m * g.Cout +
                                               nn) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(slot + row * BN + col) =
              make_float2(v0, v1);
        }
      }
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
template <Op OP, int BN>
__device__ __forceinline__ void consume(const Geo& g, Smem<BN>& sm, int wg) {
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
        OP == Op::kConv || 2 * (int)(tile / g.tiles_n) + wg < g.slabs;
    float acc[BN / 2], run[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_regs(run);
    int in_run = 0, prev = -1;   // chunks in the run; stage in flight
    for (long long v = u; v < ue; ++v) {
      bar_wait(&sm.full[st], ph);
      if (active) {
        mma_chunk<OP, BN>(sm.st[st], wg, in_run == 0, run);
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
    if (active) store_segment<OP, BN>(g, tile, u, ue, u0, wg, acc);
    u = ue;
  }
}

template <Op OP, int BN>
__device__ __forceinline__ void wgmma_ranges(const CUtensorMap* ta,
                                             const CUtensorMap* tb,
                                             const Geo& g) {
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
    consume<OP, BN>(g, sm, wg);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb, const Geo g) {
  wgmma_ranges<Op::kConv, BN>(&ta, &tb, g);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, const Geo g) {
  wgmma_ranges<Op::kWgrad, BN>(&ta, &tb, g);
}

template <Op OP, int BN>
auto main_kernel() {
  if constexpr (OP == Op::kConv)
    return conv3x3_wgmma_kernel<BN>;
  else
    return conv_wgrad_wgmma_kernel<BN>;
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

// conv3x3's cut tiles: the tile cut at the start of range blockIdx.y + 1,
// if that range owns it, its slots summed in range order 4 values a
// thread and rounded once to bf16 (conv3x3_tc.cu's reduce_cut, on this
// kernel's slots).
template <int BN>
__global__ void __launch_bounds__(256)
conv3x3_wgmma_reduce_kernel(const Geo g) {
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
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(sum.x, sum.y),
                         __floats2bfloat162_rn(sum.z, sum.w)};
  *reinterpret_cast<uint2*>(g.out + (long long)m * g.Cout + n) =
      *reinterpret_cast<const uint2*>(h);
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

template <Op OP, int BN>
cudaError_t prepare(int* per_sm) {
  const auto kernel = main_kernel<OP, BN>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BN>());
  if (err != cudaSuccess || !per_sm) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, kThreads, smem_bytes<BN>());
}

template <Op OP>
cudaError_t prepare_any(int bn, int* per_sm) {
  return bn == 64 ? prepare<OP, 64>(per_sm) : prepare<OP, 128>(per_sm);
}

// An encoder's failure as the entry's return value: 10000 + its CUresult
// (cudaError_t values stay below 1000).
constexpr int kEncodeError = 10000;

// x (N, H, W, C) bf16 in im2col mode: `pixels` pixels x 64 channels a box,
// the pad-1 3x3 window (corners -1, -1 in H and W).
int encode_x(CUtensorMap* map, const void* x, int N, int H, int W, int C,
             int pixels) {
  const Encoders& enc = encoders();
  if (enc.err != cudaSuccess) return (int)enc.err;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {2ull * C, 2ull * C * W, 2ull * C * W * H};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc.im2col(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, lower, upper, SLAB, (cuuint32_t)pixels, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// A bf16 tensor of `rank` dims (innermost first) in 64 x 64 boxes (the
// rest 1), 128-byte swizzled.
int encode_tiled(CUtensorMap* map, const void* t, int rank,
                 const cuuint64_t* dims) {
  const Encoders& enc = encoders();
  if (enc.err != cudaSuccess) return (int)enc.err;
  cuuint64_t strides[2];
  cuuint64_t s = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const cuuint32_t box[3] = {64, 64, 1}, estr[3] = {1, 1, 1};
  const CUresult r = enc.tiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
      const_cast<void*>(t), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// The geometry both kernels share, or false for what they do not take:
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

}  // namespace

// Blocks of conv3x3_wgmma_kernel<bn> that fit an SM of the current device,
// into *out (the host cuts the work into 132 x this many ranges); vec must
// be 1 (the kernel takes only C % 8 == 0, Cout % 8 == 0, aligned tensors).
extern "C" int mxt_conv3x3_wgmma_blocks_per_sm(int bn, int vec, int* out) {
  if ((bn != 64 && bn != 128) || vec != 1) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<Op::kConv>(bn, out);
}

extern "C" int mxt_conv_wgrad_wgmma_blocks_per_sm(int bn, int vec,
                                                  int* out) {
  if ((bn != 64 && bn != 128) || vec != 1) return (int)cudaErrorInvalidValue;
  return (int)prepare_any<Op::kWgrad>(bn, out);
}

// conv3x3 on bf16: x (N, H, W, C), w (3, 3, C, Cout), out (N, H, W, Cout),
// contiguous and 16-byte aligned, C % 8 == 0, Cout % 8 == 0; part (2 *
// ranges, 128, bn) fp32 scratch.  The ceil(N*H*W / 128) * ceil(Cout / bn)
// tiles x 9 * ceil(C / 64) chunks are cut into `ranges` ranges, one a
// block: the plan (bn, ranges) is the caller's (mxnet_tpu_torch/ops/
// conv_block.py conv3x3_splits, per_sm from
// mxt_conv3x3_wgmma_blocks_per_sm).  Returns cudaGetLastError() after the
// launches, or 10000 + the CUresult of a tensor-map encoder that failed.
extern "C" int mxt_conv3x3_wgmma_bf16(const void* x, const void* w,
                                      void* part, void* out, int N, int H,
                                      int W, int C, int Cout, int bn,
                                      int ranges, void* stream) {
  Geo g;
  if (!geometry(g, N, H, W, C, Cout, bn, ranges))
    return (int)cudaErrorInvalidValue;
  g.out = static_cast<bf16*>(out);
  g.part = static_cast<float*>(part);
  g.nch = g.slabs;
  const long long tiles = (long long)((g.M + BM - 1) / BM) * g.tiles_n;
  g.total = tiles * g.nch;
  if (ranges > g.total || ranges > 65536) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  const cuuint64_t wdims[3] = {(cuuint64_t)Cout, (cuuint64_t)C, 9};
  int err = encode_x(&ta, x, N, H, W, C, BM);
  if (!err) err = encode_tiled(&tb, w, 3, wdims);
  if (err) return err;
  err = (int)prepare_any<Op::kConv>(bn, nullptr);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 rgrid(BM * bn / 4 / 256, (unsigned)(ranges - 1));
  if (bn == 64) {
    conv3x3_wgmma_kernel<64>
        <<<(unsigned)ranges, kThreads, smem_bytes<64>(), s>>>(ta, tb, g);
    if (ranges > 1) conv3x3_wgmma_reduce_kernel<64><<<rgrid, 256, 0, s>>>(g);
  } else {
    conv3x3_wgmma_kernel<128>
        <<<(unsigned)ranges, kThreads, smem_bytes<128>(), s>>>(ta, tb, g);
    if (ranges > 1)
      conv3x3_wgmma_reduce_kernel<128><<<rgrid, 256, 0, s>>>(g);
  }
  return (int)cudaGetLastError();
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
  Geo g;
  if (!geometry(g, N, H, W, C, Cout, bn, ranges) || jmax <= 0)
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
  int err = encode_x(&ta, x, N, H, W, C, BK);
  if (!err) err = encode_tiled(&tb, dy, 2, ddims);
  if (err) return err;
  err = (int)prepare_any<Op::kWgrad>(bn, nullptr);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 rgrid(BM * bn / 4 / 256, (unsigned)tiles);
  if (bn == 64) {
    conv_wgrad_wgmma_kernel<64>
        <<<(unsigned)ranges, kThreads, smem_bytes<64>(), s>>>(ta, tb, g);
    conv_wgrad_wgmma_reduce_kernel<64><<<rgrid, 256, 0, s>>>(g);
  } else {
    conv_wgrad_wgmma_kernel<128>
        <<<(unsigned)ranges, kThreads, smem_bytes<128>(), s>>>(ta, tb, g);
    conv_wgrad_wgmma_reduce_kernel<128><<<rgrid, 256, 0, s>>>(g);
  }
  return (int)cudaGetLastError();
}
