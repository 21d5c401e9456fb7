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
// batch 64 on the 56x56x64 stage that is 64.3 MB, 0.0192 ms at 3.35 TB/s
// (the f32 output alone 51.4 MB), against 14.8 G operations, 0.0075 ms at
// the 1,979 TOPS dense int8 peak: the f32 output write sets the floor at
// every ResNet-50 stage and batch, so `mma.sync` (not `wgmma`) is enough
// and the design is about keeping the copies and the stores moving.
//
// Design, for Hopper rather than after the TPU's row blocks:
// - An implicit GEMM on the int8 tensor cores with
//   `mma.sync.m16n8k32.s32.s8.s8.s32`.  M = N*H*W output pixels, N =
//   Cout, K = 9*C in tap-major order (the HWIO weight read as the (9C,
//   Cout) matrix the TPU kernel multiplies).  The weight comes packed
//   once, at QuantizedConv2D construction, as the (Cout, 9C) matrix, so
//   B's rows are K-contiguous like A's.
// - Tiles: a block of 8 warps owns 128 pixels x BN channels (BN 64 for
//   Cout <= 64, else 128); a warp owns 32 x BN/2.  Fragments come from
//   shared memory by `ldmatrix` (one x4 load is a 16 x 32 A fragment or
//   two 8 x 32 B fragments).
// - Data: K runs in chunks of 64 bytes (two k-steps) through a four-stage
//   ring filled by 16-byte `cp.async` copies; halo taps, pixels past
//   N*H*W and k past 9C are zero-filled with a source size of 0, which is
//   exact because the quantization is symmetric with zero-point 0 (the
//   TPU kernel pads a copy instead).  Ring rows are 80 bytes apart, so a
//   warp's `ldmatrix` phases hit 32 distinct banks.  A thread copies one
//   fixed 16-byte piece of k of two pixel rows (and of one or two weight
//   rows); the pixels' (h, w) come from one division a segment and the
//   piece's (tap, c) steps by 64 a chunk with a carry: no division in the
//   loop.
// - Work split in one wave (stream-K, as conv3x3_tc.cu): the tiles x
//   chunks of work are cut into `ranges` = 132 x (blocks an SM, from the
//   occupancy API) ranges of whole chunks, one a block, which walks its
//   range.  A segment that covers a whole tile runs its epilogue; a cut
//   one writes the rows < N*H*W of its int32 partial tile to a slot of its
//   range (the first segment of range b to slot 2b, the last to 2b + 1),
//   and qconv_reduce_kernel, a block row a tile, sums a cut tile's slots
//   in range order (exact in int32, in a fixed order all the same, no
//   atomics) and runs the same epilogue.  A slot weighs as much as the
//   tile's f32 output, which sets this kernel's bound, so the host's plan
//   cuts little: where the tiles give every SM one (every stage at batch
//   64, 56x56 at batch 8) the ranges hold whole tiles (grain nch: no
//   slot, no second kernel); 28x28x128 at batch 8 takes 64-channel tiles
//   to get there; below that each tile is split into the same few
//   ranges, about one a spare SM (at (1, 7, 7, 512) the 4 tiles of 72
//   chunks become 64 ranges, where one block a tile left 128 SMs idle).
// - Measured (PERF.md): the copies into the ring, not the products, bound
//   the loop; the next lever is fewer, larger copies (TMA), not wgmma.
// - A staged epilogue: after the loop and a barrier, the int32 tile goes
//   into the ring's shared memory (rows BN + 8 ints apart: the fragment
//   stores hit 32 banks a half-warp), and each thread then reads whole
//   16-byte pieces of NHWC rows, one fixed 4-channel piece, so a warp
//   loads the residual and stores `float4`s along contiguous rows, and
//   `scale` and `shift` are read once a tile.  Each int32 sum becomes f32
//   and goes through scale, shift, residual and ReLU with __fmul_rn /
//   __fadd_rn (no contraction into an FMA), so the result equals its
//   plain version, `acc.float() * scale + shift (+ res)`, bit for bit.
// - The 16-byte path (VEC) needs C % 16 == 0 (a 16-byte piece of K lies
//   inside one tap), Cout % 4 == 0 and 16-byte aligned bases, which every
//   ResNet stage has; any other shape (C = 3, 20, ...) takes the same
//   tiles with its bytes gathered one by one and its epilogue a value at
//   a time.  The TPU's VMEM gate and per-stage table have no counterpart:
//   every shape runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

extern __shared__ __align__(16) unsigned char mxt_qconv_smem[];

namespace {

constexpr int BM = 128;         // output pixels a tile
constexpr int BK = 64;          // K bytes a chunk: two mma k-steps
constexpr int LDS = BK + 16;    // ring row stride in bytes
constexpr int STAGES = 4;
constexpr int kThreads = 256;   // 8 warps: 4 along pixels x 2 along co
constexpr int SLOT_BATCH = 8;   // partial slots a reduce loads at once

template <int BN>
struct Ring {
  int8_t a[STAGES][BM][LDS];    // pixel rows, K contiguous
  int8_t b[STAGES][BN][LDS];    // channel rows, K contiguous
};

// a finished int32 tile, staged in the ring's memory for the epilogue
template <int BN>
struct Staged {
  int v[BM][BN + 8];
};

static_assert(sizeof(Staged<64>) <= sizeof(Ring<64>), "stage fits");
static_assert(sizeof(Staged<128>) <= sizeof(Ring<128>), "stage fits");

struct Args {
  const int8_t* x;       // (N, H, W, C)
  const int8_t* wt;      // (Cout, 9C): the HWIO weight, transposed
  const float* scale;    // (Cout,)
  const float* shift;    // (Cout,)
  const float* res;      // (N*H*W, Cout) or null
  float* out;            // (N*H*W, Cout)
  int* part;             // (2 * ranges, BM, BN) int32 partial tiles
  long long nch;         // chunks a tile: ceil(K / BK)
  long long total;       // tiles * nch units of work
  long long grain;       // units a range holds a multiple of: 1 or nch
  int M;                 // N*H*W
  int H, W, C, Cout, K;  // K = 9*C
  int tiles_n;           // tiles along Cout
  int ranges;            // blocks: the work is cut into this many ranges
  int relu;
};

// In grains of G units (G = 1, or nch: whole tiles), the range of block
// b is grains [b*T/ranges, (b+1)*T/ranges) of the T = total / G; unit u
// lies in range ((u/G + 1)*ranges - 1) / T.
__device__ __forceinline__ long long range_start(const Args& a,
                                                 long long b) {
  return b * (a.total / a.grain) / a.ranges * a.grain;
}

__device__ __forceinline__ long long range_of(const Args& a, long long u) {
  return ((u / a.grain + 1) * a.ranges - 1) / (a.total / a.grain);
}

// through L1 (.ca): a block's next taps re-read most of this tap's pixel
// rows, and its next tiles the same weight rows
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 16-byte matrices: lanes 8j .. 8j + 7 give the row addresses of
// matrix j, and lane (g, t) gets bytes 4t .. 4t + 3 of row g of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a . b on one 16 x 8 x 32 int8 tile (lane (g, t) holds a: rows g,
// g + 8 of bytes 4t.. and 16 + 4t..; b: column g, bytes 4t.. and 16 +
// 4t..; c: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1))
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One thread's share of filling a ring stage with one chunk: piece q
// (bytes 16q .. 16q + 15 of the chunk) of pixel rows r0 and r0 + 64, and
// of weight rows r0 (and r0 + 64 when BN is 128).
template <int BN, bool VEC>
struct Loader {
  static constexpr int BROWS = BN * (BK / 16) / kThreads;   // 1 or 2
  const Args& a;
  int q, r0, n0;
  int k;                // this piece's first k in the next chunk
  int p[2];             // pixels of rows r0, r0 + 64
  int h[2], w[2];
  int th, tw, c;        // VEC: the piece's tap (row, column) and channel
  long long off;        // VEC: its offset from a pixel's row of x

  __device__ __forceinline__ Loader(const Args& args, int m0, int n0_,
                                    int kbeg)
      : a(args), n0(n0_) {
    q = threadIdx.x & 3;
    r0 = threadIdx.x >> 2;
    k = kbeg + 16 * q;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      p[i] = m0 + r0 + 64 * i;
      w[i] = p[i] % a.W;
      // a pixel past the range gets an h no tap can bring into [0, H)
      h[i] = p[i] < a.M ? (p[i] / a.W) % a.H : -4;
    }
    if constexpr (VEC) {
      const int tap = k / a.C;
      c = k - tap * a.C;
      th = tap / 3;   // 3 or more: k past 9C, zero-filled
      tw = tap % 3;
      off = ((long long)(th - 1) * a.W + (tw - 1)) * a.C + c;
    }
  }

  // copy the chunk at k into stage st and step to the next one
  __device__ __forceinline__ void load(Ring<BN>& s, int st) {
    if constexpr (VEC) {
      const bool kin = th < 3;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ih = h[i] + th - 1, iw = w[i] + tw - 1;
        const bool ok = kin && (unsigned)ih < (unsigned)a.H &&
                        (unsigned)iw < (unsigned)a.W;
        cp_async16(&s.a[st][r0 + 64 * i][16 * q],
                   ok ? a.x + (long long)p[i] * a.C + off : a.x, ok);
      }
#pragma unroll
      for (int j = 0; j < BROWS; ++j) {
        const int n = n0 + r0 + 64 * j;
        const bool ok = kin && n < a.Cout;
        cp_async16(&s.b[st][r0 + 64 * j][16 * q],
                   ok ? a.wt + (long long)n * a.K + k : a.wt, ok);
      }
      c += BK;
      while (c >= a.C) {   // once a chunk when C >= 64
        c -= a.C;
        if (++tw == 3) {
          tw = 0;
          ++th;
        }
      }
      off = ((long long)(th - 1) * a.W + (tw - 1)) * a.C + c;
    } else {
      // any C: each byte gathered on its own, with its own tap
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        for (int e = 0; e < 16; ++e) {
          const int kk = k + e;
          if (kk >= a.K) break;
          const int tap = kk / a.C;
          const int dh = tap / 3 - 1, dw = tap % 3 - 1;
          const int ih = h[i] + dh, iw = w[i] + dw;
          if ((unsigned)ih < (unsigned)a.H && (unsigned)iw < (unsigned)a.W) {
            const int8_t b = a.x[((long long)p[i] + dh * a.W + dw) * a.C +
                                 (kk - tap * a.C)];
            v[e >> 2] |= (uint32_t)(uint8_t)b << (8 * (e & 3));
          }
        }
        *reinterpret_cast<uint4*>(&s.a[st][r0 + 64 * i][16 * q]) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int j = 0; j < BROWS; ++j) {
        const int n = n0 + r0 + 64 * j;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        for (int e = 0; e < 16 && n < a.Cout; ++e) {
          const int kk = k + e;
          if (kk >= a.K) break;
          v[e >> 2] |= (uint32_t)(uint8_t)a.wt[(long long)n * a.K + kk]
                       << (8 * (e & 3));
        }
        *reinterpret_cast<uint4*>(&s.b[st][r0 + 64 * j][16 * q]) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    k += BK;
  }
};

// acc += this warp's 32 x BN/2 share of the chunk in stage st.  A k-step's
// fragments are all read before its products: the reads (volatile, so
// they stay behind the barrier) keep their order, and the products (pure
// register operations) may move past the next step's reads.
template <int BN>
__device__ __forceinline__ void mma_chunk(const Ring<BN>& s, int st,
                                          int wm, int wn, int lane,
                                          int (&acc)[2][BN / 16][4]) {
  const int i = lane & 7, j = lane >> 3;   // row in, and index of, matrix
#pragma unroll
  for (int ks = 0; ks < BK / 32; ++ks) {
    uint32_t fa[2][4], fb[BN / 32][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(fa[mi], &s.a[st][wm * 32 + mi * 16 + i + 8 * (j & 1)]
                                  [ks * 32 + 16 * (j >> 1)]);
    // fb[np][0..1]: column fragment 2np, fb[np][2..3]: 2np + 1
#pragma unroll
    for (int np = 0; np < BN / 32; ++np)
      ldmatrix_x4(fb[np], &s.b[st][wn * (BN / 2) + np * 16 + i +
                                   8 * (j >> 1)][ks * 32 + 16 * (j & 1)]);
#pragma unroll
    for (int np = 0; np < BN / 32; ++np)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_s8(acc[mi][2 * np], fa[mi], fb[np]);
        mma_s8(acc[mi][2 * np + 1], fa[mi], fb[np] + 2);
      }
  }
}

// scale and shift of channels n .. n + 3 (0 past Cout)
template <bool VEC>
__device__ __forceinline__ void load_affine(const Args& a, int n,
                                            float (&sc)[4], float (&sh)[4]) {
  if constexpr (VEC) {
    if (n < a.Cout) {
      const float4 s4 = *reinterpret_cast<const float4*>(a.scale + n);
      const float4 h4 = *reinterpret_cast<const float4*>(a.shift + n);
      sc[0] = s4.x; sc[1] = s4.y; sc[2] = s4.z; sc[3] = s4.w;
      sh[0] = h4.x; sh[1] = h4.y; sh[2] = h4.z; sh[3] = h4.w;
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool in = n + e < a.Cout;
    sc[e] = in ? a.scale[n + e] : 0.f;
    sh[e] = in ? a.shift[n + e] : 0.f;
  }
}

// out[m][n .. n + 3] = act(f32(v) * scale + shift (+ res)) for m < M,
// with the plain version's two rounded operations (and the residual's
// one).  VEC: Cout % 4 == 0 and 16-byte aligned bases, one float4 each
// way.
template <bool VEC>
__device__ __forceinline__ void epilogue4(const Args& a, int m, int n,
                                          int4 v, const float (&sc)[4],
                                          const float (&sh)[4]) {
  const long long at = (long long)m * a.Cout + n;
  const int s[4] = {v.x, v.y, v.z, v.w};
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.res) {
    if constexpr (VEC) {
      const float4 r4 = *reinterpret_cast<const float4*>(a.res + at);
      r[0] = r4.x; r[1] = r4.y; r[2] = r4.z; r[3] = r4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < a.Cout) r[e] = a.res[at + e];
    }
  }
  float y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    y[e] = __fadd_rn(__fmul_rn((float)s[e], sc[e]), sh[e]);
    if (a.res) y[e] = __fadd_rn(y[e], r[e]);
    if (a.relu) y[e] = y[e] > 0.f ? y[e] : 0.f;
  }
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(a.out + at) =
        make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < a.Cout) a.out[at + e] = y[e];
  }
}

// The segments of range blockIdx.x: each tile's int32 sums staged in
// shared memory, then finished (a whole tile) or written to a slot (a
// cut one).
template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
qconv_affine_kernel(const Args a) {
  Ring<BN>& s = *reinterpret_cast<Ring<BN>*>(mxt_qconv_smem);
  Staged<BN>& o = *reinterpret_cast<Staged<BN>*>(mxt_qconv_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;   // 32-row, BN/2-column share
  const int g = lane >> 2, t = lane & 3;     // mma fragment coordinates
  // the epilogue's piece: channels 4cq .. 4cq + 3 of rows rg, rg + RSTEP..
  constexpr int RSTEP = kThreads / (BN / 4);
  const int cq = threadIdx.x % (BN / 4), rg = threadIdx.x / (BN / 4);
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

    int acc[2][BN / 16][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    Loader<BN, VEC> ld(a, m0, n0, c0 * BK);
    __syncthreads();   // every thread is done with the last epilogue
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
      mma_chunk<BN>(s, kt % STAGES, wm, wn, lane, acc);
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done reading the ring

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < BN / 16; ++ni)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<int2*>(
              &o.v[wm * 32 + mi * 16 + g + 8 * hf]
                  [wn * (BN / 2) + ni * 8 + 2 * t]) =
              make_int2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
    __syncthreads();

    if (c0 == 0 && nk == a.nch) {
      // a whole tile: finished here
      const int n = n0 + 4 * cq;
      float sc[4], sh[4];
      load_affine<VEC>(a, n, sc, sh);
      if (n < a.Cout) {
        for (int r = rg; r < BM && m0 + r < a.M; r += RSTEP)
          epilogue4<VEC>(a, m0 + r, n,
                         *reinterpret_cast<const int4*>(&o.v[r][4 * cq]),
                         sc, sh);
      }
    } else {
      // a cut one: its rows < M to the range's first (2b) or last
      // (2b + 1) slot (the reduce reads no other rows)
      int* slot =
          a.part + (2 * b + (u == u0 ? 0 : 1)) * (long long)(BM * BN);
      for (int r = rg; r < BM && m0 + r < a.M; r += RSTEP)
        *reinterpret_cast<int4*>(slot + r * BN + 4 * cq) =
            *reinterpret_cast<const int4*>(&o.v[r][4 * cq]);
    }
    u = send;
  }
}

// Tile blockIdx.y, if ranges r0 .. last > r0 cut it: its slots summed in
// range order, 4 values a thread, then the epilogue.
template <int BN, bool VEC>
__global__ void __launch_bounds__(256)
qconv_reduce_kernel(const Args a) {
  const long long tile = blockIdx.y;
  const long long t0 = tile * a.nch;
  const long long r0 = range_of(a, t0);
  const long long last = range_of(a, t0 + a.nch - 1);
  if (r0 == last) return;   // one segment: the main kernel finished it
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= BM * BN) return;
  const int m = (int)(tile / a.tiles_n) * BM + e / BN;
  const int n = (int)(tile % a.tiles_n) * BN + e % BN;
  if (m >= a.M || n >= a.Cout) return;
  // the segment of range r0 is its first one iff it starts in the tile
  // (at its first unit); ranges r0 + 1 .. last start in it
  const long long first = 2 * r0 + (range_start(a, r0) >= t0 ? 0 : 1);
  int4 sum = make_int4(0, 0, 0, 0);
  // SLOT_BATCH slots loaded before they are added, in range order (one at
  // a time, a thread would wait on memory for every slot)
  for (long long q0 = r0; q0 <= last; q0 += SLOT_BATCH) {
    int4 v[SLOT_BATCH];
#pragma unroll
    for (int i = 0; i < SLOT_BATCH; ++i) {
      const long long q = q0 + i;
      if (q > last) break;
      const long long slot = q == r0 ? first : 2 * q;
      v[i] = *reinterpret_cast<const int4*>(
          a.part + slot * (long long)(BM * BN) + e);
    }
#pragma unroll
    for (int i = 0; i < SLOT_BATCH; ++i) {
      if (q0 + i > last) break;
      sum.x += v[i].x; sum.y += v[i].y; sum.z += v[i].z; sum.w += v[i].w;
    }
  }
  float sc[4], sh[4];
  load_affine<VEC>(a, n, sc, sh);
  epilogue4<VEC>(a, m, n, sum, sc, sh);
}

template <int BN, bool VEC>
cudaError_t prepare(int* per_sm) {
  const int bytes = (int)sizeof(Ring<BN>);
  const auto kernel = qconv_affine_kernel<BN, VEC>;
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

template <int BN, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t s) {
  cudaError_t err = prepare<BN, VEC>(nullptr);
  if (err != cudaSuccess) return err;
  qconv_affine_kernel<BN, VEC>
      <<<(unsigned)a.ranges, kThreads, sizeof(Ring<BN>), s>>>(a);
  if (a.ranges > 1 && a.grain == 1) {   // whole-tile ranges cut no tile
    const dim3 grid(BM * BN / 4 / 256, (unsigned)(a.total / a.nch));
    qconv_reduce_kernel<BN, VEC><<<grid, 256, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Blocks of qconv_affine_kernel<bn, vec> that fit an SM of the current
// device, into *out (the host cuts the work into 132 x this many ranges).
extern "C" int mxt_qconv_affine_blocks_per_sm(int bn, int vec, int* out) {
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  return (int)with_tile(bn, vec, [&](auto BN, auto VEC) {
    return prepare<decltype(BN)::value, decltype(VEC)::value>(out);
  });
}

// x (N, H, W, C) int8, wt (Cout, 9C) int8, scale/shift (Cout,) f32, res
// and out (N, H, W, Cout) f32, all contiguous; res may be null; part (2 *
// ranges, 128, bn) int32 scratch.  The tiles (ceil(N*H*W / 128) x
// ceil(Cout / bn)) x ceil(9C / 64) units of work are cut into `ranges`
// ranges, one a block, each a multiple of `grain` units (1, or
// ceil(9C / 64): whole tiles); the plan (bn, ranges, grain) is the
// caller's: mxnet_tpu_torch/ops/cuda_int8.py qconv_splits.  vec != 0
// asks for the 16-byte path: the host checked C % 16 == 0, Cout % 4 == 0
// and 16-byte aligned bases.
extern "C" int mxt_qconv_affine_s8(const void* x, const void* wt,
                                   const void* scale, const void* shift,
                                   const void* res, void* part, void* out,
                                   int N, int H, int W, int C, int Cout,
                                   int relu, int bn, int ranges, int grain,
                                   int vec, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || ranges <= 0 ||
      (bn != 64 && bn != 128) || 9LL * C > 0x7fffffffLL ||
      (long long)N * H * W + BM > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.wt = static_cast<const int8_t*>(wt);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.res = static_cast<const float*>(res);
  a.out = static_cast<float*>(out);
  a.part = static_cast<int*>(part);
  a.M = N * H * W;
  a.H = H; a.W = W; a.C = C; a.Cout = Cout; a.K = 9 * C;
  a.tiles_n = (Cout + bn - 1) / bn;
  a.nch = (a.K + BK - 1) / BK;
  a.total = (long long)((a.M + BM - 1) / BM) * a.tiles_n * a.nch;
  a.ranges = ranges;
  a.grain = grain;
  a.relu = relu;
  if ((grain != 1 && grain != a.nch) || ranges > a.total / grain ||
      ranges > 65536 || (grain == 1 && a.total / a.nch > 65535))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_tile(bn, vec, [&](auto BN, auto VEC) {
    return launch<decltype(BN)::value, decltype(VEC)::value>(a, s);
  });
}
