// Non-causal flash attention, fp32: the two backward passes (dq; dk and
// dv) on Hopper's tensor cores in 3xTF32, recomputing P from the
// forward's row logsumexp.  The forward (q, k, v -> o and lse) is
// flash_fwd_tc.cu.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_attn_dq_kernel` (:283) and
// `_attn_dkv_kernel` (:309), launched by `_attn_bwd_pallas`: the backward
// of the custom VJP of `attention_fused` that mxnet_tpu/models/bert.py
// `_attention` calls.
//
// The function: p = exp(s * scale - lse) with s = q.k^T, the scale
// applied after the dot (the TPU kernels' order); ds = p * (g.v^T -
// delta); dq = ds.k * scale, dv = p^T.g, dk = ds^T.q * scale.
//
// Bounds on an H100.  Per (batch, head) the dq pass does 6 * L^2 * D flops
// (Q.K^T, G.V^T, dS.K) and the dk/dv pass 8 * L^2 * D (K.Q^T, V.G^T,
// P^T.G, dS^T.Q).  At BERT-base's (B*H, L, D) = (192, 128, 64) the three
// TF32 products of each are 3.62 and 4.83 GFLOP: 0.0073 and 0.0098 ms at
// the 495 TFLOP/s dense TF32 peak, while their operands are 31.7 and
// 37.9 MB, 0.0094 and 0.0113 ms at 3.35 TB/s.  On the tensor cores bytes
// bound both (on the CUDA cores, at 67 TFLOP/s, operations did).
//
// Design (FlashAttention-2's backward on `mma.sync.m16n8k8` TF32,
// tf32x3.cuh), two kernels of one shape:
// - A block of 4 warps owns 64 resident rows, a warp 16: query rows in
//   flash_dq_tc (grid (B*H, ceil(Lq / 64))), key rows in flash_dkv_tc
//   (grid (B*H, ceil(Lk / 64))).  The resident operands (Q and G; K and
//   V) are the A operands of the two score products (S = Q.K^T and
//   dP = G.V^T; S^T = K.Q^T and dP^T = V.G^T).  The others (K and V; Q,
//   G and their rows' lse and delta) stream through a 2-stage `cp.async`
//   ring of tiles, tile j + 2 loading while j is read: 32 key rows for dq
//   (16 at D = 128), 16 query rows for dk/dv, whose two D-wide
//   accumulators leave fewer registers for the score fragments.  The
//   resident tile's copy is asked for with the first stream tile, so the
//   two overlap.
// - 3xTF32: every operand is split into TF32 hi and lo on its fragment
//   read and each product is lo*hi' + hi*lo' + hi*hi'.  The resident
//   tiles stay raw fp32 in shared memory (split hi/lo planes would double
//   them), so a block holds 68 KB (dq) or 51 KB (dk/dv) at D = 64, and
//   with <= 168 registers a thread three blocks fit an SM: BERT's 384
//   blocks of each kernel are one wave of 396.
// - The score products run 32 deep at a time into run accumulators from
//   zero, added to their sums with IEEE adds (the tensor core truncates
//   its own fp32 sums).  p and ds are computed in fp32 on the fragments
//   (lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of each 8-wide
//   fragment) and never leave registers: they are the A operand of the
//   next product (dQ += dS.K; dV += P^T.G and dK += dS^T.Q) with the
//   forward's k-index permutation (A's k = t is column 2t of the score
//   fragment, k = t + 4 column 2t + 1), so the streamed tile's B fragment
//   reads its rows 2t and 2t + 1 at column g.  Each stream tile's product
//   is one run, a quarter of D at a time, added with IEEE adds.  The
//   scale of dq and dk goes on once, at the end.
// - Masks: keys >= Lk (dq) and queries >= Lq (dk/dv) give p = ds = 0
//   explicitly; their rows are zero-filled by the copies, and the padded
//   lse is never read as a value.  Rows past the resident tile's length
//   are not written, so any Lq, Lk works.
// - Every output tile is written by one block, in a fixed order, with no
//   atomics: two launches on the same inputs are bitwise equal.
// - q/k/v/g and the gradients take arbitrary (batch, head, row) strides
//   and a unit last-dim stride, so BERT passes views into its fused qkv
//   projection; lse and delta are contiguous (B*H, Lq).  Shared-memory
//   rows are D + 4 floats apart, so both fragment orientations of a warp
//   hit 32 banks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

extern __shared__ __align__(16) unsigned char mxt_flash_bwd_smem[];

namespace {

using namespace mxt_tf32;

constexpr int BR = 64;     // resident rows a block, 16 a warp
constexpr int NT = 128;    // threads a block: 4 warps

// rows a streamed tile: key rows of dq, query rows of dk/dv
template <int D>
constexpr int kDqStreamRows = D == 64 ? 32 : 16;
constexpr int kDkvStreamRows = 16;

struct Strides {
  long long b, h, l;      // element strides; the last dim is contiguous
};

template <int D>
struct DqSmem {
  float q[BR][D + 4];
  float g[BR][D + 4];
  float k[2][kDqStreamRows<D>][D + 4];
  float v[2][kDqStreamRows<D>][D + 4];
};

template <int D>
struct DkvSmem {
  float k[BR][D + 4];
  float v[BR][D + 4];
  float q[2][kDkvStreamRows][D + 4];
  float g[2][kDkvStreamRows][D + 4];
  float lse[2][kDkvStreamRows];
  float delta[2][kDkvStreamRows];
};

// copy rows row0 .. row0 + ROWS - 1 of src into dst, zero past nrows
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float (*dst)[D + 4],
                                          const float* src,
                                          long long row_stride, int row0,
                                          int nrows) {
  constexpr int V4 = D / 4;
  static_assert(ROWS * V4 % NT == 0, "a tile is whole 16-byte copies");
#pragma unroll
  for (int i = 0; i < ROWS * V4 / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / V4, c = (idx % V4) * 4;
    const bool ok = row0 + r < nrows;
    cp_async16(&dst[r][c], ok ? src + (row0 + r) * row_stride + c : src, ok);
  }
}

// out = A . B^T for the warp's 16 rows rw .. rw + 15 of the resident a
// and the NS * 8 rows of the streamed b, over D: 32 deep a run from zero,
// each run added to out with IEEE adds
template <int D, int NS>
__device__ __forceinline__ void scores(float (&out)[NS][4],
                                       float (*a)[D + 4], float (*b)[D + 4],
                                       int rw, int g, int t) {
#pragma unroll
  for (int ni = 0; ni < NS; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[ni][e] = 0.f;
#pragma unroll
  for (int dc = 0; dc < D; dc += 32) {
    float run[NS][4];
#pragma unroll
    for (int ni = 0; ni < NS; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[ni][e] = 0.f;
#pragma unroll
    for (int d0 = dc; d0 < dc + 32; d0 += 8) {
      uint32_t ahi[4], alo[4];
      split(a[rw + g][d0 + t], ahi[0], alo[0]);
      split(a[rw + g + 8][d0 + t], ahi[1], alo[1]);
      split(a[rw + g][d0 + t + 4], ahi[2], alo[2]);
      split(a[rw + g + 8][d0 + t + 4], ahi[3], alo[3]);
#pragma unroll
      for (int ni = 0; ni < NS; ++ni) {
        uint32_t bhi[2], blo[2];
        split(b[ni * 8 + g][d0 + t], bhi[0], blo[0]);
        split(b[ni * 8 + g][d0 + t + 4], bhi[1], blo[1]);
        mma_3xtf32(run[ni], ahi, alo, bhi, blo);
      }
    }
#pragma unroll
    for (int ni = 0; ni < NS; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[ni][e] = __fadd_rn(out[ni][e], run[ni][e]);
  }
}

// acc += P . B for the warp's score fragments p (16 rows by the NS * 8
// rows of the streamed b) and b's D columns: one run a tile, a quarter of
// D at a time.  p's k order is permuted (A's k = t is column 2t, k = t + 4
// column 2t + 1), so B's fragment reads b's rows 2t and 2t + 1.
template <int D, int NS>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&p)[NS][4],
                                           float (*b)[D + 4], int g, int t) {
  constexpr int NH = D / 32;        // output fragments a quarter
#pragma unroll
  for (int part = 0; part < 4; ++part) {
    float run[NH][4];
#pragma unroll
    for (int ni = 0; ni < NH; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[ni][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NS; ++ks) {
      uint32_t ahi[4], alo[4];
      split(p[ks][0], ahi[0], alo[0]);
      split(p[ks][2], ahi[1], alo[1]);
      split(p[ks][1], ahi[2], alo[2]);
      split(p[ks][3], ahi[3], alo[3]);
#pragma unroll
      for (int ni = 0; ni < NH; ++ni) {
        const int col = part * (D / 4) + ni * 8 + g;
        uint32_t bhi[2], blo[2];
        split(b[ks * 8 + 2 * t][col], bhi[0], blo[0]);
        split(b[ks * 8 + 2 * t + 1][col], bhi[1], blo[1]);
        mma_3xtf32(run[ni], ahi, alo, bhi, blo);
      }
    }
#pragma unroll
    for (int ni = 0; ni < NH; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& a = acc[part * NH + ni][e];
        a = __fadd_rn(a, run[ni][e]);
      }
  }
}

// the warp's 16 rows of a (rows, D) gradient, times mul, to rows r0 + g
// and r0 + g + 8 of dst where they are < nrows
template <int D>
__device__ __forceinline__ void store_rows(float* dst, long long row_stride,
                                           const float (&acc)[D / 8][4],
                                           float mul, int r0, int nrows,
                                           int g, int t) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + g + 8 * hf;
    if (row < nrows) {
      float* out = dst + row * row_stride;
#pragma unroll
      for (int ni = 0; ni < D / 8; ++ni)
        *reinterpret_cast<float2*>(out + ni * 8 + 2 * t) =
            make_float2(__fmul_rn(acc[ni][2 * hf], mul),
                        __fmul_rn(acc[ni][2 * hf + 1], mul));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 3 : 2)
flash_dq_tc(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ g,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, int H, int Lq, int Lk, Strides sq,
            Strides sk, Strides sv, Strides sg, Strides sdq, float scale) {
  constexpr int BS = kDqStreamRows<D>;
  constexpr int NS = BS / 8;        // score fragments a warp
  DqSmem<D>& s = *reinterpret_cast<DqSmem<D>*>(mxt_flash_bwd_smem);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int rw = warp * 16;         // the warp's first row in the tile

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int nblk = (Lk + BS - 1) / BS;

  load_rows<D, BR>(s.q, q + b * sq.b + h * sq.h, sq.l, q0, Lq);
  load_rows<D, BR>(s.g, g + b * sg.b + h * sg.h, sg.l, q0, Lq);
  load_rows<D, BS>(s.k[0], kb, sk.l, 0, Lk);
  load_rows<D, BS>(s.v[0], vb, sv.l, 0, Lk);
  cp_async_commit();
  if (nblk > 1) {
    load_rows<D, BS>(s.k[1], kb, sk.l, BS, Lk);
    load_rows<D, BS>(s.v[1], vb, sv.l, BS, Lk);
  }
  cp_async_commit();

  // lse and delta of rows rw + gr (fragment entries 0, 1) and rw + gr + 8
  // (entries 2, 3)
  float lr[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + rw + gr + 8 * hf;
    const long long at = (long long)bh * Lq + row;
    lr[hf] = row < Lq ? lse[at] : 0.f;
    dl[hf] = row < Lq ? delta[at] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int ni = 0; ni < D / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

  const bool active = q0 + rw < Lq;   // warp-uniform
  for (int j = 0; j < nblk; ++j) {
    const int st = j & 1, k0 = j * BS;
    cp_async_wait<1>();               // tile j (and Q, G the first time)
    __syncthreads();
    if (active) {
      float ds[NS][4], dp[NS][4];
      scores<D, NS>(ds, s.q, s.k[st], rw, gr, t);     // S, then dS
      scores<D, NS>(dp, s.g, s.v[st], rw, gr, t);
#pragma unroll
      for (int ni = 0; ni < NS; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          const float p =
              k0 + ni * 8 + 2 * t + (e & 1) < Lk
                  ? expf(__fsub_rn(__fmul_rn(ds[ni][e], scale), lr[hf]))
                  : 0.f;
          ds[ni][e] = __fmul_rn(p, __fsub_rn(dp[ni][e], dl[hf]));
        }
      accumulate<D, NS>(acc, ds, s.k[st], gr, t);
    }
    __syncthreads();                  // every warp is done with stage st
    if (j + 2 < nblk) {
      load_rows<D, BS>(s.k[st], kb, sk.l, k0 + 2 * BS, Lk);
      load_rows<D, BS>(s.v[st], vb, sv.l, k0 + 2 * BS, Lk);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_rows<D>(dq + b * sdq.b + h * sdq.h, sdq.l, acc, scale, q0 + rw, Lq,
                gr, t);
}

// the lse and delta of streamed query rows n0 .. n0 + BS - 1, zero past Lq
template <int BS>
__device__ __forceinline__ void load_stats(float* lse_dst, float* delta_dst,
                                           const float* lse,
                                           const float* delta, int n0,
                                           int Lq) {
  if (threadIdx.x < 2 * BS) {
    const int c = threadIdx.x % BS;
    const bool is_delta = threadIdx.x >= BS;
    const float* src = is_delta ? delta : lse;
    const bool ok = n0 + c < Lq;
    cp_async4((is_delta ? delta_dst : lse_dst) + c, ok ? src + n0 + c : src,
              ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 3 : 2)
flash_dkv_tc(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int H, int Lq,
             int Lk, Strides sq, Strides sk, Strides sv, Strides sg,
             Strides sdk, Strides sdv, float scale) {
  constexpr int BS = kDkvStreamRows;
  constexpr int NS = BS / 8;
  DkvSmem<D>& s = *reinterpret_cast<DkvSmem<D>*>(mxt_flash_bwd_smem);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int rw = warp * 16;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* gb = g + b * sg.b + h * sg.h;
  const float* lb = lse + (long long)bh * Lq;
  const float* db = delta + (long long)bh * Lq;
  const int nblk = (Lq + BS - 1) / BS;

  load_rows<D, BR>(s.k, k + b * sk.b + h * sk.h, sk.l, k0, Lk);
  load_rows<D, BR>(s.v, v + b * sv.b + h * sv.h, sv.l, k0, Lk);
  load_rows<D, BS>(s.q[0], qb, sq.l, 0, Lq);
  load_rows<D, BS>(s.g[0], gb, sg.l, 0, Lq);
  load_stats<BS>(s.lse[0], s.delta[0], lb, db, 0, Lq);
  cp_async_commit();
  if (nblk > 1) {
    load_rows<D, BS>(s.q[1], qb, sq.l, BS, Lq);
    load_rows<D, BS>(s.g[1], gb, sg.l, BS, Lq);
    load_stats<BS>(s.lse[1], s.delta[1], lb, db, BS, Lq);
  }
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int ni = 0; ni < D / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[ni][e] = dva[ni][e] = 0.f;

  const bool active = k0 + rw < Lk;   // warp-uniform
  for (int i = 0; i < nblk; ++i) {
    const int st = i & 1, n0 = i * BS;
    cp_async_wait<1>();               // tile i (and K, V the first time)
    __syncthreads();
    if (active) {
      // key rows rw + gr, rw + gr + 8 by query columns ni * 8 + 2t (+1)
      float p[NS][4], ds[NS][4];
      scores<D, NS>(p, s.k, s.q[st], rw, gr, t);      // S^T, then P^T
      scores<D, NS>(ds, s.v, s.g[st], rw, gr, t);     // dP^T, then dS^T
#pragma unroll
      for (int ni = 0; ni < NS; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = ni * 8 + 2 * t + (e & 1);
          const bool ok = n0 + c < Lq;
          const float pv =
              ok ? expf(__fsub_rn(__fmul_rn(p[ni][e], scale), s.lse[st][c]))
                 : 0.f;
          ds[ni][e] =
              ok ? __fmul_rn(pv, __fsub_rn(ds[ni][e], s.delta[st][c])) : 0.f;
          p[ni][e] = pv;
        }
      accumulate<D, NS>(dva, p, s.g[st], gr, t);
      accumulate<D, NS>(dka, ds, s.q[st], gr, t);
    }
    __syncthreads();                  // every warp is done with stage st
    if (i + 2 < nblk) {
      load_rows<D, BS>(s.q[st], qb, sq.l, n0 + 2 * BS, Lq);
      load_rows<D, BS>(s.g[st], gb, sg.l, n0 + 2 * BS, Lq);
      load_stats<BS>(s.lse[st], s.delta[st], lb, db, n0 + 2 * BS, Lq);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  store_rows<D>(dk + b * sdk.b + h * sdk.h, sdk.l, dka, scale, k0 + rw, Lk,
                gr, t);
  store_rows<D>(dv + b * sdv.b + h * sdv.h, sdv.l, dva, 1.f, k0 + rw, Lk,
                gr, t);
}

// allow the kernel its shared memory; with per_sm, also the blocks of it
// that fit an SM of the current device
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess || !per_sm) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, NT,
                                                       bytes);
}

template <int D>
cudaError_t prepare_dq(int* per_sm) {
  return prepare(flash_dq_tc<D>, (int)sizeof(DqSmem<D>), per_sm);
}

template <int D>
cudaError_t prepare_dkv(int* per_sm) {
  return prepare(flash_dkv_tc<D>, (int)sizeof(DkvSmem<D>), per_sm);
}

Strides strides(const long long* s) { return Strides{s[0], s[1], s[2]}; }

dim3 grid(int B, int H, int rows) {
  return dim3((unsigned)(B * H), (unsigned)((rows + BR - 1) / BR));
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* g, const float* lse, const float* delta,
                      float* dq, int B, int H, int Lq, int Lk, Strides sq,
                      Strides sk, Strides sv, Strides sg, Strides sdq,
                      float scale, cudaStream_t stream) {
  cudaError_t err = prepare_dq<D>(nullptr);
  if (err != cudaSuccess) return err;
  flash_dq_tc<D><<<grid(B, H, Lq), NT, sizeof(DqSmem<D>), stream>>>(
      q, k, v, g, lse, delta, dq, H, Lq, Lk, sq, sk, sv, sg, sdq, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* g, const float* lse, const float* delta,
                       float* dk, float* dv, int B, int H, int Lq, int Lk,
                       Strides sq, Strides sk, Strides sv, Strides sg,
                       Strides sdk, Strides sdv, float scale,
                       cudaStream_t stream) {
  cudaError_t err = prepare_dkv<D>(nullptr);
  if (err != cudaSuccess) return err;
  flash_dkv_tc<D><<<grid(B, H, Lk), NT, sizeof(DkvSmem<D>), stream>>>(
      q, k, v, g, lse, delta, dk, dv, H, Lq, Lk, sq, sk, sv, sg, sdk, sdv,
      scale);
  return cudaGetLastError();
}

#define MXT_F(p) static_cast<const float*>(p)
#define MXT_W(p) static_cast<float*>(p)

}  // namespace

// q, g, dq: (B, H, Lq, D); k, v: (B, H, Lk, D); lse and delta (B*H, Lq)
// contiguous; fp32.  Each stride array is (batch, head, row) in elements;
// the last dim is contiguous.  The host checked that every row starts
// 16-byte aligned and that D is 64 or 128.
extern "C" int mxt_attention_dq_f32(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, int B, int H, int Lq,
    int Lk, int D, const long long* q_strides, const long long* k_strides,
    const long long* v_strides, const long long* g_strides,
    const long long* dq_strides, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_dq<64>(MXT_F(q), MXT_F(k), MXT_F(v), MXT_F(g),
                                MXT_F(lse), MXT_F(delta), MXT_W(dq), B, H,
                                Lq, Lk, strides(q_strides),
                                strides(k_strides), strides(v_strides),
                                strides(g_strides), strides(dq_strides),
                                scale, s);
    case 128:
      return (int)launch_dq<128>(MXT_F(q), MXT_F(k), MXT_F(v), MXT_F(g),
                                 MXT_F(lse), MXT_F(delta), MXT_W(dq), B, H,
                                 Lq, Lk, strides(q_strides),
                                 strides(k_strides), strides(v_strides),
                                 strides(g_strides), strides(dq_strides),
                                 scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dk and dv as k; the rest as for dq.
extern "C" int mxt_attention_dkv_f32(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Lq, int Lk, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* g_strides, const long long* dk_strides,
    const long long* dv_strides, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_dkv<64>(MXT_F(q), MXT_F(k), MXT_F(v), MXT_F(g),
                                 MXT_F(lse), MXT_F(delta), MXT_W(dk),
                                 MXT_W(dv), B, H, Lq, Lk, strides(q_strides),
                                 strides(k_strides), strides(v_strides),
                                 strides(g_strides), strides(dk_strides),
                                 strides(dv_strides), scale, s);
    case 128:
      return (int)launch_dkv<128>(MXT_F(q), MXT_F(k), MXT_F(v), MXT_F(g),
                                  MXT_F(lse), MXT_F(delta), MXT_W(dk),
                                  MXT_W(dv), B, H, Lq, Lk,
                                  strides(q_strides), strides(k_strides),
                                  strides(v_strides), strides(g_strides),
                                  strides(dk_strides), strides(dv_strides),
                                  scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of flash_dq_tc<D> (flash_dkv_tc<D>) that fit an SM of the
// current device, into *out: the host's view of the grid's waves.
extern "C" int mxt_attention_dq_blocks_per_sm(int D, int* out) {
  switch (D) {
    case 64: return (int)prepare_dq<64>(out);
    case 128: return (int)prepare_dq<128>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mxt_attention_dkv_blocks_per_sm(int D, int* out) {
  switch (D) {
    case 64: return (int)prepare_dkv<64>(out);
    case 128: return (int)prepare_dkv<128>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
