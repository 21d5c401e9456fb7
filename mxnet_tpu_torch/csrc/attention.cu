// Non-causal flash attention, fp32: the two backward passes (dq; dk and
// dv), which recompute P from the forward's row logsumexp.  The forward
// (q, k, v -> o and lse) is flash_fwd_tc.cu, on the tensor cores.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_attn_dq_kernel` and
// `_attn_dkv_kernel` (launched by `_attn_bwd_pallas`), the backward of
// the custom VJP of `attention_fused` that mxnet_tpu/models/bert.py
// `_attention` calls.
//
// Bound on an H100: arithmetic.  Per (batch, head) the dq pass does
// 6 * L^2 * D flops (Q.K^T, G.V^T, dS.K) and the dk/dv pass 8 * L^2 * D
// (Q.K^T, G.V^T, P^T.G, dS^T.Q), against 20 and 24 * L * D bytes of
// operands.  At BERT-base's (B*H, L, D) = (192, 128, 64) that is 38 and
// 43 flops a byte, above the 20 flops a byte at which fp32 FMAs on the
// CUDA cores (67 TFLOP/s) and device memory (3.35 TB/s) balance.
//
// Design (both): a 256-thread block owns one 64-row tile of its output
// and streams the other operand through shared memory 64 rows at a
// time, so the (L, L) score matrix never reaches device memory.  Each
// thread owns a 4x4 piece of the 64x64 score tile (rows ty + 16r,
// columns tx + 16c) and a 4 x D/16 piece of each accumulator.  Rows in
// shared memory are padded by one float, so column-strided reads hit 16
// different banks.  Columns past Lk and rows past Lq are masked here, so
// any L works.  q/k/v/g and the gradients are taken with arbitrary
// (batch, head, row) strides and a unit last-dim stride, so BERT passes
// views into its fused [q|k|v] projection.  Each block writes only its
// own tile: no atomics.
//
// - dq: grid (B*H, ceil(Lq/64)).  Q and G stay; K and V stream.
//   p = exp(s * scale - lse) with s = q.k^T scaled after the dot (the TPU
//   kernel's order), ds = p * (g.v^T - delta), then ds goes through
//   shared memory (in the V buffer) and dq += (ds.k) * scale per tile.
// - dk/dv: grid (B*H, ceil(Lk/64)).  K and V stay; Q, G and the rows'
//   lse and delta stream.  The score tile is computed transposed (key
//   rows by query columns), so P^T and dS^T land in shared memory ready
//   for dv += P^T.G and dk += (dS^T.Q) * scale.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block: 16 x 16
constexpr int PP = BK + 1;  // padded row of a 64x64 probability tile

struct Strides {
  long long b, h, l;      // element strides; the last dim is contiguous
};

// a 64-row tile of a (rows, D) operand into shared memory; rows past
// `nrows` are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int nrows) {
  constexpr int DP = D + 1;
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < 64 * V4; idx += NT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows)
      t = *reinterpret_cast<const float4*>(src + (row0 + r) * row_stride + c);
    float* d = dst + r * DP + c;
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  }
}

template <int D>
constexpr int dq_smem_floats() { return 4 * 64 * (D + 1); }
template <int D>
constexpr int dkv_smem_floats() { return 4 * 64 * (D + 1) + 2 * BK * PP + 2 * BQ; }

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 2 : 1)
attn_dq(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ g,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dq, int H, int Lq, int Lk, Strides sq,
        Strides sk, Strides sv, Strides sg, Strides sdq, float scale) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;
  static_assert(BQ * PP <= BK * DP, "dS tile must fit in the V buffer");
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + BQ * DP;
  float* Ks = Gs + BQ * DP;
  float* Vs = Ks + BK * DP;          // V tile, then the dS tile

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, Lq);
  load_tile<D>(Gs, g + b * sg.b + h * sg.h, sg.l, q0, Lq);

  float lse_r[4], dl_r[4], acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    const long long at = (long long)bh * Lq + row;
    lse_r[r] = row < Lq ? lse[at] : 0.f;
    dl_r[r] = row < Lq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
  }

  const int nblk = (Lk + BK - 1) / BK;
  for (int j = 0; j < nblk; ++j) {
    const int k0 = j * BK;
    __syncthreads();                  // previous dS and K reads are done
    load_tile<D>(Ks, kb, sk.l, k0, Lk);
    load_tile<D>(Vs, vb, sv.l, k0, Lk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = Qs[(ty + 16 * r) * DP + d];
        gv[r] = Gs[(ty + 16 * r) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = Ks[(tx + 16 * c) * DP + d];
        vv[c] = Vs[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(gv[r], vv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = k0 + tx + 16 * c < Lk
                            ? expf(s[r][c] * scale - lse_r[r]) : 0.f;
        s[r][c] = p * (dp[r][c] - dl_r[r]);          // dS
      }

    __syncthreads();                  // every thread is done with V
    float* DSs = Vs;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        DSs[(ty + 16 * r) * PP + tx + 16 * c] = s[r][c];
    __syncthreads();

    float t[4][CPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) t[r][c] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dv_[4], kv[CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv_[r] = DSs[(ty + 16 * r) * PP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) t[r][c] = fmaf(dv_[r], kv[c], t[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] += t[r][c] * scale;
  }

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row < Lq) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        dqb[row * sdq.l + tx + 16 * c] = acc[r][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 2 : 1)
attn_dkv(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ g,
         const float* __restrict__ lse, const float* __restrict__ delta,
         float* __restrict__ dk, float* __restrict__ dv, int H, int Lq,
         int Lk, Strides sq, Strides sk, Strides sv, Strides sg,
         Strides sdk, Strides sdv, float scale) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * DP;
  float* Qs = Vs + BK * DP;
  float* Gs = Qs + BQ * DP;
  float* Ps = Gs + BQ * DP;          // P^T: key rows by query columns
  float* DSs = Ps + BK * PP;         // dS^T
  float* Ls = DSs + BK * PP;         // lse of the query tile's rows
  float* Ds = Ls + BQ;               // delta of the query tile's rows

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* gb = g + b * sg.b + h * sg.h;
  load_tile<D>(Ks, k + b * sk.b + h * sk.h, sk.l, k0, Lk);
  load_tile<D>(Vs, v + b * sv.b + h * sv.h, sv.l, k0, Lk);

  float dka[4][CPT], dva[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dka[r][c] = dva[r][c] = 0.f;

  const int nblk = (Lq + BQ - 1) / BQ;
  for (int i = 0; i < nblk; ++i) {
    const int q0 = i * BQ;
    __syncthreads();                  // previous Q, G, P, dS reads are done
    load_tile<D>(Qs, qb, sq.l, q0, Lq);
    load_tile<D>(Gs, gb, sg.l, q0, Lq);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      const long long at = (long long)bh * Lq + row;
      Ls[threadIdx.x] = row < Lq ? lse[at] : 0.f;
      Ds[threadIdx.x] = row < Lq ? delta[at] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        kv[r] = Ks[(ty + 16 * r) * DP + d];
        vv[r] = Vs[(ty + 16 * r) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qv[c] = Qs[(tx + 16 * c) * DP + d];
        gv[c] = Gs[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(kv[r], qv[c], s[r][c]);
          dp[r][c] = fmaf(vv[r], gv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const float p = q0 + col < Lq
                            ? expf(s[r][c] * scale - Ls[col]) : 0.f;
        Ps[(ty + 16 * r) * PP + col] = p;
        DSs[(ty + 16 * r) * PP + col] = p * (dp[r][c] - Ds[col]);
      }
    __syncthreads();

    float t[4][CPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) t[r][c] = 0.f;
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pr[4], dr[4], gq[CPT], qv[CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pr[r] = Ps[(ty + 16 * r) * PP + qq];
        dr[r] = DSs[(ty + 16 * r) * PP + qq];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        gq[c] = Gs[qq * DP + tx + 16 * c];
        qv[c] = Qs[qq * DP + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dva[r][c] = fmaf(pr[r], gq[c], dva[r][c]);
          t[r][c] = fmaf(dr[r], qv[c], t[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) dka[r][c] += t[r][c] * scale;
  }

  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty + 16 * r;
    if (row < Lk) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        dkb[row * sdk.l + tx + 16 * c] = dka[r][c];
        dvb[row * sdv.l + tx + 16 * c] = dva[r][c];
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

Strides strides(const long long* s) { return Strides{s[0], s[1], s[2]}; }

unsigned tiles(int n, int t) { return (unsigned)((n + t - 1) / t); }

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* g, const float* lse, const float* delta,
                      float* dq, int B, int H, int Lq, int Lk, Strides sq,
                      Strides sk, Strides sv, Strides sg, Strides sdq,
                      float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(attn_dq<D>, dq_smem_floats<D>());
  if (err != cudaSuccess) return err;
  attn_dq<D><<<dim3((unsigned)(B * H), tiles(Lq, BQ)), NT,
               dq_smem_floats<D>() * sizeof(float), stream>>>(
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
  cudaError_t err = allow_smem(attn_dkv<D>, dkv_smem_floats<D>());
  if (err != cudaSuccess) return err;
  attn_dkv<D><<<dim3((unsigned)(B * H), tiles(Lk, BK)), NT,
                dkv_smem_floats<D>() * sizeof(float), stream>>>(
      q, k, v, g, lse, delta, dk, dv, H, Lq, Lk, sq, sk, sv, sg, sdk, sdv,
      scale);
  return cudaGetLastError();
}

#define MXT_F(p) static_cast<const float*>(p)
#define MXT_W(p) static_cast<float*>(p)

}  // namespace

// g and dq as q; lse and delta (B*H, Lq) contiguous.
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
