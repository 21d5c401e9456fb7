// The flash-attention forward on Hopper's tensor cores in 3xTF32, fp32 in
// and out, online softmax, templated on the mask: the causal forward
// (causal_attention.cu) and the non-causal forward with its row
// logsumexp (flash_fwd_tc.cu) are this one body.
//
// Design (FlashAttention-2 on `mma.sync.m16n8k8` TF32, tf32x3.cuh):
// - Grid (B*H, ceil(Lq / 64)); a block of 4 warps owns 64 query rows, a
//   warp 16.  The causal kernel runs the heaviest query tiles (the end of
//   the sequence) first; without the mask every tile does the same work,
//   and they run in order.
// - 3xTF32: every fp32 operand is split into TF32 hi and lo and each
//   product is lo*hi' + hi*lo' + hi*hi'.  q is scaled first, as the TPU
//   kernels scale it before the dot, and the scaled Q tile is split once
//   into shared memory (hi and lo planes); K and V are split on their
//   fragment reads.
// - S = Q.K^T for 32 keys at a time into fragments in registers, its
//   D-long chain gathered 32 deep at a time in a run accumulator from
//   zero and added with IEEE adds (the tensor core truncates its own fp32
//   sums).  The online softmax (running max and sum, expf) runs in fp32
//   on the fragments: a row's values lie in a quad of lanes, reduced with
//   shuffles.
// - P.V: the accumulator layout of S (lane (g, t) holds keys 2t, 2t + 1)
//   is not the A-fragment layout (keys t, t + 4), so the k index of each
//   8-key step is permuted: A's k = t is key 2t and k = t + 4 is key
//   2t + 1, and V's B fragment reads rows 2t and 2t + 1 to match.  P
//   stays in registers, split hi/lo.  Each key tile's P.V (12 products a
//   chain) starts from zero in a run accumulator, half of D at a time,
//   and O = O * corr + run with a rounded fma.
// - K and V tiles (32 rows) stream through `cp.async` 16-byte copies,
//   staggered so one loads while the other is read: K_{j+1} while the
//   softmax and P.V_j run, V_{j+1} while S_{j+1} runs.  K_0 and V_0 are
//   asked for before the Q tile is split, so the first loads overlap the
//   split.  With the mask, only key tiles up to the block's diagonal are
//   read, and a warp skips a tile that all its rows mask.  Shared-memory
//   rows are D + 4 floats apart, so the fragment reads of a warp hit 32
//   banks: ~99 KB at D = 128, ~51 KB at D = 64.
// - Masked scores are the finite -1e30, as in the TPU kernels, so exp()
//   underflows to exactly 0 and no row NaNs.  Columns past Lk are masked
//   and rows past Lq are not written, so any L works.  The causal mask is
//   top-left: key j is visible to query i iff j <= i.
// - Without the mask the kernel also writes each row's logsumexp,
//   m + log(l) in fp32, to a contiguous (B*H, Lq) buffer: the backward
//   kernels (flash_bwd_tc.cu) recompute P from it.
// - q/k/v/o take arbitrary (batch, head, row) strides and a unit last-dim
//   stride, so the GPT prefill and BERT pass views into their fused qkv
//   projections and receive the output already in (B, L, H, D) order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

extern __shared__ __align__(16) unsigned char mxt_flash_smem[];

namespace {

using namespace mxt_tf32;

constexpr int BQ = 64;     // query rows a block, 16 a warp
constexpr int BKV = 32;    // key rows a streamed tile
constexpr int NT = 128;    // threads a block: 4 warps
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, l;      // element strides; the last dim is contiguous
};

template <int D>
struct Smem {
  uint32_t qhi[BQ][D + 4];   // the scaled Q tile, split once
  uint32_t qlo[BQ][D + 4];
  float k[BKV][D + 4];
  float v[BKV][D + 4];
};

// copy key rows row0 .. row0 + BKV - 1 of src into dst, zero past nrows
template <int D>
__device__ __forceinline__ void load_kv(float (*dst)[D + 4], const float* src,
                                        long long row_stride, int row0,
                                        int nrows) {
  constexpr int V4 = D / 4;
#pragma unroll
  for (int i = 0; i < BKV * V4 / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / V4, c = (idx % V4) * 4;
    const bool ok = row0 + r < nrows;
    cp_async16(&dst[r][c], ok ? src + (row0 + r) * row_stride + c : src, ok);
  }
}

// lse is written only without the mask (the causal caller passes null)
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_tc(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int H, int Lq, int Lk, Strides sq,
             Strides sk, Strides sv, Strides so, float scale) {
  constexpr int NO = D / 8;         // output fragments a warp
  constexpr int V4 = D / 4;
  Smem<D>& s = *reinterpret_cast<Smem<D>*>(mxt_flash_smem);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp * 16;         // the warp's first row in the tile

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;

  // keys [0, kend) are visible to some row of this tile
  const int kend = CAUSAL ? min(min(q0 + BQ, Lq), Lk) : Lk;
  const int nblk = (kend + BKV - 1) / BKV;

  load_kv<D>(s.k, kb, sk.l, 0, Lk);
  cp_async_commit();
  load_kv<D>(s.v, vb, sv.l, 0, Lk);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < BQ * V4; idx += NT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Lq)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * sq.l + c);
    uint4 hi, lo;
    split(x.x * scale, hi.x, lo.x);
    split(x.y * scale, hi.y, lo.y);
    split(x.z * scale, hi.z, lo.z);
    split(x.w * scale, hi.w, lo.w);
    *reinterpret_cast<uint4*>(&s.qhi[r][c]) = hi;
    *reinterpret_cast<uint4*>(&s.qlo[r][c]) = lo;
  }

  // rows rw + g (fragment entries 0, 1) and rw + g + 8 (entries 2, 3)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int ni = 0; ni < NO; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    const int k0 = j * BKV;
    // warp-uniform: some row of the warp is in range (and, with the mask,
    // sees key k0)
    const bool active =
        q0 + rw < Lq && (!CAUSAL || k0 <= q0 + rw + 15);
    cp_async_wait<1>();             // K_j (and Q, the first time)
    __syncthreads();

    float p[BKV / 8][4];
    if (active) {
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[ni][e] = 0.f;
#pragma unroll
      for (int dc = 0; dc < D; dc += 32) {
        float run[BKV / 8][4];
#pragma unroll
        for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) run[ni][e] = 0.f;
#pragma unroll
        for (int d0 = dc; d0 < dc + 32; d0 += 8) {
          const uint32_t ahi[4] = {
              s.qhi[rw + g][d0 + t], s.qhi[rw + g + 8][d0 + t],
              s.qhi[rw + g][d0 + t + 4], s.qhi[rw + g + 8][d0 + t + 4]};
          const uint32_t alo[4] = {
              s.qlo[rw + g][d0 + t], s.qlo[rw + g + 8][d0 + t],
              s.qlo[rw + g][d0 + t + 4], s.qlo[rw + g + 8][d0 + t + 4]};
#pragma unroll
          for (int ni = 0; ni < BKV / 8; ++ni) {
            uint32_t bhi[2], blo[2];
            split(s.k[ni * 8 + g][d0 + t], bhi[0], blo[0]);
            split(s.k[ni * 8 + g][d0 + t + 4], bhi[1], blo[1]);
            mma_3xtf32(run[ni], ahi, alo, bhi, blo);
          }
        }
#pragma unroll
        for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[ni][e] = __fadd_rn(p[ni][e], run[ni][e]);
      }
    }
    __syncthreads();                // every warp is done with K_j
    if (j + 1 < nblk) load_kv<D>(s.k, kb, sk.l, k0 + BKV, Lk);
    cp_async_commit();

    float corr[2] = {1.f, 1.f};
    if (active) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = q0 + rw + g + 8 * hf;
        float mx = -INFINITY;
#pragma unroll
        for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + ni * 8 + 2 * t + e;
            float& sv_ = p[ni][2 * hf + e];
            if ((CAUSAL && col > row) || col >= Lk) sv_ = kNegInf;
            mx = fmaxf(mx, sv_);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hf], mx);
        corr[hf] = expf(m[hf] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& sv_ = p[ni][2 * hf + e];
            sv_ = expf(sv_ - m_new);
            sum += sv_;
          }
        l[hf] = l[hf] * corr[hf] + sum;   // this lane's share of the row
        m[hf] = m_new;
      }
    }

    cp_async_wait<1>();             // V_j
    __syncthreads();
    if (active) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float run[NO / 2][4];
#pragma unroll
        for (int ni = 0; ni < NO / 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) run[ni][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < BKV / 8; ++ks) {
          // A's k = t is key 2t, k = t + 4 key 2t + 1 of this 8-key step
          uint32_t phi[4], plo[4];
          split(p[ks][0], phi[0], plo[0]);
          split(p[ks][2], phi[1], plo[1]);
          split(p[ks][1], phi[2], plo[2]);
          split(p[ks][3], phi[3], plo[3]);
#pragma unroll
          for (int ni = 0; ni < NO / 2; ++ni) {
            const int col = half * (D / 2) + ni * 8 + g;
            uint32_t bhi[2], blo[2];
            split(s.v[ks * 8 + 2 * t][col], bhi[0], blo[0]);
            split(s.v[ks * 8 + 2 * t + 1][col], bhi[1], blo[1]);
            mma_3xtf32(run[ni], phi, plo, bhi, blo);
          }
        }
#pragma unroll
        for (int ni = 0; ni < NO / 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& a = acc[half * (NO / 2) + ni][e];
            a = __fmaf_rn(a, corr[e >> 1], run[ni][e]);
          }
      }
    }
    __syncthreads();                // every warp is done with V_j
    if (j + 1 < nblk) load_kv<D>(s.v, vb, sv.l, k0 + BKV, Lk);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const int row = q0 + rw + g + 8 * hf;
    if (row < Lq) {
      float* orow = ob + row * so.l;
#pragma unroll
      for (int ni = 0; ni < NO; ++ni)
        *reinterpret_cast<float2*>(orow + ni * 8 + 2 * t) =
            make_float2(acc[ni][2 * hf] / l[hf], acc[ni][2 * hf + 1] / l[hf]);
      if (!CAUSAL && t == 0)
        lse[(long long)bh * Lq + row] = m[hf] + logf(l[hf]);
    }
  }
}

template <int D, bool CAUSAL>
cudaError_t launch_flash_fwd(const float* q, const float* k, const float* v,
                             float* o, float* lse, int B, int H, int Lq,
                             int Lk, Strides sq, Strides sk, Strides sv,
                             Strides so, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Lq + BQ - 1) / BQ));
  flash_fwd_tc<D, CAUSAL><<<grid, NT, smem, stream>>>(
      q, k, v, o, lse, H, Lq, Lk, sq, sk, sv, so, scale);
  return cudaGetLastError();
}

// the body of both C entries (their arguments are described there)
template <bool CAUSAL>
int flash_fwd_entry(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int H, int Lq, int Lk, int D,
                    const long long* q_strides, const long long* k_strides,
                    const long long* v_strides, const long long* o_strides,
                    float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides sq{q_strides[0], q_strides[1], q_strides[2]};
  const Strides sk{k_strides[0], k_strides[1], k_strides[2]};
  const Strides sv{v_strides[0], v_strides[1], v_strides[2]};
  const Strides so{o_strides[0], o_strides[1], o_strides[2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return (int)launch_flash_fwd<64, CAUSAL>(qf, kf, vf, of, lf, B, H, Lq,
                                               Lk, sq, sk, sv, so, scale, s);
    case 128:
      return (int)launch_flash_fwd<128, CAUSAL>(qf, kf, vf, of, lf, B, H,
                                                Lq, Lk, sq, sk, sv, so,
                                                scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
