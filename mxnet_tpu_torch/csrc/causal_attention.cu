// Causal flash-attention forward, fp32 in and out, on Hopper's tensor
// cores in 3xTF32, online softmax.
//
// Replaces: mxnet_tpu/ops/pallas_attention.py `_causal_attn_kernel`
// (:203, launched by `_causal_attention_pallas` :248), reached through
// mxnet_tpu/models/gpt.py `_layer_prefill`.
//
// Bounds on an H100.  For (B*H, L, D) = (48, 512, 128) the causal half is
// 2 * 2 * 48 * (512 * 513 / 2) * 128 = 3.23 GFLOP against 50 MB of
// q/k/v/o: 0.0482 ms at the 67 TFLOP/s fp32 CUDA-core peak, 0.015 ms at
// 3.35 TB/s.  This kernel does three TF32 products for each fp32 one:
// 9.7 GFLOP, 0.0196 ms at the 495 TFLOP/s dense TF32 peak (0.030 ms at
// the 323.8 TFLOP/s `mma.sync` TF32 ceiling measured on the card), so
// operations bound it.
//
// Design (FlashAttention-2 on `mma.sync.m16n8k8` TF32, tf32x3.cuh):
// - Grid (B*H, ceil(Lq / 64)), heaviest query tiles (the end of the
//   sequence) first; a block of 4 warps owns 64 query rows, a warp 16.
//   At L = 512 that is 48 blocks at B = 1 (6 heads: most of the 132 SMs
//   idle) and 384 at B = 8, two blocks an SM.
// - 3xTF32: every fp32 operand is split into TF32 hi and lo and each
//   product is lo*hi' + hi*lo' + hi*hi'.  q is scaled first, as the TPU
//   kernel scales it before the dot, and the scaled Q tile is split once
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
//   softmax and P.V_j run, V_{j+1} while S_{j+1} runs.  Only key tiles up
//   to the block's diagonal are read; a warp skips a tile that all its
//   rows mask.  Shared-memory rows are D + 4 floats apart, so the
//   fragment reads of a warp hit 32 banks.  ~99 KB at D = 128.
// - Masked scores are the finite -1e30, as in the TPU kernel, so exp()
//   underflows to exactly 0 and no row NaNs; columns past Lk and rows
//   past Lq are masked here, so any L works.  The mask is top-left: key
//   j is visible to query i iff j <= i.  q/k/v/o take arbitrary (batch,
//   head, row) strides and a unit last-dim stride, so the GPT prefill
//   passes views into its fused qkv projection and receives its output
//   already in (B, L, H, D) order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

extern __shared__ __align__(16) unsigned char mxt_causal_smem[];

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

template <int D>
__global__ void __launch_bounds__(NT, 2)
causal_attn_fwd(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int H,
                int Lq, int Lk, Strides sq, Strides sk, Strides sv,
                Strides so, float scale) {
  constexpr int NO = D / 8;         // output fragments a warp
  constexpr int V4 = D / 4;
  Smem<D>& s = *reinterpret_cast<Smem<D>*>(mxt_causal_smem);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp * 16;         // the warp's first row in the tile

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;

  // keys [0, kend) are visible to some row of this tile
  const int kend = min(min(q0 + BQ, Lq), Lk);
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
    // warp-uniform: some row of the warp is in range and sees key k0
    const bool active = q0 + rw < Lq && k0 <= q0 + rw + 15;
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
            if (col > row || col >= Lk) sv_ = kNegInf;
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
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int H, int Lq, int Lk, Strides sq, Strides sk,
                   Strides sv, Strides so, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<D>);
  cudaError_t err = cudaFuncSetAttribute(
      causal_attn_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((Lq + BQ - 1) / BQ));
  causal_attn_fwd<D><<<grid, NT, smem, stream>>>(q, k, v, o, H, Lq, Lk, sq,
                                                 sk, sv, so, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, H, Lq, D); k, v: (B, H, Lk, D); fp32.  Each stride array is
// (batch, head, row) in elements; the last dim is contiguous.  The host
// checked that every row starts 16-byte aligned.
extern "C" int mxt_causal_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Lq, int Lk, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, float scale, void* stream) {
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
  switch (D) {
    case 64:
      return (int)launch<64>(qf, kf, vf, of, B, H, Lq, Lk, sq, sk, sv, so,
                             scale, s);
    case 128:
      return (int)launch<128>(qf, kf, vf, of, B, H, Lq, Lk, sq, sk, sv, so,
                              scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
