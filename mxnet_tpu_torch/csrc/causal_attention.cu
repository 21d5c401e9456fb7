// Causal flash-attention forward, fp32, online softmax.
//
// Replaces: mxnet_tpu/ops/pallas_attention.py `_causal_attn_kernel`
// (launched by `_causal_attention_pallas`), reached through
// mxnet_tpu/models/gpt.py `_layer_prefill`.
//
// Bound on an H100: arithmetic.  For (B*H, L, D) = (48, 512, 128) the
// causal half is 2 * 2 * 48 * (512 * 513 / 2) * 128 = 3.2 GFLOP against
// 50 MB of q/k/v/o, about 64 flops a byte; this kernel does its fp32
// FMAs on the CUDA cores (67 TFLOP/s peak), so the flops bound it there,
// not the 3.35 TB/s of device memory.  At B = 1 (6 heads) the grid has
// only 48 blocks for 132 SMs, and it is bound by latency.
//
// Design: grid (B*H, ceil(Lq / 64)); a 256-thread block owns a 64-row
// query tile.  The Q tile (pre-scaled, as the TPU kernel scales q before
// the dot) sits in shared memory for the whole block; K and V stream
// through shared memory 64 rows at a time, only up to the last key tile
// that meets the tile's diagonal, so the (L, L) score matrix never
// reaches device memory and the blocks above the diagonal are never read.
// Each thread owns a 4x4 piece of the 64x64 score tile (rows ty + 16r,
// columns tx + 16c) and a 4 x D/16 piece of the output accumulator; the
// running max and sum per row live in registers of the 16 threads that
// share the row and are reduced with half-warp shuffles.  Probabilities
// go through shared memory (reusing the K buffer) for the P.V product.
// Rows are padded by one float in shared memory so the column-strided
// reads hit 16 different banks.  Masked scores are the finite -1e30, as
// in the TPU kernel, so exp() underflows to exactly 0 and no row NaNs;
// columns past Lk and rows past Lq are masked here, so any L works.  The
// mask is top-left aligned: key j is visible to query i iff j <= i.
// The heaviest query tiles (near the end of the sequence) are scheduled
// first.  q/k/v/o are taken with arbitrary (batch, head, row) strides and
// a unit last-dim stride, so the GPT prefill passes views into its fused
// qkv projection and receives its output already in (B, L, H, D) order.
// Shared memory is ~97 KB (D = 128), so the launch raises the dynamic
// shared-memory limit first.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per streamed tile
constexpr int NT = 256;   // threads per block: 16 x 16
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, l;      // element strides; the last dim is contiguous
};

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + 2 * BK * (D + 1);
}

template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int nrows, float scale) {
  constexpr int DP = D + 1;
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < BQ * V4; idx += NT) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows)
      t = *reinterpret_cast<const float4*>(src + (row0 + r) * row_stride + c);
    float* d = dst + r * DP + c;
    d[0] = t.x * scale; d[1] = t.y * scale;
    d[2] = t.z * scale; d[3] = t.w * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
causal_attn_fwd(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int H,
                int Lq, int Lk, Strides sq, Strides sk, Strides sv,
                Strides so, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;        // padded row of the probability tile
  constexpr int CPT = D / 16;       // output columns per thread
  static_assert(BQ * PP <= BK * DP, "P tile must fit in the K buffer");
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;         // K tile, then the P tile
  float* Vs = Ks + BK * DP;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;

  load_tile<D>(Qs, qb, sq.l, q0, Lq, scale);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
  }

  // keys [0, kend) are visible to some row of this tile
  const int kend = min(min(q0 + BQ, Lq), Lk);
  const int nblk = (kend + BK - 1) / BK;
  for (int j = 0; j < nblk; ++j) {
    const int k0 = j * BK;
    __syncthreads();                  // previous P and V reads are done
    load_tile<D>(Ks, kb, sk.l, k0, Lk, 1.f);
    load_tile<D>(Vs, vb, sv.l, k0, Lk, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty + 16 * r) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        if (col > row || col >= Lk) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr[r] + sum;
      m[r] = m_new;
    }

    __syncthreads();                  // every thread is done with K
    float* Ps = Ks;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Ps[(ty + 16 * r) * PP + tx + 16 * c] = s[r][c];
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] *= corr[r];
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty + 16 * r) * PP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[kk * DP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row < Lq) {
      float* orow = ob + row * so.l;
#pragma unroll
      for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = acc[r][c] / l[r];
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int H, int Lq, int Lk, Strides sq, Strides sk,
                   Strides sv, Strides so, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      causal_attn_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
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
