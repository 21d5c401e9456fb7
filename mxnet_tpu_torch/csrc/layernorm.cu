// LayerNorm forward over the last axis, fp32, one warp per row.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_layernorm_kernel`
// (launched by `_layernorm_pallas`), reached through
// mxnet_tpu/ops/nn.py `layer_norm`.
//
// Bound on an H100: device-memory bytes.  Each row is read once and
// written once (2 * rows * C * 4 bytes; gamma/beta are C floats each and
// stay in L1/L2), against a handful of flops per element.  At the GPT
// prefill shape (4096, 768) that is 25.2 MB; at the decode shapes
// (1 or 8, 768) the kernel is bound by launch latency instead.
//
// Design: a warp owns a row and keeps the whole row in registers (16-byte
// loads when the row is 16-byte aligned, scalar loads otherwise), so the
// row crosses device memory exactly once each way.  The statistics are
// two-pass in registers, as the TPU kernel computes them: the mean first,
// then the centred variance mean((x - mu)^2) (not E[x^2] - mu^2), both
// reduced with warp shuffles; then (x - mu) * rsqrt(var + eps) * g + b.
// Four rows per 128-thread block; any row count, any C up to 4096.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    out[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    *p = in[0];
  }
}

// VEC floats per load; NV loads per lane cover C <= 32 * NV * VEC.
// With VEC == 4 the host guarantees C % 4 == 0, so a vector is either
// wholly inside the row or wholly past its end.
template <int VEC, int NV>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
layernorm_fwd(const float* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ y,
              long long rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * C;
  float* yr = y + row * C;

  float v[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * VEC;
    if (c < C) {
      load_vec<VEC>(xr + c, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sum += v[i][e];
  }
  const float mean = warp_sum(sum) / (float)C;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * VEC;
    if (c < C) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = v[i][e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)C + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * VEC;
    if (c < C) {
      float g[VEC], b[VEC], o[VEC];
      load_vec<VEC>(gamma + c, g);
      load_vec<VEC>(beta + c, b);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[e] = (v[i][e] - mean) * rstd * g[e] + b[e];
      store_vec<VEC>(yr + c, o);
    }
  }
}

template <int VEC, int NV>
cudaError_t launch(const float* x, const float* g, const float* b, float* y,
                   long long rows, int C, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layernorm_fwd<VEC, NV><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                           stream>>>(x, g, b, y, rows, C, eps);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch(const float* x, const float* g, const float* b,
                     float* y, long long rows, int C, float eps,
                     cudaStream_t s) {
  const int per_lane = (C + 32 * VEC - 1) / (32 * VEC);
  if (per_lane <= 1) return launch<VEC, 1>(x, g, b, y, rows, C, eps, s);
  if (per_lane <= 2) return launch<VEC, 2>(x, g, b, y, rows, C, eps, s);
  if (per_lane <= 4) return launch<VEC, 4>(x, g, b, y, rows, C, eps, s);
  if (per_lane <= 8) return launch<VEC, 8>(x, g, b, y, rows, C, eps, s);
  if (per_lane <= 16) return launch<VEC, 16>(x, g, b, y, rows, C, eps, s);
  if (per_lane <= 32) return launch<VEC, 32>(x, g, b, y, rows, C, eps, s);
  if constexpr (VEC == 1) {
    if (per_lane <= 64) return launch<1, 64>(x, g, b, y, rows, C, eps, s);
    if (per_lane <= 128) return launch<1, 128>(x, g, b, y, rows, C, eps, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: (rows, C) row-major fp32; gamma, beta: (C,) fp32.  vec4 != 0 asks
// for 16-byte loads (host checked C % 4 == 0 and 16-byte aligned bases).
extern "C" int mxt_layernorm_f32(const void* x, const void* gamma,
                                 const void* beta, void* y, long long rows,
                                 int C, float eps, int vec4, void* stream) {
  if (rows <= 0 || C <= 0 || C > 4096) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(gamma);
  const float* bf = static_cast<const float*>(beta);
  float* yf = static_cast<float*>(y);
  const cudaError_t err =
      vec4 ? dispatch<4>(xf, gf, bf, yf, rows, C, eps, s)
           : dispatch<1>(xf, gf, bf, yf, rows, C, eps, s);
  return (int)err;
}

// The name of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
