// Row softmax over the last axis, fp32: y = exp(x - max) / sum(exp(x - max)).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_softmax_kernel` (launched by
// `_softmax_pallas`, entry `softmax_fused`), reached through
// mxnet_tpu/ops/nn.py `softmax` (npx.softmax), which the Gluon BERT's
// attention calls once a layer on its (B, H, T, T) scores.
//
// Bound on an H100: device-memory bytes.  Every element is read once and
// written once (2 * rows * cols * 4 bytes) against a max, a subtract, an
// exp, an add and a divide.  At the Gluon BERT-base serving shape, bucket
// 8 (8 * 12 * 512 rows of 512), that is 201 MB: 0.060 ms at 3.35 TB/s.
//
// Design: the TPU kernel takes blocks of whole rows into VMEM (its rows
// must be a multiple of 128 wide to be routed there).  Here any width is
// taken, by two kernels:
// - cols <= 1024 (the attention rows): one warp owns a row and holds it in
//   registers (16-byte loads when cols % 4 == 0 and the rows are 16-byte
//   aligned, scalar loads otherwise), so the row crosses device memory
//   once each way.  Max and sum are warp shuffles.  Four rows a block.
// - longer rows (a softmax over a vocabulary): one 512-thread block owns a
//   row.  A first pass keeps an online (max, sum) per thread, rescaling
//   the sum when the max grows; the pairs are merged by warp shuffles and
//   then across warps in shared memory.  A second pass reads the row again
//   (mostly from L2) and writes exp(x - max) / sum.
// Both use expf and a true divide, as the plain version does, so they stay
// within 1e-6 of it.  A row whose entries are all the model's finite mask
// value (-1e9) has max -1e9 and gives 1/cols, not NaN.  Both kernels walk
// the rows in a grid-stride loop, so any row count fits in the grid.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpRows = 4;          // rows (warps) per block, short rows
constexpr int kBlockThreads = 512;    // threads per row, long rows
constexpr int kMaxShortCols = 1024;
constexpr unsigned kMaxGrid = 1u << 20;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Merge two online (max, sum) pairs: the sums are rescaled to the larger
// max.  A pair with no elements yet is (-inf, 0).
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
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

// One warp per row, the row in registers: lane l holds the VEC-wide
// vectors l, l + 32, ... (NV of them), so cols <= 32 * NV * VEC.  With
// VEC == 4 the host guarantees cols % 4 == 0: a vector is wholly inside
// the row or wholly past its end.
template <int VEC, int NV>
__global__ void __launch_bounds__(32 * kWarpRows)
softmax_warp_kernel(const float* __restrict__ x, float* __restrict__ y,
                    long long rows, int cols) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarpRows;
  for (long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
       row < rows; row += step) {
    const float* xr = x + row * cols;
    float* yr = y + row * cols;
    float v[NV][VEC];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < cols) {
        load_vec<VEC>(xr + c, v[i]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[i][e] = -INFINITY;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) m = fmaxf(m, v[i][e]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < cols) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[i][e] = expf(v[i][e] - m);
          s += v[i][e];
        }
      }
    }
    s = warp_sum(s);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < cols) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = v[i][e] / s;
        store_vec<VEC>(yr + c, o);
      }
    }
  }
}

// One block per row: an online (max, sum) pass, a block-wide merge, then a
// pass that writes.  With VEC == 4, cols % 4 == 0 and the rows are aligned.
template <int VEC>
__global__ void __launch_bounds__(kBlockThreads)
softmax_block_kernel(const float* __restrict__ x, float* __restrict__ y,
                     long long rows, int cols) {
  __shared__ float sm[kBlockThreads / 32], ss[kBlockThreads / 32];
  __shared__ float row_m, row_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = cols / VEC;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* xr = x + row * cols;
    float* yr = y + row * cols;
    float m = -INFINITY, s = 0.f;
    for (int i = tid; i < nvec; i += kBlockThreads) {
      float v[VEC];
      load_vec<VEC>(xr + i * VEC, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (v[e] > m) {
          s = s * expf(m - v[e]) + 1.f;
          m = v[e];
        } else if (m != -INFINITY) {    // -inf after -inf adds 0
          s += expf(v[e] - m);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      sm[warp] = m;
      ss[warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
      m = lane < kBlockThreads / 32 ? sm[lane] : -INFINITY;
      s = lane < kBlockThreads / 32 ? ss[lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
        merge(m, s, m2, s2);
      }
      if (lane == 0) {
        row_m = m;
        row_s = s;
      }
    }
    __syncthreads();
    m = row_m;
    s = row_s;
    for (int i = tid; i < nvec; i += kBlockThreads) {
      float v[VEC];
      load_vec<VEC>(xr + i * VEC, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = expf(v[e] - m) / s;
      store_vec<VEC>(yr + i * VEC, v);
    }
    // the next row's first barrier orders these reads of row_m/row_s
    // before warp 0 rewrites them
  }
}

unsigned grid_for(long long blocks) {
  return (unsigned)(blocks < (long long)kMaxGrid ? blocks : kMaxGrid);
}

template <int VEC, int NV>
cudaError_t launch_warp(const float* x, float* y, long long rows, int cols,
                        cudaStream_t s) {
  const long long blocks = (rows + kWarpRows - 1) / kWarpRows;
  softmax_warp_kernel<VEC, NV><<<grid_for(blocks), 32 * kWarpRows, 0, s>>>(
      x, y, rows, cols);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch(const float* x, float* y, long long rows, int cols,
                     cudaStream_t s) {
  if (cols > kMaxShortCols) {
    softmax_block_kernel<VEC><<<grid_for(rows), kBlockThreads, 0, s>>>(
        x, y, rows, cols);
    return cudaGetLastError();
  }
  const int per_lane = (cols + 32 * VEC - 1) / (32 * VEC);
  if (per_lane <= 1) return launch_warp<VEC, 1>(x, y, rows, cols, s);
  if (per_lane <= 2) return launch_warp<VEC, 2>(x, y, rows, cols, s);
  if (per_lane <= 4) return launch_warp<VEC, 4>(x, y, rows, cols, s);
  if (per_lane <= 8) return launch_warp<VEC, 8>(x, y, rows, cols, s);
  if constexpr (VEC == 1) {
    if (per_lane <= 16) return launch_warp<1, 16>(x, y, rows, cols, s);
    if (per_lane <= 32) return launch_warp<1, 32>(x, y, rows, cols, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: (rows, cols) row-major fp32, distinct buffers.  vec4 != 0 asks for
// 16-byte loads (host checked cols % 4 == 0 and 16-byte aligned bases).
extern "C" int mxt_softmax_f32(const void* x, void* y, long long rows,
                               int cols, int vec4, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const cudaError_t err = vec4 ? dispatch<4>(xf, yf, rows, cols, s)
                               : dispatch<1>(xf, yf, rows, cols, s);
  return (int)err;
}
