// Row softmax over the last axis, fp32: y = exp(x - max) / sum(exp(x - max)),
// with an optional prologue x -> where(keep, x / div, -1e9).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_softmax_kernel` (launched by
// `_softmax_pallas`, entry `softmax_fused`), reached through
// mxnet_tpu/ops/nn.py `softmax` (npx.softmax), which the Gluon BERT's
// attention calls once a layer on its (B, H, T, T) scores after dividing
// them by sqrt(head dim) and masking the keys with -1e9
// (mxnet_tpu/models/bert_gluon.py).  Here that division and mask are the
// kernels' prologue: applied to each element as it is loaded, so they cost
// no pass of their own.  The division is IEEE (`__fdiv_rn`), as XLA and
// the CPU divide; with no prologue the kernels compute exactly the TPU
// kernel's function.
//
// Bound on an H100: device-memory bytes.  Every element is read once and
// written once (2 * rows * cols * 4 bytes, plus the mask's bytes) against
// a max, a subtract, an exp, an add and a divide (and the prologue's
// divide).  At the Gluon BERT-base serving shape, bucket 8 (8 * 12 * 512
// rows of 512), that is 201 MB: 0.060 ms at 3.35 TB/s; a vocabulary row
// block (4096, 30522) is 1.0 GB: 0.299 ms.
//
// Design: the TPU kernel takes blocks of whole rows into VMEM (its rows
// must be a multiple of 128 wide to be routed there).  An SM holds far
// less, so a row is held on chip by as many SMs as it needs:
// - cols <= 1024 (the attention rows): one warp owns a row and holds it in
//   registers, so the row crosses device memory once each way.  Max and
//   sum are warp shuffles.  Four rows a block.
// - 1024 < cols <= 65536 (a softmax over a vocabulary): a thread-block
//   cluster of n CTAs (n in {1, 2, 4, 8}, the smallest whose slices fit a
//   CTA's 8192 floats) owns a row.  Each CTA of 256 threads loads its
//   contiguous slice once into registers (32 floats a thread at most, 4
//   CTAs an SM), takes the slice's max, and the CTAs merge their maxes
//   through distributed shared memory;
//   then each computes exp(x - max) once an element, kept in registers,
//   and the slice sums are merged the same way, in rank order, so every
//   CTA holds the same sum and a relaunch gives the same bits.  Then each
//   writes its slice.  The row crosses device memory once each way.
// - wider rows: one 512-thread block owns a row.  A first pass keeps an
//   online (max, sum) per thread, rescaling the sum when the max grows;
//   the pairs are merged by warp shuffles and then across warps in shared
//   memory.  A second pass reads the row again and writes exp(x - max) /
//   sum.
// Loads and stores move 4 floats where cols % 4 == 0 and the rows are
// 16-byte aligned, else 1.
// With the prologue, every load of a thread is issued before its first
// division (IEEE division branches to a slow path, which would otherwise
// hold each load back), and the mask's bytes become one bit a column; a
// power-of-two divisor (sqrt(64)) is a multiply by its exact reciprocal,
// which rounds the same.  All use expf and a true divide, as the plain
// version does, so they stay within 1e-6 of it; a 0 numerator (a masked
// key) skips the divide.  A row whose entries are all the model's finite
// mask value (-1e9) has max -1e9 and gives 1/cols, not NaN.  Each kernel
// walks the rows in a grid-stride loop, so any row count fits in the grid.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpRows = 4;          // rows (warps) per block, short rows
constexpr int kMaxShortCols = 1024;
constexpr int kClusterThreads = 256;  // threads a CTA, cluster rows
constexpr int kSliceMax = 8192;       // floats a CTA holds: 32 a thread
constexpr int kMaxCluster = 8;        // the largest portable cluster
constexpr int kMaxClusterCols = kMaxCluster * kSliceMax;
constexpr int kBlockThreads = 512;    // threads per row, widest rows
constexpr unsigned kMaxGrid = 1u << 20;
constexpr float kMasked = -1e9f;      // the model's finite mask value

// What every kernel takes: x, y (rows, cols) row-major; the prologue's
// divisor and keep mask (rows / per, cols) of 0/1 bytes, row r of x using
// mask row r / per (nullptr: every key kept).
struct Args {
  const float* x;
  float* y;
  long long rows;
  int cols;
  float div;
  float recip;                          // 1 / div where that is exact, else 0
  const uint8_t* keep;
  long long per;
};

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

// e / s (IEEE) for e = exp(x - max) and the row's sum s >= 1: an e of 0
// (a masked key) skips the division and gives the same 0.  Rows with masked
// keys measured about a third slower where their zeros were divided, and
// as slow with a select after an unconditional division.
__device__ __forceinline__ float quotient(float e, float s) {
  return e == 0.f ? 0.f : e / s;
}

// The prologue on one element: x / div (IEEE), or -1e9 where masked (and
// then no division).  Where div is a power of two (sqrt(64) = 8) its
// reciprocal is exact and x * (1 / div) is the same correctly rounded
// quotient, without the division's dozen instructions.
__device__ __forceinline__ float prologue(float x, float div, float recip,
                                          bool masked) {
  if (masked) return kMasked;
  return recip != 0.f ? x * recip : __fdiv_rn(x, div);
}

// VEC consecutive floats from p (VEC-aligned by the host).
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

// Bit e set where mask byte p[e] of the VEC at p is 0 (a masked key).
template <int VEC>
__device__ __forceinline__ uint32_t masked_bits(const uint8_t* p) {
  if constexpr (VEC == 4) {
    const uchar4 t = *reinterpret_cast<const uchar4*>(p);
    return (uint32_t)(t.x == 0) | (uint32_t)(t.y == 0) << 1 |
           (uint32_t)(t.z == 0) << 2 | (uint32_t)(t.w == 0) << 3;
  } else {
    return (uint32_t)(*p == 0);
  }
}

// The row's mask row, or nullptr when every key is kept.
template <bool PRO>
__device__ __forceinline__ const uint8_t* keep_row(const Args& a,
                                                   long long row) {
  if constexpr (PRO) {
    if (a.keep) return a.keep + (row / a.per) * a.cols;
  }
  return nullptr;
}

// Load the VEC elements at column c of row xr, with the prologue when PRO:
// where(keep, x / div, -1e9) (the block kernel's loads).  c and the mask
// row are multiples of VEC, and the mask's base is VEC-aligned
// (host-checked).
template <int VEC, bool PRO>
__device__ __forceinline__ void load_row(const float* xr, const uint8_t* kr,
                                         int c, float div, float recip,
                                         float* out) {
  load_vec<VEC>(xr + c, out);
  if constexpr (PRO) {
    const uint32_t masked = kr ? masked_bits<VEC>(kr + c) : 0u;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out[e] = prologue(out[e], div, recip, (masked >> e) & 1u);
  }
}

// A thread's share of a row held in registers: the NV VEC-wide vectors at
// columns first + i * STRIDE * VEC, those at or past `end` set to -inf;
// returns their max.  With PRO the prologue follows once every load is in
// flight (IEEE division has a slow-path branch that would otherwise hold
// each load back behind the last one's divide): the keep bytes are folded
// into one bit a column as they arrive (NV * VEC <= 32).
template <int VEC, int NV, bool PRO, int STRIDE>
__device__ __forceinline__ float load_share(const float* xr,
                                            const uint8_t* kr, int first,
                                            int end, float div, float recip,
                                            float (&v)[NV][VEC]) {
  static_assert(NV * VEC <= 32, "one mask bit a column");
  uint32_t masked = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = first + i * STRIDE * VEC;
    if (c < end) {
      load_vec<VEC>(xr + c, v[i]);
      if (PRO && kr) masked |= masked_bits<VEC>(kr + c) << (i * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[i][e] = -INFINITY;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if constexpr (PRO) {
      if (first + i * STRIDE * VEC < end) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          v[i][e] = prologue(v[i][e], div, recip,
                             (masked >> (i * VEC + e)) & 1u);
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) m = fmaxf(m, v[i][e]);
  }
  return m;
}

// One warp per row, the row in registers: lane l holds the VEC-wide
// vectors l, l + 32, ... (NV of them), so cols <= 32 * NV * VEC.  The
// host guarantees cols % VEC == 0: a vector is wholly inside the row or
// wholly past its end.
template <int VEC, int NV, bool PRO>
__global__ void __launch_bounds__(32 * kWarpRows)
softmax_warp_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int cols = a.cols;
  const long long step = (long long)gridDim.x * kWarpRows;
  for (long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
       row < a.rows; row += step) {
    const float* xr = a.x + row * cols;
    float* yr = a.y + row * cols;
    const uint8_t* kr = keep_row<PRO>(a, row);
    float v[NV][VEC];
    const float m =
        warp_max(load_share<VEC, NV, PRO, 32>(xr, kr, lane * VEC, cols,
                                              a.div, a.recip, v));
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
        for (int e = 0; e < VEC; ++e) o[e] = quotient(v[i][e], s);
        store_vec<VEC>(yr + c, o);
      }
    }
  }
}

// The cluster's part of a row: a cluster of n CTAs owns a row, CTA r
// (its rank) the columns [r * slice, min(cols, (r + 1) * slice)), thread t
// the VEC-wide vectors t, t + 256, ... of the slice (NV of them).  A
// reduction is warp shuffles, then the 8 warps in order by thread 0 into
// this CTA's slot, then the n slots in rank order through distributed
// shared memory, read by every thread.  Slots alternate by row parity, so
// two cluster barriers a row keep a slot from being rewritten while
// another CTA may still read it; a last barrier keeps every CTA's shared
// memory alive until the others are done with it.  The host guarantees
// cols % VEC == 0 and slice % VEC == 0.
template <int VEC, int NV, bool PRO>
__global__ void __launch_bounds__(kClusterThreads, 4)
softmax_cluster_kernel(const Args a, int n, int slice) {
  __shared__ float red[kClusterThreads / 32];
  __shared__ float slot[2][2];          // [row parity][max, sum]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cols = a.cols;
  const int c0 = rank * slice;
  const int c1 = min(cols, c0 + slice);
  const long long step = gridDim.x / n;
  int p = 0;
  for (long long row = blockIdx.x / n; row < a.rows; row += step, p ^= 1) {
    const float* xr = a.x + row * cols;
    float* yr = a.y + row * cols;
    const uint8_t* kr = keep_row<PRO>(a, row);
    float v[NV][VEC];
    float m = warp_max(load_share<VEC, NV, PRO, kClusterThreads>(
        xr, kr, c0 + tid * VEC, c1, a.div, a.recip, v));
    if (lane == 0) red[warp] = m;
    __syncthreads();
    if (tid == 0) {
      float bm = red[0];
#pragma unroll
      for (int w = 1; w < kClusterThreads / 32; ++w) bm = fmaxf(bm, red[w]);
      slot[p][0] = bm;
    }
    cluster.sync();
    m = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n) m = fmaxf(m, *cluster.map_shared_rank(&slot[p][0], r));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = c0 + (i * kClusterThreads + tid) * VEC;
      if (c < c1) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[i][e] = expf(v[i][e] - m);
          s += v[i][e];
        }
      }
    }
    s = warp_sum(s);
    if (lane == 0) red[warp] = s;     // thread 0 read the maxes before
    __syncthreads();                  // the cluster barrier
    if (tid == 0) {
      float bs = red[0];
#pragma unroll
      for (int w = 1; w < kClusterThreads / 32; ++w) bs += red[w];
      slot[p][1] = bs;
    }
    cluster.sync();
    s = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n) s += *cluster.map_shared_rank(&slot[p][1], r);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = c0 + (i * kClusterThreads + tid) * VEC;
      if (c < c1) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = quotient(v[i][e], s);
        store_vec<VEC>(yr + c, o);
      }
    }
  }
  cluster.sync();
}

// One block per row: an online (max, sum) pass, a block-wide merge, then a
// pass that reads the row again and writes.  cols % VEC == 0 and the rows
// are VEC-aligned.
template <int VEC, bool PRO>
__global__ void __launch_bounds__(kBlockThreads)
softmax_block_kernel(const Args a) {
  __shared__ float sm[kBlockThreads / 32], ss[kBlockThreads / 32];
  __shared__ float row_m, row_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cols = a.cols;
  const int nvec = cols / VEC;
  for (long long row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const float* xr = a.x + row * cols;
    float* yr = a.y + row * cols;
    const uint8_t* kr = keep_row<PRO>(a, row);
    float m = -INFINITY, s = 0.f;
    for (int i = tid; i < nvec; i += kBlockThreads) {
      float v[VEC];
      load_row<VEC, PRO>(xr, kr, i * VEC, a.div, a.recip, v);
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
      load_row<VEC, PRO>(xr, kr, i * VEC, a.div, a.recip, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = quotient(expf(v[e] - m), s);
      store_vec<VEC>(yr + i * VEC, v);
    }
    // the next row's first barrier orders these reads of row_m/row_s
    // before warp 0 rewrites them
  }
}

unsigned grid_for(long long blocks) {
  return (unsigned)(blocks < (long long)kMaxGrid ? blocks : kMaxGrid);
}

// Which kernel takes rows of `cols`: 0 the warp kernel, 1 the cluster
// kernel with n CTAs of `slice` columns each (a multiple of vec), 2 the
// two-pass block kernel.
struct Plan {
  int kind, n, slice;
};

Plan plan_for(int cols, int vec) {
  if (cols <= kMaxShortCols) return {0, 0, 0};
  if (cols > kMaxClusterCols) return {2, 0, 0};
  for (int n = 1;; n *= 2) {
    const int slice = ((cols + n * vec - 1) / (n * vec)) * vec;
    if (slice <= kSliceMax) return {1, n, slice};
  }
}

template <int VEC, int NV, bool PRO>
cudaError_t launch_warp(const Args& a, cudaStream_t s) {
  const long long blocks = (a.rows + kWarpRows - 1) / kWarpRows;
  softmax_warp_kernel<VEC, NV, PRO>
      <<<grid_for(blocks), 32 * kWarpRows, 0, s>>>(a);
  return cudaGetLastError();
}

template <int VEC, int NV, bool PRO>
cudaError_t launch_cluster(const Args& a, const Plan& p, cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_for(a.rows) * p.n);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, softmax_cluster_kernel<VEC, NV, PRO>, a, p.n, p.slice);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <int VEC, bool PRO>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  const Plan p = plan_for(a.cols, VEC);
  if (p.kind == 2) {
    softmax_block_kernel<VEC, PRO>
        <<<grid_for(a.rows), kBlockThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (p.kind == 1) {
    // NV vectors a thread: the slice in 2048, 4096 or 8192 floats
    constexpr int kQuarter = kSliceMax / 4 / (kClusterThreads * VEC);
    if (p.slice <= kSliceMax / 4)
      return launch_cluster<VEC, kQuarter, PRO>(a, p, s);
    if (p.slice <= kSliceMax / 2)
      return launch_cluster<VEC, 2 * kQuarter, PRO>(a, p, s);
    return launch_cluster<VEC, 4 * kQuarter, PRO>(a, p, s);
  }
  const int per_lane = (a.cols + 32 * VEC - 1) / (32 * VEC);
  if (per_lane <= 1) return launch_warp<VEC, 1, PRO>(a, s);
  if (per_lane <= 2) return launch_warp<VEC, 2, PRO>(a, s);
  if (per_lane <= 4) return launch_warp<VEC, 4, PRO>(a, s);
  if (per_lane <= 8) return launch_warp<VEC, 8, PRO>(a, s);
  if constexpr (VEC == 1) {
    if (per_lane <= 16) return launch_warp<1, 16, PRO>(a, s);
    if (per_lane <= 32) return launch_warp<1, 32, PRO>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <bool PRO>
cudaError_t dispatch_vec(const Args& a, int vec, cudaStream_t s) {
  return vec == 4 ? dispatch<4, PRO>(a, s) : dispatch<1, PRO>(a, s);
}

}  // namespace

// x, y: (rows, cols) row-major fp32, distinct buffers.  vec (1 or 4) is the
// floats a load or store moves: the host checked cols % vec == 0, x and y
// aligned to 4 * vec bytes and keep to vec bytes.  prologue != 0 applies
// where(keep, x / div, -1e9) to every element as it is loaded: keep is
// nullptr (every key kept) or (rows / per, cols) bytes, 0 = masked, row r
// using mask row r / per.
extern "C" int mxt_softmax_f32(const void* x, void* y, long long rows,
                               int cols, int vec, int prologue, float div,
                               const void* keep, long long per,
                               void* stream) {
  if (rows <= 0 || cols <= 0 || (vec != 1 && vec != 4) || cols % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (keep && (!prologue || per <= 0 || rows % per != 0))
    return (int)cudaErrorInvalidValue;
  int exp2;
  const bool pow2 = fabsf(frexpf(div, &exp2)) == 0.5f &&
                    isnormal(1.f / div);
  const Args a = {static_cast<const float*>(x), static_cast<float*>(y),
                  rows, cols, div, pow2 ? 1.f / div : 0.f,
                  static_cast<const uint8_t*>(keep), per > 0 ? per : 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = prologue ? dispatch_vec<true>(a, vec, s)
                                   : dispatch_vec<false>(a, vec, s);
  return (int)err;
}

// The kernel that takes rows of `cols` at vector width vec (out[0]: 0
// warp, 1 cluster, 2 two-pass block), the cluster's CTAs (out[1]) and the
// columns a CTA holds (out[2]).
extern "C" int mxt_softmax_plan(int cols, int vec, int* out) {
  if (cols <= 0 || (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(cols, vec);
  out[0] = p.kind;
  out[1] = p.n;
  out[2] = p.slice;
  return 0;
}
