// Row softmax over the last axis, fp32, bf16 or fp16 in and out:
// y = exp(x - max) / sum(exp(x - max)), with an optional prologue
// x -> where(keep, x / div, -1e9).
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

//
// bf16 and fp16 (since the bf16 serving slice).  The reference's Pallas
// kernel runs whatever dtype it is given and XLA rounds each of its steps
// to that dtype; the half instances hold every value in fp32 registers and
// make those roundings there: the prologue's quotient rounded (the divisor
// rounded to the dtype first, as JAX's weak constant is) and the mask value
// -1e9 as the dtype holds it (-inf in fp16); d = x - max rounded; e =
// exp(d) in fp32, rounded before the sum in fp16 and kept in fp32 in bf16;
// the fp32 sum rounded; the quotient of the rounded e over the rounded sum
// rounded once at the store.  A load moves 8 halves (16 bytes) where cols %
// 8 == 0 and every base allows, else 1; the plans are the fp32 ones with 8
// in place of 4.  Rows wider than the cluster's reach take three passes
// (max, sum, write) in place of the online pair, since the rounded d of
// each element needs the row's final max.  Bound: the same bytes at 2 an
// element, 100 MB at bucket 8 of the Gluon BERT-base (0.030 ms).  The fp32
// instances are unchanged.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpRows = 4;          // rows (warps) per block, short rows
constexpr int kMaxShortCols = 1024;
constexpr int kClusterThreads = 256;  // threads a CTA, cluster rows
constexpr int kSliceMax = 8192;       // values a CTA holds: 32 a thread
constexpr int kMaxCluster = 8;        // the largest portable cluster
constexpr int kMaxClusterCols = kMaxCluster * kSliceMax;
constexpr int kBlockThreads = 512;    // threads per row, widest rows
constexpr unsigned kMaxGrid = 1u << 20;
constexpr float kMasked = -1e9f;      // the model's finite mask value

// The storage type T: fp32 values are widened from it on load and rounded
// to it (rnd: to T and back) where the reference rounds.  kHalf: the
// reference's half-precision roundings apply; kExpRounded: exp(d) is
// rounded before it is summed (fp16; bf16 sums it in fp32).
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr bool kHalf = false, kExpRounded = false;
  __device__ static float wide(float v) { return v; }
  __device__ static float rnd(float v) { return v; }
  __device__ static float narrow(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kHalf = true, kExpRounded = false;
  __device__ static float wide(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ static float rnd(float v) { return wide(narrow(v)); }
};

template <>
struct Elem<__half> {
  static constexpr bool kHalf = true, kExpRounded = true;
  __device__ static float wide(__half v) { return __half2float(v); }
  __device__ static __half narrow(float v) { return __float2half_rn(v); }
  __device__ static float rnd(float v) { return wide(narrow(v)); }
};

// What every kernel takes: x, y (rows, cols) row-major; the prologue's
// divisor and keep mask (rows / per, cols) of 0/1 bytes, row r of x using
// mask row r / per (nullptr: every key kept).
template <typename T>
struct Args {
  const T* x;
  T* y;
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

// exp(x - max) of one element as the reference rounds it: fp32 as is; in
// half precision the difference rounded, and in fp16 the exp too.
template <typename T>
__device__ __forceinline__ float exp_shifted(float v, float m) {
  if constexpr (Elem<T>::kHalf) {
    const float e = expf(Elem<T>::rnd(v - m));
    return Elem<T>::kExpRounded ? Elem<T>::rnd(e) : e;
  } else {
    return expf(v - m);
  }
}

// The row's sum as the quotient sees it: rounded in half precision.
template <typename T>
__device__ __forceinline__ float row_sum(float s) {
  return Elem<T>::rnd(s);
}

// e / s (IEEE) for e = exp(x - max) and the row's sum s >= 1: an e of 0
// (a masked key) skips the division and gives the same 0.  Rows with masked
// keys measured about a third slower where their zeros were divided, and
// as slow with a select after an unconditional division.  In half
// precision e is rounded before the divide (the store rounds the
// quotient).
template <typename T>
__device__ __forceinline__ float quotient(float e, float s) {
  return e == 0.f ? 0.f : Elem<T>::rnd(e) / s;
}

// The prologue on one element: x / div (IEEE), or -1e9 where masked (and
// then no division).  Where div is a power of two (sqrt(64) = 8) its
// reciprocal is exact and x * (1 / div) is the same correctly rounded
// quotient, without the division's dozen instructions.  In half precision
// the quotient and the mask value are rounded to T (-1e9 is -inf in fp16).
template <typename T>
__device__ __forceinline__ float prologue(float x, float div, float recip,
                                          bool masked) {
  if (masked) return Elem<T>::rnd(kMasked);
  return Elem<T>::rnd(recip != 0.f ? x * recip : __fdiv_rn(x, div));
}

// VEC consecutive values from p (VEC-aligned by the host), widened to fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (VEC == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const T* h = reinterpret_cast<const T*>(&t);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = Elem<T>::wide(h[e]);
  } else {
    out[0] = Elem<T>::wide(*p);
  }
}

// VEC fp32 values to p, each rounded to T once.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (VEC == 8) {
    uint4 t;
    T* h = reinterpret_cast<T*>(&t);
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = Elem<T>::narrow(in[e]);
    *reinterpret_cast<uint4*>(p) = t;
  } else {
    *p = Elem<T>::narrow(in[0]);
  }
}

// Bit e set where mask byte p[e] of the VEC at p is 0 (a masked key).
template <int VEC>
__device__ __forceinline__ uint32_t masked_bits(const uint8_t* p) {
  if constexpr (VEC == 4) {
    const uchar4 t = *reinterpret_cast<const uchar4*>(p);
    return (uint32_t)(t.x == 0) | (uint32_t)(t.y == 0) << 1 |
           (uint32_t)(t.z == 0) << 2 | (uint32_t)(t.w == 0) << 3;
  } else if constexpr (VEC == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&t);
    uint32_t m = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) m |= (uint32_t)(b[e] == 0) << e;
    return m;
  } else {
    return (uint32_t)(*p == 0);
  }
}

// The row's mask row, or nullptr when every key is kept.
template <bool PRO, typename T>
__device__ __forceinline__ const uint8_t* keep_row(const Args<T>& a,
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
template <typename T, int VEC, bool PRO>
__device__ __forceinline__ void load_row(const T* xr, const uint8_t* kr,
                                         int c, float div, float recip,
                                         float* out) {
  load_vec<T, VEC>(xr + c, out);
  if constexpr (PRO) {
    const uint32_t masked = kr ? masked_bits<VEC>(kr + c) : 0u;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out[e] = prologue<T>(out[e], div, recip, (masked >> e) & 1u);
  }
}

// A thread's share of a row held in registers: the NV VEC-wide vectors at
// columns first + i * STRIDE * VEC, those at or past `end` set to -inf;
// returns their max.  With PRO the prologue follows once every load is in
// flight (IEEE division has a slow-path branch that would otherwise hold
// each load back behind the last one's divide): the keep bytes are folded
// into one bit a column as they arrive (NV * VEC <= 32).
template <typename T, int VEC, int NV, bool PRO, int STRIDE>
__device__ __forceinline__ float load_share(const T* xr, const uint8_t* kr,
                                            int first, int end, float div,
                                            float recip,
                                            float (&v)[NV][VEC]) {
  static_assert(NV * VEC <= 32, "one mask bit a column");
  uint32_t masked = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = first + i * STRIDE * VEC;
    if (c < end) {
      load_vec<T, VEC>(xr + c, v[i]);
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
          v[i][e] = prologue<T>(v[i][e], div, recip,
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
template <typename T, int VEC, int NV, bool PRO>
__global__ void __launch_bounds__(32 * kWarpRows)
softmax_warp_kernel(const Args<T> a) {
  const int lane = threadIdx.x & 31;
  const int cols = a.cols;
  const long long step = (long long)gridDim.x * kWarpRows;
  for (long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
       row < a.rows; row += step) {
    const T* xr = a.x + row * cols;
    T* yr = a.y + row * cols;
    const uint8_t* kr = keep_row<PRO>(a, row);
    float v[NV][VEC];
    const float m =
        warp_max(load_share<T, VEC, NV, PRO, 32>(xr, kr, lane * VEC, cols,
                                                 a.div, a.recip, v));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < cols) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[i][e] = exp_shifted<T>(v[i][e], m);
          s += v[i][e];
        }
      }
    }
    s = row_sum<T>(warp_sum(s));
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < cols) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = quotient<T>(v[i][e], s);
        store_vec<T, VEC>(yr + c, o);
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
template <typename T, int VEC, int NV, bool PRO>
__global__ void __launch_bounds__(kClusterThreads, 4)
softmax_cluster_kernel(const Args<T> a, int n, int slice) {
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
    const T* xr = a.x + row * cols;
    T* yr = a.y + row * cols;
    const uint8_t* kr = keep_row<PRO>(a, row);
    float v[NV][VEC];
    float m = warp_max(load_share<T, VEC, NV, PRO, kClusterThreads>(
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
          v[i][e] = exp_shifted<T>(v[i][e], m);
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
    s = row_sum<T>(s);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = c0 + (i * kClusterThreads + tid) * VEC;
      if (c < c1) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) o[e] = quotient<T>(v[i][e], s);
        store_vec<T, VEC>(yr + c, o);
      }
    }
  }
  cluster.sync();
}

// A block-wide reduction of one value a thread in a fixed order: warp
// shuffles, then warp 0 over the warps' results; every thread gets it.
// `sm` holds one value a warp, `out` the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* sm,
                                              float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kBlockThreads / 32 ? sm[lane] : (MAX ? -INFINITY : 0.f);
    v = MAX ? warp_max(v) : warp_sum(v);
    if (lane == 0) *out = v;
  }
  __syncthreads();
  return *out;
}

// One block per row.  fp32: an online (max, sum) pass, a block-wide merge,
// then a pass that reads the row again and writes.  Half precision: a max
// pass, a pass summing the rounded exp(x - max), then the write pass.
// cols % VEC == 0 and the rows are VEC-aligned.
template <typename T, int VEC, bool PRO>
__global__ void __launch_bounds__(kBlockThreads)
softmax_block_kernel(const Args<T> a) {
  __shared__ float sm[kBlockThreads / 32], ss[kBlockThreads / 32];
  __shared__ float row_m, row_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cols = a.cols;
  const int nvec = cols / VEC;
  for (long long row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const T* xr = a.x + row * cols;
    T* yr = a.y + row * cols;
    const uint8_t* kr = keep_row<PRO>(a, row);
    float m = -INFINITY, s = 0.f;
    if constexpr (Elem<T>::kHalf) {
      for (int i = tid; i < nvec; i += kBlockThreads) {
        float v[VEC];
        load_row<T, VEC, PRO>(xr, kr, i * VEC, a.div, a.recip, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) m = fmaxf(m, v[e]);
      }
      m = block_reduce<true>(m, sm, &row_m);
      for (int i = tid; i < nvec; i += kBlockThreads) {
        float v[VEC];
        load_row<T, VEC, PRO>(xr, kr, i * VEC, a.div, a.recip, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += exp_shifted<T>(v[e], m);
      }
      s = row_sum<T>(block_reduce<false>(s, ss, &row_s));
    } else {
      for (int i = tid; i < nvec; i += kBlockThreads) {
        float v[VEC];
        load_row<T, VEC, PRO>(xr, kr, i * VEC, a.div, a.recip, v);
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
    }
    for (int i = tid; i < nvec; i += kBlockThreads) {
      float v[VEC];
      load_row<T, VEC, PRO>(xr, kr, i * VEC, a.div, a.recip, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        v[e] = quotient<T>(exp_shifted<T>(v[e], m), s);
      store_vec<T, VEC>(yr + i * VEC, v);
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
// block kernel.
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

template <typename T, int VEC, int NV, bool PRO>
cudaError_t launch_warp(const Args<T>& a, cudaStream_t s) {
  const long long blocks = (a.rows + kWarpRows - 1) / kWarpRows;
  softmax_warp_kernel<T, VEC, NV, PRO>
      <<<grid_for(blocks), 32 * kWarpRows, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int VEC, int NV, bool PRO>
cudaError_t launch_cluster(const Args<T>& a, const Plan& p, cudaStream_t s) {
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
      &cfg, softmax_cluster_kernel<T, VEC, NV, PRO>, a, p.n, p.slice);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T, int VEC, bool PRO>
cudaError_t dispatch(const Args<T>& a, cudaStream_t s) {
  const Plan p = plan_for(a.cols, VEC);
  if (p.kind == 2) {
    softmax_block_kernel<T, VEC, PRO>
        <<<grid_for(a.rows), kBlockThreads, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (p.kind == 1) {
    // NV vectors a thread: the slice in 2048, 4096 or 8192 values
    constexpr int kQuarter = kSliceMax / 4 / (kClusterThreads * VEC);
    if (p.slice <= kSliceMax / 4)
      return launch_cluster<T, VEC, kQuarter, PRO>(a, p, s);
    if (p.slice <= kSliceMax / 2)
      return launch_cluster<T, VEC, 2 * kQuarter, PRO>(a, p, s);
    return launch_cluster<T, VEC, 4 * kQuarter, PRO>(a, p, s);
  }
  const int per_lane = (a.cols + 32 * VEC - 1) / (32 * VEC);
  if (per_lane <= 1) return launch_warp<T, VEC, 1, PRO>(a, s);
  if (per_lane <= 2) return launch_warp<T, VEC, 2, PRO>(a, s);
  if (per_lane <= 4) return launch_warp<T, VEC, 4, PRO>(a, s);
  if constexpr (8 * VEC <= 32) {
    if (per_lane <= 8) return launch_warp<T, VEC, 8, PRO>(a, s);
  }
  if constexpr (VEC == 1) {
    if (per_lane <= 16) return launch_warp<T, 1, 16, PRO>(a, s);
    if (per_lane <= 32) return launch_warp<T, 1, 32, PRO>(a, s);
  }
  return cudaErrorInvalidValue;
}

// The widest vector a load of T may move: 4 floats or 8 halves.
template <typename T>
constexpr int kWide = sizeof(T) == 4 ? 4 : 8;

template <typename T, bool PRO>
cudaError_t dispatch_vec(const Args<T>& a, int vec, cudaStream_t s) {
  return vec == kWide<T> ? dispatch<T, kWide<T>, PRO>(a, s)
                         : dispatch<T, 1, PRO>(a, s);
}

template <typename T>
int run(const void* x, void* y, long long rows, int cols, int vec,
        int prologue, float div, const void* keep, long long per,
        void* stream) {
  if (rows <= 0 || cols <= 0 || (vec != 1 && vec != kWide<T>) ||
      cols % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (keep && (!prologue || per <= 0 || rows % per != 0))
    return (int)cudaErrorInvalidValue;
  int exp2;
  const bool pow2 = fabsf(frexpf(div, &exp2)) == 0.5f &&
                    isnormal(1.f / div);
  const Args<T> a = {static_cast<const T*>(x), static_cast<T*>(y), rows,
                     cols, div, pow2 ? 1.f / div : 0.f,
                     static_cast<const uint8_t*>(keep), per > 0 ? per : 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = prologue ? dispatch_vec<T, true>(a, vec, s)
                                   : dispatch_vec<T, false>(a, vec, s);
  return (int)err;
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
  return run<float>(x, y, rows, cols, vec, prologue, div, keep, per, stream);
}

// The same for bf16 x and y: vec is 1 or 8 (halves a load moves; x and y
// aligned to 2 * vec bytes, keep to vec bytes), div the divisor rounded to
// bf16 by the host.
extern "C" int mxt_softmax_bf16(const void* x, void* y, long long rows,
                                int cols, int vec, int prologue, float div,
                                const void* keep, long long per,
                                void* stream) {
  return run<__nv_bfloat16>(x, y, rows, cols, vec, prologue, div, keep, per,
                            stream);
}

// The same for fp16 x and y (div rounded to fp16 by the host).
extern "C" int mxt_softmax_f16(const void* x, void* y, long long rows,
                               int cols, int vec, int prologue, float div,
                               const void* keep, long long per,
                               void* stream) {
  return run<__half>(x, y, rows, cols, vec, prologue, div, keep, per,
                     stream);
}

// The kernel that takes rows of `cols` at vector width vec (out[0]: 0
// warp, 1 cluster, 2 block), the cluster's CTAs (out[1]) and the columns a
// CTA holds (out[2]).  vec is 1, 4 (fp32) or 8 (bf16, fp16).
extern "C" int mxt_softmax_plan(int cols, int vec, int* out) {
  if (cols <= 0 || (vec != 1 && vec != 4 && vec != 8))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(cols, vec);
  out[0] = p.kind;
  out[1] = p.n;
  out[2] = p.slice;
  return 0;
}
