// The training kernels of the fused 3x3/s1/p1 conv + BatchNorm (+ add)
// (+ ReLU) block, fp32, NHWC x HWIO:
//
//   conv_stats  z = conv(x, w) and per-channel sum(z), sum(z^2), read off
//               the accumulator before z is stored.
//   bn_affine   out = act(z * scale[c] + shift[c] (+ res)), elementwise.
//
// (The conv alone, also the data gradient, is conv3x3_tc.cu's; the
// weight gradient conv_wgrad.cu's.)
//
// Replaces: mxnet_tpu/ops/pallas_block.py `_conv_stats_kernel`
// (`_conv_stats`) and `_affine_kernel` (`_affine`), the training forward
// of `residual_block_fused`.
//
// Bound on an H100: conv_stats does 2 * N*H*W * 9C * Cout flops (231
// MFLOP per image at every ResNet-50 stage, 14.8 GFLOP at batch 64: 0.221
// ms at the 67 TFLOP/s fp32 peak) over (N*H*W*(C + Cout) + 9C*Cout) * 4
// bytes (~2-26 MB: a few us at 3.35 TB/s), so operations bound it.
// bn_affine moves 2-3 tensors of N*H*W*Cout floats and does 2-4 flops an
// element: bytes bound it (103 MB, 31 us at (64,56,56,64)).
//
// Design.  conv_stats runs on conv3x3_tile.cuh's implicit-GEMM tile,
// shared with conv_affine.cu (64 x 64 outputs a block, 16-deep double
// buffered chunks, predicated halo loads; CUDA cores, TF32 off).
//
// The TPU kernel of conv_stats adds into one output block that every
// grid step revisits, which is safe only on the TPU's sequential grid.
// Here blocks run at once and in no order, so each 64-pixel block sums
// its 64 channels over its pixels (4 per thread, then 16 threads in order
// through shared memory) into its own row part[block][2][Cout], and
// stats_reduce_kernel sums the N*H*W/64 rows in a fixed order: the result
// is the same from run to run (float atomics would not be).
//
// bn_affine is CUDA C++ rather than Triton so the port keeps one build
// system and nothing compiles at first launch: float4 loads and stores
// when Cout % 4 == 0 and the bases are 16-byte aligned, a grid-stride
// loop, scale and shift read per element (they stay in L1).

#include <cuda_runtime.h>

#include "conv3x3_tile.cuh"

namespace {

using namespace mxt_conv;

// Store a 64 x 64 tile of sums to the row-major (rows, cols) matrix out.
template <bool VEC>
__device__ __forceinline__ void store_tile(float acc[4][4], float* out,
                                           long long r0, int c0,
                                           long long rows, int cols) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int cb = c0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + ty * 4 + i;
    if (r >= rows) continue;
    float* o = out + r * cols;
    if constexpr (VEC) {
      if (cb < cols)
        *reinterpret_cast<float4*>(o + cb) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cb + j < cols) o[cb + j] = acc[i][j];
    }
  }
}

// part: (gridDim.x, 2, Cout), row blockIdx.x of sum(z) then sum(z^2)
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
conv_stats_kernel(const ConvGeom g, float* __restrict__ z,
                  float* __restrict__ part) {
  __shared__ __align__(16) TileSmem smem;
  __shared__ float red[2][kThreads / 16][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  float acc[4][4];
  ConvFwdLoader<VEC> ld(g, m0, n0);
  gemm_tile(ld, (g.K + BK - 1) / BK, smem, acc);
  store_tile<VEC>(acc, z, m0, n0, g.M, g.Cout);

  // rows past M hold zeros (their loads were predicated off); skip them
  // anyway so the sums never depend on that
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m0 + ty * 4 + i < g.M) {
        s1 += acc[i][j];
        s2 = fmaf(acc[i][j], acc[i][j], s2);
      }
    }
    red[0][ty][tx * 4 + j] = s1;
    red[1][ty][tx * 4 + j] = s2;
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int which = tid / BN, c = tid % BN;
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kThreads / 16; ++r) t += red[which][r][c];
    if (n0 + c < g.Cout)
      part[((long long)blockIdx.x * 2 + which) * g.Cout + n0 + c] = t;
  }
}

// out[c] = sum over r = 0 .. rows-1 of part[r][c], in a fixed order:
// thread (x, y) sums rows y, y + blockDim.y, ... of its column, then
// thread (x, 0) sums the blockDim.y partials in order.
__global__ void stats_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int rows,
                                    long long cols) {
  __shared__ float red[32][33];
  const long long c = (long long)blockIdx.x * 32 + threadIdx.x;
  float t = 0.f;
  if (c < cols) {
#pragma unroll 8
    for (int r = threadIdx.y; r < rows; r += blockDim.y)
      t += part[(long long)r * cols + c];
  }
  red[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float u = 0.f;
    for (int r = 0; r < (int)blockDim.y; ++r) u += red[r][threadIdx.x];
    out[c] = u;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(256)
bn_affine_kernel(const float* __restrict__ z, const float* __restrict__ scale,
                 const float* __restrict__ shift,
                 const float* __restrict__ res, float* __restrict__ out,
                 long long total, int Cout, int relu) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if constexpr (VEC) {
    const long long n4 = total / 4;
    const int cq = Cout / 4;
    const float4* z4 = reinterpret_cast<const float4*>(z);
    const float4* r4 = reinterpret_cast<const float4*>(res);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n4; i += stride) {
      const int c = (int)(i % cq) * 4;
      const float4 v = z4[i];
      const float4 sc = *reinterpret_cast<const float4*>(scale + c);
      const float4 sh = *reinterpret_cast<const float4*>(shift + c);
      float4 y = make_float4(fmaf(v.x, sc.x, sh.x), fmaf(v.y, sc.y, sh.y),
                             fmaf(v.z, sc.z, sh.z), fmaf(v.w, sc.w, sh.w));
      if (res) {
        const float4 r = r4[i];
        y.x += r.x; y.y += r.y; y.z += r.z; y.w += r.w;
      }
      if (relu) {
        y.x = y.x > 0.f ? y.x : 0.f; y.y = y.y > 0.f ? y.y : 0.f;
        y.z = y.z > 0.f ? y.z : 0.f; y.w = y.w > 0.f ? y.w : 0.f;
      }
      o4[i] = y;
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
      const int c = (int)(i % Cout);
      float y = fmaf(z[i], scale[c], shift[c]);
      if (res) y += res[i];
      if (relu) y = y > 0.f ? y : 0.f;
      out[i] = y;
    }
  }
}

bool geom(ConvGeom& g, const void* x, const void* w, int N, int H, int W,
          int C, int Cout) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0) return false;
  g.x = static_cast<const float*>(x);
  g.w = static_cast<const float*>(w);
  g.M = (long long)N * H * W;
  g.H = H; g.W = W; g.C = C; g.Cout = Cout; g.K = 9 * C;
  return (g.M + BM - 1) / BM <= 0x7fffffffLL;
}

// threads down a column of the fixed-order sum: 32 when there are many
// rows to share out, else 8
dim3 column_block(int rows) { return dim3(32, rows >= 256 ? 32 : 8); }

unsigned column_grid(long long cols) { return (unsigned)((cols + 31) / 32); }

}  // namespace

// All pointers are contiguous fp32 device memory.  vec != 0 asks for
// 16-byte accesses: the host checked the divisibility each kernel states
// and 16-byte aligned bases.  Each returns cudaGetLastError() after its
// launches.

// x (N, H, W, C), w (3, 3, C, Cout), z (N, H, W, Cout), part
// (ceil(N*H*W / 64), 2, Cout) scratch and stats (2, Cout): sum(z) then
// sum(z^2) per channel.  vec needs C % 16 == 0 and Cout % 4 == 0.
extern "C" int mxt_conv_stats_f32(const void* x, const void* w, void* z,
                                  void* part, void* stats, int N, int H,
                                  int W, int C, int Cout, int vec,
                                  void* stream) {
  ConvGeom g;
  if (!geom(g, x, w, N, H, W, C, Cout)) return (int)cudaErrorInvalidValue;
  const long long mb = (g.M + BM - 1) / BM;
  const dim3 grid((unsigned)mb, (unsigned)((Cout + BN - 1) / BN));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* zo = static_cast<float*>(z);
  float* p = static_cast<float*>(part);
  if (vec)
    conv_stats_kernel<true><<<grid, kThreads, 0, s>>>(g, zo, p);
  else
    conv_stats_kernel<false><<<grid, kThreads, 0, s>>>(g, zo, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cols = 2LL * Cout;
  stats_reduce_kernel<<<column_grid(cols), column_block((int)mb), 0, s>>>(
      p, static_cast<float*>(stats), (int)mb, cols);
  return (int)cudaGetLastError();
}

// z, res, out (total,) as rows of Cout channels; scale, shift (Cout,);
// res may be null.  vec needs Cout % 4 == 0.
extern "C" int mxt_bn_affine_f32(const void* z, const void* scale,
                                 const void* shift, const void* res,
                                 void* out, long long total, int Cout,
                                 int relu, int vec, void* stream) {
  if (total <= 0 || Cout <= 0 || total % Cout != 0)
    return (int)cudaErrorInvalidValue;
  const long long work = vec ? total / 4 : total;
  long long blocks = (work + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zi = static_cast<const float*>(z);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* r = static_cast<const float*>(res);
  float* o = static_cast<float*>(out);
  if (vec)
    bn_affine_kernel<true><<<(unsigned)blocks, 256, 0, s>>>(
        zi, sc, sh, r, o, total, Cout, relu);
  else
    bn_affine_kernel<false><<<(unsigned)blocks, 256, 0, s>>>(
        zi, sc, sh, r, o, total, Cout, relu);
  return (int)cudaGetLastError();
}
