// The implicit-GEMM tile shared by the 3x3/s1/p1 convolution kernels of
// conv_affine.cu (frozen forward) and conv_train.cu (training forward with
// statistics).
//
// A block of 256 threads owns a 64 x 64 output tile and streams the
// reduction in chunks of 16 through double-buffered shared memory: the
// next chunk is fetched into registers while the current one is
// multiplied, and each thread keeps a 4x4 sub-tile of sums in registers
// (rows ty*4 .. +3, columns tx*4 .. +3 of the tile).  What a chunk is
// comes from a Loader:
//
//   fetch(kt, ra, rb)   chunk kt's four A and four B values of this
//                       thread into registers (zero where out of range)
//   put(As, Bs, ra, rb) those registers into one shared-memory buffer,
//                       As[k][row] and Bs[k][col]
//
// ConvFwdLoader reads the forward conv: rows are output pixels, columns
// output channels, the reduction K = 9*C taps x input channels in
// tap-major order (the HWIO weight read as the row-major (9C, Cout)
// matrix), the input patch gathered straight from NHWC with the 3x3 halo
// zero-filled by predicated loads.
#pragma once

#include <cuda_runtime.h>

namespace mxt_conv {

constexpr int BM = 64;        // tile rows
constexpr int BN = 64;        // tile columns
constexpr int BK = 16;        // reduction chunk
constexpr int APAD = 4;       // pad of the rows of the A buffer
constexpr int kThreads = 256;

struct TileSmem {
  float As[2][BK][BM + APAD];
  float Bs[2][BK][BN];
};

// The 3x3/s1/p1 conv geometry: x (N, H, W, C) NHWC, w (3, 3, C, Cout).
struct ConvGeom {
  const float* x;
  const float* w;        // the weight
  long long M;           // N*H*W
  int H, W, C, Cout, K;  // K = 9*C
};

template <class Loader>
__device__ __forceinline__ void gemm_tile(Loader& ld, int nk, TileSmem& s,
                                          float acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (nk <= 0) return;   // nk is the same for the whole block

  float ra[4], rb[4];
  ld.fetch(0, ra, rb);
  ld.put(s.As[0], s.Bs[0], ra, rb);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) ld.fetch(kt + 1, ra, rb);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av =
          *reinterpret_cast<const float4*>(&s.As[cur][kk][ty * 4]);
      const float4 bv =
          *reinterpret_cast<const float4*>(&s.Bs[cur][kk][tx * 4]);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    // the other buffer was last read before the last sync
    if (more) ld.put(s.As[cur ^ 1], s.Bs[cur ^ 1], ra, rb);
    __syncthreads();
  }
}

// Forward conv.  VEC: C % 16 == 0 (a chunk lies inside one tap, its
// channels contiguous), Cout % 4 == 0 and 16-byte aligned bases, so every
// load is 16 bytes; otherwise every element is gathered on its own.
template <bool VEC>
struct ConvFwdLoader {
  const ConvGeom& g;
  const float* pix;    // this thread's A pixel in x
  bool valid;
  int ph, pw;
  int a_q, a_m;        // k sub-quad and tile row of this thread's A loads
  int b_row, b_col;    // chunk row and tile column of its B loads
  int b_n;             // b_col's global output channel

  __device__ __forceinline__ ConvFwdLoader(const ConvGeom& geom,
                                           long long m0, int n0)
      : g(geom), pix(geom.x), valid(false), ph(0), pw(0) {
    const int tid = threadIdx.x;
    a_q = tid & 3;
    a_m = tid >> 2;
    b_row = tid >> 4;
    b_col = (tid & 15) * 4;
    b_n = n0 + b_col;
    const long long am = m0 + a_m;
    valid = am < g.M;
    if (valid) {   // the pixel's coordinates hold for the whole K loop
      pw = (int)(am % g.W);
      ph = (int)((am / g.W) % g.H);
      pix = g.x + am * g.C;
    }
  }

  __device__ __forceinline__ void fetch(int kt, float* ra, float* rb) const {
    const int k0 = kt * BK;
    if constexpr (VEC) {
      const int tap = k0 / g.C;
      const int c = k0 - tap * g.C + a_q * 4;
      const int dh = tap / 3 - 1, dw = tap % 3 - 1;
      const int ih = ph + dh, iw = pw + dw;
      if (valid && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) {
        const float4 v = *reinterpret_cast<const float4*>(
            pix + ((long long)dh * g.W + dw) * g.C + c);
        ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
      } else {
        ra[0] = ra[1] = ra[2] = ra[3] = 0.f;
      }
      // K % 16 == 0 and Cout % 4 == 0: the four columns are all in or out
      if (b_n < g.Cout) {
        const float4 v = *reinterpret_cast<const float4*>(
            g.w + (long long)(k0 + b_row) * g.Cout + b_n);
        rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
      } else {
        rb[0] = rb[1] = rb[2] = rb[3] = 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + a_q * 4 + e;
        float v = 0.f;
        if (valid && k < g.K) {
          const int tap = k / g.C;
          const int c = k - tap * g.C;
          const int dh = tap / 3 - 1, dw = tap % 3 - 1;
          const int ih = ph + dh, iw = pw + dw;
          if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
            v = pix[((long long)dh * g.W + dw) * g.C + c];
        }
        ra[e] = v;
      }
      const int k = k0 + b_row;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rb[e] = (k < g.K && b_n + e < g.Cout)
                    ? g.w[(long long)k * g.Cout + b_n + e] : 0.f;
    }
  }

  __device__ __forceinline__ void put(float (*As)[BM + APAD],
                                      float (*Bs)[BN], const float* ra,
                                      const float* rb) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) As[a_q * 4 + e][a_m] = ra[e];
    *reinterpret_cast<float4*>(&Bs[b_row][b_col]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  }
};

}  // namespace mxt_conv
