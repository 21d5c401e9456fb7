// User kernels for the rtc route (mxnet_tpu_torch/rtc.py CudaModule):
// the JAX package's rtc test kernels, Pallas bodies there, written as
// the CUDA source a user hands to CudaModule.
//
// axpy      o = 2x + y  (tests/test_pallas_rtc.py:85-103).  2x is exact,
//           so the FMA the compiler forms, fma(2, x, y), rounds once, as
//           the plain x * 2 + y does: the two agree bit for bit.
// double_it o = T(2x), its output type a template parameter bound to
//           out_dtype (tests/test_pallas_rtc.py:134-153, the out_dtype
//           case): compile with exports = ("double_it<float>",
//           "double_it<int>").  The cast to int truncates toward zero,
//           as torch's .to(torch.int32) does.
//
// Both take n elements with 64-bit indices and are right under any grid
// (axpy: of blocks of up to 256 threads).
//
// axpy moves 12 bytes an element for 2 flops, so the card's memory rate
// is its bound, and it is written to keep HBM busy:
// - 16-byte (float4) loads and stores when x, y and o are all 16-byte
//   aligned, which the kernel tests; the last n % 4 elements, or all of
//   them when an operand is not aligned (an offset view), take floats;
// - four items a thread, 256 threads apart so a warp's accesses stay
//   contiguous, all loaded before any is stored: eight loads in flight a
//   thread;
// - launched with a block per four items a thread, 256 x 4 x 4 floats
//   on the 16-byte path (rtc_example.axpy), so the block scheduler
//   spreads the work; the loop over the grid covers whatever a smaller
//   grid leaves;
// - blocks of at most 256 threads (__launch_bounds__): on an H100 the
//   scalar path (an offset view) ran well behind torch.add without the
//   bound and level with it with the bound; the cause was not traced.
// double_it is the plain form: one element a thread a step of a loop over
// the grid.

__device__ __forceinline__ float axpy1(float x, float y) {
  return 2.0f * x + y;
}

__device__ __forceinline__ float4 axpy1(float4 x, float4 y) {
  float4 o;
  o.x = axpy1(x.x, y.x);
  o.y = axpy1(x.y, y.y);
  o.z = axpy1(x.z, y.z);
  o.w = axpy1(x.w, y.w);
  return o;
}

// o = 2x + y over items [0, count) of type V (float4 or float)
template <typename V>
__device__ __forceinline__ void axpy_pass(const V *__restrict__ x,
                                          const V *__restrict__ y,
                                          V *__restrict__ o,
                                          long long count) {
  const long long step = (long long)gridDim.x * blockDim.x * 4;
  for (long long base = (long long)blockIdx.x * blockDim.x * 4 + threadIdx.x;
       base < count; base += step) {
    V xv[4], yv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long i = base + u * (long long)blockDim.x;
      if (i < count) {
        xv[u] = x[i];
        yv[u] = y[i];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long i = base + u * (long long)blockDim.x;
      if (i < count) o[i] = axpy1(xv[u], yv[u]);
    }
  }
}

extern "C" __global__ void __launch_bounds__(256)
axpy(const float *__restrict__ x, const float *__restrict__ y,
     float *__restrict__ o, long long n) {
  long long done = 0;
  if ((((unsigned long long)x | (unsigned long long)y |
        (unsigned long long)o) & 15) == 0) {
    axpy_pass(reinterpret_cast<const float4 *>(x),
              reinterpret_cast<const float4 *>(y),
              reinterpret_cast<float4 *>(o), n / 4);
    done = n / 4 * 4;
  }
  axpy_pass(x + done, y + done, o + done, n - done);
}

template <typename T>
__global__ void double_it(const float *__restrict__ x, T *__restrict__ o,
                          long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    o[i] = static_cast<T>(x[i] * 2.0f);
}
