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
// Both are grid-stride loops over n elements with 64-bit indices.

extern "C" __global__ void axpy(const float *__restrict__ x,
                                const float *__restrict__ y,
                                float *__restrict__ o, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    o[i] = 2.0f * x[i] + y[i];
}

template <typename T>
__global__ void double_it(const float *__restrict__ x, T *__restrict__ o,
                          long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    o[i] = static_cast<T>(x[i] * 2.0f);
}
