// The generated-op kernel template: one elementwise kernel per
// registered body and element type, compiled at run time by NVRTC.
//
// Replaces mxnet_tpu/tvmop.py:50 GeneratedOp._launch, which compiles a
// registered Pallas body (the stock ones at :119 x+y, :124 x*y and :138
// 1/(1+e^-x)) once per signature with an output shaped like one input.
// On the TPU the body runs on whole-array VMEM refs; here each thread
// applies it to elements of a flat range.
//
// Bound: bytes.  An elementwise op reads each input once and writes the
// output once, with a few operations an element, so the card's memory
// rate (3.35 TB/s on an H100 SXM) is the whole budget.  The design
// spends nothing else:
// - one block per 256 x 4 items (a 16-byte vector or an element each),
//   so the card's block scheduler, not a loop, spreads the work; 64-bit
//   indices, and a loop over the grid for more than 2^31 - 1 blocks;
// - 16-byte loads and stores (4 floats or ints, 2 doubles or int64s)
//   when every operand is 16-byte aligned, and a scalar tail for the
//   last n % W elements; an unaligned operand (an offset view) takes the
//   scalar pass for the whole range;
// - four items a thread, all loaded before any is stored, so a thread
//   keeps 4 x inputs loads in flight (one load each leaves the SM short
//   of the bytes in flight that HBM's latency asks for).  On an H100
//   both choices beat the alternatives tried while writing it: a
//   grid-stride loop over only the blocks the SMs hold at once, and one
//   item a thread a step (much slower on the scalar path);
// - the body is a function of values in registers, inlined.
//
// The wrapper (mxnet_tpu_torch/tvmop.py) puts these lines in front of
// this file, and NVRTC compiles the result alone — it includes nothing:
//   typedef <float | double | int | long long> T;
//   #define MXT_NIN <number of inputs, 1..8>
//   #define MXT_KERNEL <the kernel's extern "C" name>
//   #define MXT_BODY <the registered statement, e.g. o = x0 + x1;>
// The body reads the inputs as x0 .. x{MXT_NIN-1} and assigns o, all of
// type T.  mxt_exp is exp in T's precision (accurate expf, no fast
// math).

#if !defined(MXT_NIN) || !defined(MXT_KERNEL) || !defined(MXT_BODY)
#error "define T, MXT_NIN, MXT_KERNEL and MXT_BODY before this template"
#endif
#if MXT_NIN < 1 || MXT_NIN > 8
#error "MXT_NIN must be 1..8"
#endif

__device__ __forceinline__ float mxt_exp(float v) { return expf(v); }
__device__ __forceinline__ double mxt_exp(double v) { return exp(v); }

// the inputs, passed by value as one kernel parameter
struct MxtIns {
  const T *p[MXT_NIN];
};

// W elements of T in 16 bytes; U items a thread a step
constexpr int MXT_W = 16 / (int)sizeof(T);
constexpr int MXT_U = 4;
struct alignas(16) MxtVec {
  T v[MXT_W];
};

__device__ __forceinline__ T mxt_apply(const T (&x)[MXT_NIN]) {
  const T x0 = x[0];
#if MXT_NIN > 1
  const T x1 = x[1];
#endif
#if MXT_NIN > 2
  const T x2 = x[2];
#endif
#if MXT_NIN > 3
  const T x3 = x[3];
#endif
#if MXT_NIN > 4
  const T x4 = x[4];
#endif
#if MXT_NIN > 5
  const T x5 = x[5];
#endif
#if MXT_NIN > 6
  const T x6 = x[6];
#endif
#if MXT_NIN > 7
  const T x7 = x[7];
#endif
  T o;
  MXT_BODY
  return o;
}

// A pass over `count` items (16-byte vectors of W elements, or single
// elements).  Each block takes 256 x MXT_U consecutive items, MXT_U a
// thread, 256 apart so that a warp's accesses stay contiguous; a thread
// loads all its items before it computes or stores any, so it keeps
// MXT_U x MXT_NIN loads in flight.  The loop covers what one grid of
// at most 2^31 - 1 blocks cannot.
template <typename Item>
__device__ __forceinline__ void mxt_pass(const MxtIns &ins,
                                         T *__restrict__ out,
                                         long long count) {
  const long long step = (long long)gridDim.x * blockDim.x * MXT_U;
  for (long long base = (long long)blockIdx.x * blockDim.x * MXT_U +
                        threadIdx.x;
       base < count; base += step) {
    Item xv[MXT_U][MXT_NIN];
#pragma unroll
    for (int u = 0; u < MXT_U; ++u) {
      const long long i = base + u * blockDim.x;
      if (i < count) {
#pragma unroll
        for (int k = 0; k < MXT_NIN; ++k)
          xv[u][k] = reinterpret_cast<const Item *>(ins.p[k])[i];
      }
    }
#pragma unroll
    for (int u = 0; u < MXT_U; ++u) {
      const long long i = base + u * blockDim.x;
      if (i < count) {
        Item ov;
        T *o = reinterpret_cast<T *>(&ov);
#pragma unroll
        for (int j = 0; j < (int)(sizeof(Item) / sizeof(T)); ++j) {
          T x[MXT_NIN];
#pragma unroll
          for (int k = 0; k < MXT_NIN; ++k)
            x[k] = reinterpret_cast<const T *>(&xv[u][k])[j];
          o[j] = mxt_apply(x);
        }
        reinterpret_cast<Item *>(out)[i] = ov;
      }
    }
  }
}

// n elements; vec != 0 only when every input and the output are 16-byte
// aligned (the wrapper checks the pointers).  The 16-byte pass covers
// the first n - n % W elements, the scalar pass the rest (or all of them
// when vec is 0).
extern "C" __global__ void __launch_bounds__(256)
MXT_KERNEL(const MxtIns ins, T *__restrict__ out, long long n, int vec) {
  long long done = 0;
  if (vec) {
    const long long nv = n / MXT_W;
    mxt_pass<MxtVec>(ins, out, nv);
    done = nv * MXT_W;
  }
  MxtIns rest = ins;
#pragma unroll
  for (int k = 0; k < MXT_NIN; ++k) rest.p[k] += done;
  mxt_pass<T>(rest, out + done, n - done);
}
