// Non-causal flash-attention forward with its row logsumexp, fp32 in and
// out, on Hopper's tensor cores in 3xTF32, online softmax.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_attn_kernel` (:167,
// launched by `_attention_pallas` :200), the forward of the custom VJP of
// `attention_fused` that mxnet_tpu/models/bert.py `_attention` calls.
// The backward kernels it feeds (dq; dk and dv) are in flash_bwd_tc.cu.
//
// Bounds on an H100.  For BERT-base's (B*H, L, D) = (192, 128, 64),
// Q.K^T and P.V are 4 * 192 * 128^2 * 64 = 0.81 GFLOP: 0.0120 ms at the
// 67 TFLOP/s fp32 CUDA-core peak.  This kernel does three TF32 products
// for each fp32 one, 2.42 GFLOP: 0.0049 ms at the 495 TFLOP/s dense TF32
// peak (0.0075 ms at the ~323 TFLOP/s `mma.sync` TF32 ceiling measured
// on the card), while q/k/v/o and lse are 25.3 MB, 0.0075 ms at
// 3.35 TB/s: on the tensor cores bytes bound it.
//
// Design: the FlashAttention-2 body of flash_fwd_tc.cuh without the mask
// (CAUSAL = false): 4 warps of 16 query rows a block, grid (B*H,
// ceil(Lq / 64)) in natural order, 32-key tiles streamed by staggered
// `cp.async` loads (K_0 and V_0 asked for before the Q tile is split:
// at L = 128 there are only four key tiles to hide the prologue behind),
// the scaled Q split once into shared memory, P kept in registers by
// permuting the k order of each 8-key step.  Columns past Lk take the
// finite -1e30 and rows past Lq are not written, so any Lq, Lk works;
// lse = m + log(l) goes to a contiguous (B*H, Lq) buffer.  At D = 64 a
// block holds ~51 KB of shared memory (four would fit an SM) and ~160
// registers a thread (three fit), so BERT's 384 blocks run as one wave
// of 396.

#include "flash_fwd_tc.cuh"

// q, o: (B, H, Lq, D); k, v: (B, H, Lk, D); lse: (B*H, Lq) contiguous;
// fp32.  Each stride array is (batch, head, row) in elements; the last
// dim is contiguous.  The host checked that every row starts 16-byte
// aligned and that D is 64 or 128.
extern "C" int mxt_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Lq, int Lk, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, float scale, void* stream) {
  return flash_fwd_entry<false>(q, k, v, o, lse, B, H, Lq, Lk, D, q_strides,
                                k_strides, v_strides, o_strides, scale,
                                stream);
}
