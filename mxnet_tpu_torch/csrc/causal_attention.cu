// Causal flash-attention forward, fp32 in and out, on Hopper's tensor
// cores in 3xTF32, online softmax.
//
// Replaces: mxnet_tpu/ops/pallas_attention.py `_causal_attn_kernel`
// (:203, launched by `_causal_attention_pallas` :248), reached through
// mxnet_tpu/models/gpt.py `_layer_prefill`.
//
// Bounds on an H100.  For (B*H, L, D) = (48, 512, 128) the causal half is
// 2 * 2 * 48 * (512 * 513 / 2) * 128 = 3.23 GFLOP against 50 MB of
// q/k/v/o: 0.0482 ms at the 67 TFLOP/s fp32 CUDA-core peak, 0.015 ms at
// 3.35 TB/s.  This kernel does three TF32 products for each fp32 one:
// 9.7 GFLOP, 0.0196 ms at the 495 TFLOP/s dense TF32 peak (0.030 ms at
// the 323.8 TFLOP/s `mma.sync` TF32 ceiling measured on the card), so
// operations bound it.
//
// Design: the FlashAttention-2 body of flash_fwd_tc.cuh with the causal
// mask (CAUSAL = true): 4 warps of 16 query rows a block, heaviest query
// tiles first, 32-key tiles streamed by staggered `cp.async` loads, the
// scaled Q split once into shared memory, P kept in registers by
// permuting the k order of each 8-key step.  Only key tiles up to the
// block's diagonal are read.  At L = 512 that is 48 blocks at B = 1 (6
// heads: most of the 132 SMs idle) and 384 at B = 8, two blocks an SM
// (~99 KB of shared memory at D = 128).

#include "flash_fwd_tc.cuh"

// q, o: (B, H, Lq, D); k, v: (B, H, Lk, D); fp32.  Each stride array is
// (batch, head, row) in elements; the last dim is contiguous.  The host
// checked that every row starts 16-byte aligned.
extern "C" int mxt_causal_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Lq, int Lk, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, float scale, void* stream) {
  return flash_fwd_entry<true>(q, k, v, o, nullptr, B, H, Lq, Lk, D,
                               q_strides, k_strides, v_strides, o_strides,
                               scale, stream);
}
