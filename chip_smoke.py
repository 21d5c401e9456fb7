#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``mxnet_tpu_torch``'s two paths with random weights from a seed:
GPT serving — ``DecodeEngine`` and ``DecodeBatcher`` — at the repo's
benchmark configuration (GPT-2-small body: 768 wide, 12 layers, 6 heads
of 128, FFN 3072, vocab 8192; window 576, batch buckets (1, 8), prompt
bucket 512), then BERT-base masked-LM pretraining through
``examples.bert_pretrain`` at its defaults (vocab 30522, 768 wide, 12
layers, 12 heads of 64, FFN 3072, batch 16 x 128 tokens, AdamW lr 1e-4,
wd 0.01), then ResNet-50 v1 image serving (1000 classes, NHWC items
224x224x3, buckets 1, 2, 4, 8) through ``ModelRegistry`` →
``InferenceEngine`` → ``Batcher``, then ResNet-50 v1 training through
``examples.image_classification`` at its defaults (batch 64 x 224x224x3,
1000 classes, SGD lr 0.1, momentum 0.9, wd 1e-4), then Gluon BERT-base
serving (``models.bert_gluon.bert_12_768_12``: vocab 30522, 768 wide, 12
layers of 12 heads of 64, FFN 3072, fp32; int32 items of 512 token ids,
buckets 1, 2, 4, 8) through ``ModelRegistry`` → ``Batcher`` →
``InferenceEngine``, then int8 post-training-quantized ResNet-50 v1
(``quantization.quantize_net``, naive calibration, 53 quantized convs
and a quantized dense; 1000 classes, 224x224x3): scoring at batch 64 as
``benchmark/int8_score.py`` runs it, and serving through
``ModelRegistry.load(..., precision="int8")`` → ``Batcher`` →
``InferenceEngine``, then the extension surface (``tvmop`` generated ops,
``rtc.CudaModule`` user kernels compiled by NVRTC, a ``CustomOp``, an
external library) at the largest elementwise operand of those models,
ResNet-50 v1 batch-64 training's stage-1 block output (64, 56, 56, 256)
fp32.  Phases, one JSON line each; the run stops with a non-zero exit at
the first phase that fails:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, the NVRTC library's path and version; TF32 is switched
   off for matmul and cuDNN.
2. ``build``: nvcc builds the kernels of ``mxnet_tpu_torch/csrc``.
3. ``kernels``: each kernel at the shapes the path gives it, against its
   plain PyTorch version on the same inputs (LayerNorm within 1e-5, also
   on its block-a-row path at (64, 8192) and (16, 30522); attention
   within 1e-4: its sums run in another order), with CUDA
   event times of the kernel, the plain version and one PyTorch library
   call computing the same function (timed here, never used by the port).
   Causal attention (3xTF32 on the tensor cores) also gives both bounds
   (fp32 on the CUDA cores; its three TF32 products on the tensor cores,
   the line's ``bound_ms``), its share of the card's ``mma.sync`` TF32
   ceiling, and that two launches on the same inputs are bitwise equal
   (a gate).
4. ``slice``: launch counters set to 0, then ``warmup`` is done, then
   ``generate`` at batch 1 and 8 (48-token prompt) and ``DecodeBatcher``
   serving concurrent requests, each stream equal to ``generate`` for its
   prompt; the counters are read after and must both be > 0.
5. ``reference``: the same weights run by the port on the CPU: prefill
   and decode-step logits within 1e-3, greedy tokens equal.
6. ``profile``: prefill and decode step at batch 1 and 8 under
   ``torch.profiler``: kernels per call, device-busy time, idle share.
7. ``bert_kernels``: the flash-attention forward, dq and dk/dv kernels
   against their plain versions at BERT-base's shape (a strided view
   into the qkv projection) and three more (o within 1e-4, lse within
   1e-5, dq/dk/dv within 1e-4 of the tensor's largest magnitude, fed the
   plain forward's lse and again the kernel's), timed beside their
   bounds, the plain versions and SDPA (forward; backward for dq and
   dk/dv together).  The forward (3xTF32 on the tensor cores) also gives
   both bounds, its share of the ``mma.sync`` TF32 ceiling and its time
   over SDPA's, and two launches on the same inputs must be bitwise
   equal (a gate).
8. ``bert_train``: launch counters set to 0, then 6 steps of
   ``examples.bert_pretrain.main``; the loss must be finite and end
   below step 0's, each attention kernel launched 12 times a step and
   LayerNorm 25 times a step.
9. ``bert_reference``: one step at batch 2 on the card and through the
   port on the CPU from the same weights and batch: loss within 1e-4
   relative, every gradient within 1e-3 of its largest magnitude, the
   weights after one AdamW step within 2 * lr.
10. ``bert_profile``: one train step under ``torch.profiler``.
11. ``image_kernels``: the fused conv3x3 + folded BN (+ add) (+ ReLU)
    kernel (the affine instance of ``conv3x3_tc.cu``'s 3xTF32 loop)
    against its plain version at ResNet-50's four 3x3 stages at batch 8,
    the 7x7x512 stage at batch 1, ResNet-18's residual tail, ReLU off and
    a ragged shape (within 1e-4 of the output's largest magnitude: the
    9*C sums run in another order), and two launches on the same inputs
    bitwise equal (a gate); each case's plan (bn, tiles, chunks, ranges,
    ``cut_tiles``), timed beside both bounds (fp32 on the CUDA cores;
    the three TF32 products on the tensor cores, the line's
    ``bound_ms``), its share of the tensor-core bound and of the card's
    ``mma.sync`` TF32 ceiling, its plain version and ``F.conv2d`` alone
    (``vs_library``); at the five stage shapes also the device µs of the
    main and the cut-tile kernel (``kernels_us``).
12. ``image_serve``: the launch counter set to 0, then
    ``ModelRegistry.load`` of a seeded ResNet-50 ``.params`` (warmup of
    every bucket), 32 closed-loop requests from one client and 64 from
    8 client threads through the ``Batcher``; every response finite,
    and exactly 16 kernel launches per forward run.  Device and eager
    ms per forward at each bucket, peak memory.
13. ``image_reference``: card logits against the port on the CPU from
    the same ``.params`` at batch 2 (within 1e-4 of the largest logit,
    top-1 equal), and every batched response against the unbatched
    forward of its image (same tolerance).
14. ``image_profile``: one bucket-8 and one bucket-1 forward under
    ``torch.profiler``.
15. ``train_kernels``: the four training kernels (``conv3x3``, also as
    dgrad on the rotated weight, ``conv_stats``, ``bn_affine``,
    ``conv_wgrad``) against their plain versions at ResNet-50's four 3x3
    stages at batch 64, a C != Cout dgrad/wgrad case, ``bn_affine`` with
    a residual and with ReLU off, and a ragged shape (z, dx, dW within
    1e-4 of the tensor's largest magnitude; sum(z^2) within 1e-5
    relative and sum(z) within 1e-5 of the channel's sum |z|;
    ``bn_affine`` within 1e-6 of its largest magnitude), timed beside
    their bounds, plain versions and the nearest single library call.
    ``conv3x3``, ``conv_stats`` and ``conv_wgrad`` (3xTF32 on the tensor
    cores) also report, per case, their plan (ranges; wgrad's partial
    slots; ``conv_stats`` also ``conv3x3``'s plan at its shape), both
    bounds (fp32 on the CUDA cores; the three TF32 products on the
    tensor cores, the line's ``bound_ms``), fp32-equivalent TFLOP/s, the
    share of the tensor-core bound, the library call's ms, and that two
    launches on the same inputs give bitwise-equal outputs (a gate;
    ``conv_stats``: z, sum(z) and sum(z^2) each); ``conv_stats``' z must
    equal ``conv3x3(x, w)`` bit for bit wherever the two plans agree (a
    gate); the device µs of each kernel the forward ``conv3x3`` and
    ``conv_stats`` launch (``kernels_us``, torch.profiler); and the TF32
    ``mma.sync`` ceiling of the card (independent products on
    registers, no memory, compiled through ``rtc.CudaModule``) with each
    case's share of it.
16. ``image_train``: the launch counters set to 0, then
    ``examples.image_classification.main`` at its defaults with 2
    warm-up and 8 timed steps; the losses finite, each training kernel
    launched exactly 16 times a step and ``conv_affine`` never.  Step ms
    (CUDA events), images/s, peak memory.
17. ``image_train_reference``: one step at batch 2 on the card and
    through the port on the CPU (and on the CPU in float64, the floor)
    from the same seeded weights (the damped-residual init) and batch:
    loss within 1e-4 relative, every gradient within 1e-2 of the net's
    largest gradient, every parameter after the SGD step within 1e-2 of
    the net's largest update, running statistics within 1e-5 of their
    largest magnitude.
18. ``image_train_profile``: one training step under ``torch.profiler``.
19. ``text_kernels``: the row-softmax kernel against its plain version
    (within 1e-6 absolute: softmax values lie in [0, 1]) at the Gluon
    BERT's shapes at buckets 8 and 1 (49152 and 6144 rows of 512),
    ragged widths 77 and 1000, vocabulary rows (4096, 30522) and (1024,
    4096), rows holding -1e9 and a row of only -1e9 (which must give
    1/cols) on both of its kernels, and a strided view; timed beside its
    bound, its plain version and ``torch.softmax``.  Then ``ops.nn.softmax``
    on bf16 at (4, 768), (2, 3, 512) and (8, 30522), last axis and axis
    0, on the card (the closed form: the fp32 kernel is not launched)
    against the port on the CPU, each value within one bf16 step of its
    own (the fp32 sums run in another order on the two devices, which may
    move a rounding of the sum by one step).
20. ``text_serve``: the launch counters set to 0, then
    ``ModelRegistry.load`` of a seeded BERT-base ``.params`` with
    ``dtype="int32"`` (warmup of every bucket), 32 closed-loop requests
    from one client and 64 from 8 client threads; every response finite
    (its sum and argmax kept, the 62.5 MB of logits dropped), and
    exactly 12 softmax and 25 LayerNorm launches per forward run.
    Device and eager ms per forward and ms of the copy of its logits to
    the host at each bucket, p50/p99 request ms,
    sequences/s and tokens/s, batch fill, peak memory.
21. ``text_reference``: card logits against the port on the CPU from
    the same ``.params`` at batch 1 x 512 (within 1e-4 of the largest
    logit, argmax equal at >= 99.9% of positions); the 64 concurrent
    requests served again, each response against the forward of its
    sequence alone on the card (same tolerance), and every
    ``text_serve`` response's argmax and sum against that forward.
22. ``text_profile``: one bucket-8 and one bucket-1 forward under
    ``torch.profiler``.
23. ``int8_kernels``: the int8 3x3/s1 conv + dequantization (+ add)
    (+ ReLU) kernel against its plain version (im2col + ``_int_mm`` +
    the same epilogue) at ResNet-50's four 3x3 stages at batch 64 and 8,
    the 7x7x512 stage at batch 1, ResNet-18's residual tail, ReLU off, a
    ragged shape (C = 20, odd H and W) and an exact case (scale 1, shift
    0: the output must equal the int32 sum bit for bit); every other
    case within 1e-6 of the output's largest magnitude (its epilogue is
    the plain version's two rounded operations, so it is bitwise in
    practice), and two launches on the same inputs bitwise equal (a
    gate).  Each case's plan (``qconv_splits``: bn, tiles, chunks,
    ranges, ``cut_tiles``), timed beside its bound (bytes over 3.35
    TB/s, int8 operations over 1,979 TOPS) and its share of it
    (``bound_share``), the rate at which its blocks copy operands into
    shared memory (``staged_tb_s``), its share of the card's
    ``mma.sync`` int8 ceiling (m16n8k32 on registers, compiled through
    ``rtc.CudaModule``, measured once a run: ``mma_s8_ceiling``), its
    plain version,
    ``torch._int_mm`` on the pre-built patch matrix and the fp32
    ``conv_affine``; at the nine stage shapes also the device µs of the
    main and the cut-tile kernel (``kernels_us``); and at the four
    batch-64 stages the kernel's time beside that of copies of it with
    the ring's copies or its products taken out (``parts``, built here by
    nvcc), which says which of the two bounds its loop.
24. ``int8_score``: ``int8_score.py`` at its defaults: ResNet-50 v1 from
    the ``image_serve`` ``.params``, batch 64, fp32 and int8 (two
    ``RandomState(1)`` calibration batches, naive) images/s over 4
    warm-up and 20 timed forwards on fresh inputs (CUDA events), the
    int8-vs-fp32 argmax agreement over 256 ``RandomState(0)`` images;
    the launch counters set to 0 before the int8 forwards and read after:
    exactly 16 int8-kernel and 0 ``conv_affine`` launches a forward.
25. ``int8_serve``: the counters set to 0, then ``ModelRegistry.load``
    of that ``.params`` with ``precision="int8"`` (the default
    calibration, warmup of every bucket), 32 closed-loop requests from
    one client and 64 from 8 client threads; every response finite and
    16 int8-kernel, 0 ``conv_affine`` launches per forward run.  p50/p99
    request ms, images/s, batch fill, device and eager ms per forward per
    bucket, peak memory; then ``int8_score.py``'s ``--serve`` leg: the
    int8 engine's QPS against the fp32 engine's at bucket 8 (fp32 stands
    in for bf16, which is not ported).
26. ``int8_reference``: card logits against the port on the CPU with the
    same int8 weights and thresholds (``state_from_numpy``) at batch 2
    (within 1e-3 of the largest logit, top-1 equal), and every batched
    response against the unbatched forward of its image (same
    tolerance).  The int32 sums are exact and the epilogues the same
    rounded operations on both devices, so only the average pool's sum
    order can differ; one pooled feature crossing a rounding boundary
    of the dense layer's input moves a logit by one int8 step of that
    product, and 1e-3 admits a few such steps and nothing larger.
27. ``int8_profile``: one bucket-8 and one bucket-1 int8 forward under
    ``torch.profiler``, with device time split into the int8 kernel,
    ``_int_mm``, the quantize passes, copies, pools and elementwise
    epilogues.
28. ``ext_kernels``: the three stock generated kernels (``tvm_vadd``,
    ``tvm_vmul``, ``tvm_sigmoid``: ``csrc/tvmop_elementwise.cuh`` with
    their bodies, compiled by NVRTC) against their plain versions at full
    width, one element, 1,000,003 elements (ragged for the 16-byte path),
    an offset view of that (the 16-byte path refused; for ``tvm_vadd``
    also at full width, timed) and float64 / int32 / int64: ``tvm_vadd``
    and ``tvm_vmul`` bit for bit, ``tvm_sigmoid`` within 1e-6 absolute.
    Timed at full width beside the bound (12 or 8 bytes an element over
    3.35 TB/s), the plain version and ``torch.add`` / ``torch.mul`` /
    ``torch.sigmoid``; each kernel's NVRTC compile, cold and from the
    CUBIN cache.
29. ``rtc``: the JAX package's rtc test kernels as CUDA source
    (``examples/rtc_kernels.cu``) through ``rtc.CudaModule``: axpy and
    ``double_it`` (out dtype float32 and int32, one templated kernel) at
    the tests' sizes and at full width, axpy also at 1,000,003 elements
    (16-byte vectors and a scalar tail) and on an offset view at full
    width (the scalar path), bit for bit against plain torch, the full
    width on the 16-byte path (``vector_path``); the module compiles once
    however often it launches; a launch from a second thread; an NVRTC
    syntax error raises with the log and a dtype mismatch raises
    ``TypeError``.  axpy timed (full width and the offset view) beside
    its bound, plain torch and ``torch.add(y, x, alpha=2)``
    (``vs_library``); the eager µs of one launch against one
    ``torch.add``.
30. ``ext_path``: the launch counters set to 0, then at full width
    ``nd.tvm_vadd`` and ``nd.tvm_vmul`` twice each, ``nd.tvm_sigmoid``
    forward and backward under ``autograd.record()`` (the gradient
    within 1e-6 of the plain closed form), a user ``tvmop.register`` of
    ``tvm_test_relu`` run once and unregistered, ``nd.Custom`` of a
    ``t_sigmoid`` ``CustomOp`` forward and backward (torch ops on the
    card), the example library built by ``library.compile_example`` and
    loaded, ``nd.my_relu6`` and ``nd.my_scale(k=3.0)`` forward and
    backward (the host round trip timed), and a user rtc axpy twice;
    every counter must equal the calls made.

Then one ``{"kernels": [...]}`` line (16 entries), the ``nvidia-smi`` line, and the
result line ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside this file, it exits non-zero and prints
no result.

    python3 chip_smoke.py --phases env,build,train_kernels

runs only the named phases, in that order, and prints their lines (no
kernels or result line).  Two commits are compared on one card by
running each checkout's own script in turns (parent, change, change,
parent), each on its own package and build.
"""
import json
import os
import re
import subprocess
import sys
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): device memory, fp32 on CUDA cores,
# dense int8 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
PEAK_TF32_FLOP_S = 495e12
PEAK_INT8_OPS_S = 1979e12

LN_TOL = 1e-5
ATTN_TOL = 1e-4
LSE_TOL = 1e-5
REF_TOL = 1e-3
BERT_STEPS = 6
BERT_LOSS_RTOL = 1e-4
MAX_NEW = 32
SEED = 0
SLEEP_CYCLES = 40_000_000      # ~20 ms at the H100's boost clock


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, repeats=5, sleep=SLEEP_CYCLES):
    """Device time of one call of ``fn`` in ms: the median over
    ``repeats`` CUDA-event windows of ``iters`` back-to-back calls.  Each
    window starts behind a device-side sleep of ``sleep`` cycles (~20 ms
    by default), so the host has queued every call before the first one
    runs and the window holds device time only, not the host's launch
    overhead: the sleep must outlast the host's time to queue the
    ``iters`` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[len(runs) // 2]


def eager_ms(fn, iters=20):
    """Wall time of one call of ``fn`` in ms when called back to back
    from Python, launch overhead included (what an eager caller sees)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(nbytes, flops, peak=PEAK_FP32_FLOP_S):
    """The least time of the work on this card: the larger of its bytes
    over the memory rate and its operations over ``peak``."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_flops = flops / peak * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


# ---------------------------------------------------------------- phases
def phase_env(state):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from mxnet_tpu_torch import _nvrtc, context
    context.exact_fp32()
    state["card"] = smi
    return {"card": smi, "device": torch.cuda.get_device_name(0),
            "nvrtc": _nvrtc.info(),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32}


def phase_build(state):
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.lib()
    ptxas, fn = {}, None
    for ln in _build.last_build_log.splitlines():
        m = re.search(r"entry function '\S*?(flash_fwd_tc|layernorm_fwd|"
                      r"attn_dq|attn_dkv|conv_affine_tc_kernel|"
                      r"conv_affine_reduce_kernel|"
                      r"conv3x3_tc_kernel|conv3x3_reduce_kernel|"
                      r"conv_stats_tc_kernel|conv_stats_cut_kernel|"
                      r"conv_wgrad_kernel|wgrad_reduce_kernel|"
                      r"layernorm_row_fwd|bn_affine_kernel|"
                      r"softmax_warp_kernel|softmax_block_kernel|"
                      r"qconv_affine_kernel|qconv_reduce_kernel)"
                      r"I((?:L[ib]\d+E)+)E", ln)
        if m:
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
            fn = f"{m.group(1)}<{args}>"
        elif "Compiling entry function" in ln:
            fn = None           # a kernel not listed: its lines are not ours
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            ptxas.setdefault(fn, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and fn:
            ptxas.setdefault(fn, {})["spill_store_bytes"] = int(m.group(1))
    return {"seconds": time.perf_counter() - t0,
            "nvcc_seconds": _build.last_build_s,
            "sources": [str(s.relative_to(HERE)) for s in _build.SOURCES],
            "ptxas": ptxas}


def _ln_case(rows, C, gen):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda_kernels import (layernorm_fused,
                                                  layernorm_plain)
    x = torch.randn(rows, C, device="cuda", generator=gen)
    g = 1 + 0.1 * torch.randn(C, device="cuda", generator=gen)
    b = 0.1 * torch.randn(C, device="cuda", generator=gen)
    out = layernorm_fused(x, g, b)
    ref = layernorm_plain(x, g, b)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    nbytes = (2 * rows * C + 2 * C) * 4
    flops = 8 * rows * C
    bms, by = bound(nbytes, flops)
    return {"shape": [rows, C], "max_abs_err": err, "tol": LN_TOL,
            "kernel_ms": cuda_ms(lambda: layernorm_fused(x, g, b)),
            "kernel_eager_ms": eager_ms(lambda: layernorm_fused(x, g, b)),
            "plain_ms": cuda_ms(lambda: layernorm_plain(x, g, b)),
            "library_ms": cuda_ms(
                lambda: F.layer_norm(x, (C,), g, b, 1e-5)),
            "bytes": nbytes, "flop": flops, "bound_ms": bms,
            "bound_by": by}


def _attn_case(B, H, L, hd, gen):
    """q/k/v as the GPT prefill passes them: per-head [q|k|v] views
    into one (B, L, 3*H*hd) projection."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda_attention import (causal_attention,
                                                    causal_attention_plain)
    t5 = torch.randn(B, L, H, 3, hd, device="cuda", generator=gen)
    q, k, v = (t5[:, :, :, i].transpose(1, 2) for i in range(3))
    scale = hd ** -0.5
    out = causal_attention(q, k, v, scale)
    again = causal_attention(q, k, v, scale)
    ref = causal_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    nbytes = 4 * B * H * L * hd * 4
    flops = 4 * B * H * hd * (L * (L + 1) // 2)
    case = {"shape": [B * H, L, hd], "max_abs_err": err, "tol": ATTN_TOL,
            "bitwise_equal_relaunch": bool(torch.equal(out, again)),
            "kernel_ms": cuda_ms(lambda: causal_attention(q, k, v, scale)),
            "kernel_eager_ms": eager_ms(
                lambda: causal_attention(q, k, v, scale)),
            "plain_ms": cuda_ms(
                lambda: causal_attention_plain(q, k, v, scale)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale))}
    return _tc_bounds(case, nbytes, flops)


def _tc_bounds(case, nbytes, flops):
    """Both bounds of a 3xTF32 kernel into ``case``: its three TF32
    products on the tensor cores (``bound_ms``) and the fp32 work on the
    CUDA cores beside it, with the kernel's share of the first and its
    time over the library call's."""
    fp32_ms, fp32_by = bound(nbytes, flops)
    tc_ms, tc_by = bound(nbytes, 3 * flops, PEAK_TF32_FLOP_S)
    case.update(bytes=nbytes, flop=flops, bound_ms=tc_ms, bound_by=tc_by,
                bound_fp32_ms=fp32_ms, bound_fp32_by=fp32_by,
                tf32_flop=3 * flops,
                tensor_core_bound_share=tc_ms / case["kernel_ms"],
                vs_library=case["kernel_ms"] / case["library_ms"])
    return case


def _ceiling_shares(state, cases):
    """Each 3xTF32 case's share of the card's ``mma.sync`` TF32 ceiling,
    measured once a run."""
    if "mma_tf32_ceiling" not in state:
        state["mma_tf32_ceiling"] = _mma_tf32_ceiling()
    tflop_s = state["mma_tf32_ceiling"]["tflop_s"]
    for c in cases:
        c["mma_sync_ceiling_share"] = \
            c["tf32_flop"] / (c["kernel_ms"] * 1e-3) / 1e12 / tflop_s
    return state["mma_tf32_ceiling"]


def phase_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ln = [_ln_case(r, 768, gen) for r in (4096, 512, 8, 1)] + \
        [_ln_case(64, 8192, gen), _ln_case(16, 30522, gen)]
    attn = [_attn_case(8, 6, 512, 128, gen), _attn_case(1, 6, 512, 128, gen),
            _attn_case(8, 12, 512, 64, gen), _attn_case(1, 6, 200, 128, gen)]
    bad = [c for c in ln + attn if not c["max_abs_err"] <= c["tol"] or
           not c.get("bitwise_equal_relaunch", True)]
    state["cases"] = {"layernorm_fused": ln, "causal_attention": attn}
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ceiling = _ceiling_shares(state, attn)
    return {"cases": state["cases"], "mma_tf32_ceiling": ceiling}


def _mean_us(h0, h1, name):
    a, b = h0.get(name, {}), h1.get(name, {})
    n = b.get("count", 0) - a.get("count", 0)
    return (b.get("sum", 0.0) - a.get("sum", 0.0)) / n if n > 0 else None


def phase_slice(state):
    import numpy as np
    import torch
    from mxnet_tpu_torch import DecodeBatcher, DecodeEngine, telemetry
    from mxnet_tpu_torch.models import gpt
    from mxnet_tpu_torch.ops.cuda_attention import causal_attention
    from mxnet_tpu_torch.ops.cuda_kernels import layernorm_fused

    cfg = gpt.GPTConfig(vocab_size=8192, hidden=768, layers=12, heads=6,
                        intermediate=3072, max_len=1024)
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    init_s = time.perf_counter() - t0
    rs = np.random.RandomState(SEED)
    prompt = rs.randint(1, cfg.vocab_size, size=48).tolist()
    state.update(cfg=cfg, prompt=prompt)

    layernorm_fused.launches = 0
    causal_attention.launches = 0
    telemetry.reset()
    t0 = time.perf_counter()
    eng = DecodeEngine(params, cfg, name="smoke-gpt", window=576,
                       buckets=(1, 8), prompts=(512,)).warmup()
    warmup_s = time.perf_counter() - t0
    state["engine"] = eng

    def leg(nreq):
        eng.generate([prompt] * nreq, max_new=2)
        h0 = telemetry.raw_snapshot()["histograms"]
        t0 = time.perf_counter()
        out = eng.generate([prompt] * nreq, max_new=MAX_NEW)
        dt = time.perf_counter() - t0
        h1 = telemetry.raw_snapshot()["histograms"]
        assert all(len(o) == MAX_NEW for o in out)
        assert all(0 <= t < cfg.vocab_size for o in out for t in o)
        return {"tokens_s": nreq * MAX_NEW / dt,
                "prefill_us": _mean_us(h0, h1, "decode.prefill_us"),
                "decode_step_us": _mean_us(h0, h1, "decode.decode_step_us"),
                "seconds": dt}, out

    b1, out1 = leg(1)
    b8, out8 = leg(8)
    b8["rows_equal_b1"] = all(o == out1[0] for o in out8)

    prompts = [rs.randint(1, cfg.vocab_size, size=n).tolist()
               for n in (5, 17, 48, 64, 100, 9)]
    got, errs = {}, []
    with DecodeBatcher(eng, slots=8, name="smoke") as bat:
        def one(i, p):
            try:
                got[i] = bat.submit(p, max_new=16, timeout=300)
            except Exception as e:
                errs.append(repr(e))

        ts = [threading.Thread(target=one, args=(i, p))
              for i, p in enumerate(prompts)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        bstats = bat.stats()
    if errs or len(got) != len(prompts):
        raise AssertionError(f"batcher requests failed: {errs}")
    singles = [eng.generate([p], max_new=16)[0] for p in prompts]
    launches = {"layernorm_fused": layernorm_fused.launches,
                "causal_attention": causal_attention.launches}
    state["launches"] = launches
    mismatched = [i for i in range(len(prompts)) if got[i] != singles[i]]
    if mismatched:
        raise AssertionError(f"batcher streams {mismatched} differ from "
                             "generate")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return {"config": {k: v for k, v in vars(cfg).items() if k != "dtype"},
            "window": 576, "buckets": [1, 8], "prompt_buckets": [512],
            "prompt_len": len(prompt), "max_new": MAX_NEW,
            "init_s": init_s, "warmup_s": warmup_s, "b1": b1, "b8": b8,
            "batcher": {"requests": len(prompts), "max_new": 16,
                        "joins": bstats["joins"],
                        "max_concurrent": bstats["max_concurrent"],
                        "streams_equal_generate": True},
            "launches": launches,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def phase_reference(state):
    """The same weights through the port on the CPU."""
    import torch
    from mxnet_tpu_torch import DecodeEngine
    from mxnet_tpu_torch.models import gpt

    cfg, prompt, eng = state["cfg"], state["prompt"], state["engine"]
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_params = gpt.init_params(cfg, seed=SEED, device="cpu")
    cpu = DecodeEngine(cpu_params, cfg, name="smoke-cpu", window=576,
                       buckets=(1,), prompts=(512,), device="cpu")
    toks = torch.zeros(1, 512, dtype=torch.long)
    toks[0, :len(prompt)] = torch.tensor(prompt)
    with torch.no_grad():
        lg = gpt.apply(eng.params, cfg, toks.cuda()).cpu()
        lc = gpt.apply(cpu_params, cfg, toks)
    prefill_err = (lg - lc).abs().max().item()

    # decode steps from the card's prefilled ring, the same on both sides
    ctl = eng.prefill([prompt])
    k, v = ctl["k"].clone(), ctl["v"].clone()
    kc, vc = k.cpu(), v.cpu()
    pos, tok = ctl["pos"].clone(), ctl["tok"].clone()
    step_err = 0.0
    with torch.no_grad():
        for _ in range(3):
            pos += 1
            a, _, _ = gpt.decode_step(eng.params, cfg, tok, pos, k, v)
            b, _, _ = gpt.decode_step(cpu_params, cfg, tok.cpu(), pos.cpu(),
                                      kc, vc)
            step_err = max(step_err, (a.cpu() - b).abs().max().item())
            tok = a.argmax(-1)

    card_toks = eng.generate([prompt], max_new=16)[0]
    cpu_toks = cpu.generate([prompt], max_new=16)[0]
    ok = (torch.allclose(lg, lc, atol=REF_TOL, rtol=REF_TOL) and
          step_err <= REF_TOL and card_toks == cpu_toks)
    res = {"prefill_logits_max_abs_diff": prefill_err,
           "decode_logits_max_abs_diff": step_err, "tol": REF_TOL,
           "greedy_tokens_equal": card_toks == cpu_toks,
           "tokens": card_toks}
    if not ok:
        raise AssertionError(f"card disagrees with the CPU: {res}")
    return res


# kernel-name patterns of the profile's categories, first match wins
KERNEL_CATEGORIES = (
    ("conv_affine (ours)", r"conv_affine_(tc|reduce)_kernel"),
    ("conv3x3 / dgrad (ours)", r"conv3x3_tc_kernel|conv3x3_reduce_kernel"),
    ("conv_stats (ours)", r"conv_stats_(tc|cut|sum)_kernel"),
    ("bn_affine (ours)", r"bn_affine_kernel"),
    ("conv_wgrad (ours)", r"conv_wgrad_kernel|wgrad_reduce_kernel"),
    ("batch norm", r"batch_norm|bn_fw"),
    ("layout transform", r"nchwToNhwc|nhwcToNchw"),
    ("cuDNN conv backward", r"dgrad|wgrad|bprop"),
    ("cuDNN conv", r"fprop|convolve|implicit_gemm|cudnn"),
    ("gemm", r"gemm|gemv|splitKreduce"),
    ("attention (ours)", r"attn_(dq|dkv)|flash_fwd_tc"),
    ("layernorm (ours)", r"layernorm_fwd"),
    ("softmax (ours)", r"softmax_(warp|block)_kernel"),
    ("optimizer foreach", r"multi_tensor_apply"),
    ("softmax", r"softmax"),
    ("pooling", r"pool"),
    ("reduction", r"reduce_kernel"),
    ("embedding / index", r"embedding|index|scatter|gather"),
    ("elementwise", r"elementwise|vectorized"),
)


def _category(name, categories=KERNEL_CATEGORIES):
    for cat, pat in categories:
        if re.search(pat, name, re.I):
            return cat
    return "other"


def _profile(fn, calls, top=6, categories=KERNEL_CATEGORIES):
    """Device view of ``calls`` calls of ``fn`` from torch.profiler:
    kernels per call, device-busy µs per call (union of kernel
    intervals), the idle share of the profiled wall time, the kernels
    that took the most device time, and device time by category."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"wall_us_per_call": wall_us / calls}
    if not kern:
        out["device"] = "not measured: the profiler recorded no kernels"
        return out
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    by_name = {}
    for e in kern:
        n = by_name.setdefault(e.name, [0, 0.0])
        n[0] += 1
        n[1] += e.time_range.end - e.time_range.start
    cats = {}
    for n, (c, t) in by_name.items():
        k = cats.setdefault(_category(n, categories), [0, 0.0])
        k[0] += c
        k[1] += t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    out.update(kernels_per_call=len(kern) / calls,
               by_category={k: {"per_call": c / calls,
                                "us_per_call": t / calls}
                            for k, (c, t) in sorted(
                                cats.items(), key=lambda kv: -kv[1][1])},
               device_busy_us_per_call=busy / calls,
               idle_share=1.0 - busy / wall_us,
               top=[{"kernel": n[:90], "per_call": c / calls,
                     "us_per_call": t / calls} for n, (c, t) in top])
    return out


def phase_profile(state):
    """Where the time goes on the path: prefill and decode step at
    batch 1 and 8, under torch.profiler (its own cost inflates the wall
    times here; the slice phase's times are the uninstrumented ones)."""
    eng, prompt = state["engine"], state["prompt"]
    res = {}
    for b in (1, 8):
        res[f"prefill_b{b}"] = _profile(lambda: eng.prefill([prompt] * b),
                                        2)
        ctl = eng.prefill([prompt] * b)
        res[f"decode_step_b{b}"] = _profile(lambda: eng.step(ctl), 5)
    return res


# ------------------------------------------------------------ BERT phases
def _bert_qkv(B, H, L, D, strided, gen):
    """q, k, v (B, H, L, D): views into one (B, L, 3*H*D) projection as
    BERT passes them, or contiguous tensors."""
    import torch
    if strided:
        t = torch.randn(B, L, 3 * H * D, device="cuda", generator=gen)
        return [x.view(B, L, H, D).transpose(1, 2)
                for x in t.split(H * D, dim=-1)]
    return [torch.randn(B, H, L, D, device="cuda", generator=gen)
            for _ in range(3)]


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def _flash_case(B, H, L, D, strided, gen):
    """The three kernels at one shape against their plain versions, fed
    the same lse and delta, and the backward kernels also on the forward
    kernel's lse; times of each beside its bound, its plain version and
    SDPA (``attention_fwd``: the forward, a 3xTF32 kernel priced on both
    bounds; ``attention_dq`` and ``attention_dkv``: SDPA's backward,
    which computes dq, dk and dv together)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    q, k, v = _bert_qkv(B, H, L, D, strided, gen)
    g = torch.randn(B, H, L, D, device="cuda", generator=gen)
    sc = D ** -0.5
    o, lse = fa.attention_fwd(q, k, v, sc)
    o2, lse2 = fa.attention_fwd(q, k, v, sc)
    ro, rlse = fa.attention_fwd_plain(q, k, v, sc)
    delta = (g * ro).sum(dim=-1).contiguous()
    dq = fa.attention_dq(q, k, v, g, rlse, delta, sc)
    rdq = fa.attention_dq_plain(q, k, v, g, rlse, delta, sc)
    dk, dv = fa.attention_dkv(q, k, v, g, rlse, delta, sc)
    rdk, rdv = fa.attention_dkv_plain(q, k, v, g, rlse, delta, sc)
    kdq = fa.attention_dq(q, k, v, g, lse, delta, sc)
    kdk, kdv = fa.attention_dkv(q, k, v, g, lse, delta, sc)
    torch.cuda.synchronize()

    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, scale=sc)
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (lq, lk, lv), g, retain_graph=True))
    bh, el = B * H, 4 * B * H * L * D       # one (B, H, L, D) fp32 in bytes
    shape = [bh, L, D]
    common = {"shape": shape, "strided": strided}
    dq_b = bound(5 * el + 8 * bh * L, 6 * bh * L * L * D)
    dkv_b = bound(6 * el + 8 * bh * L, 8 * bh * L * L * D)
    fwd = dict(
        common, max_abs_err=(o - ro).abs().max().item(),
        lse_max_abs_err=(lse - rlse).abs().max().item(),
        tol=ATTN_TOL, lse_tol=LSE_TOL,
        bitwise_equal_relaunch=bool(torch.equal(o, o2) and
                                    torch.equal(lse, lse2)),
        kernel_ms=cuda_ms(lambda: fa.attention_fwd(q, k, v, sc)),
        kernel_eager_ms=eager_ms(lambda: fa.attention_fwd(q, k, v, sc)),
        plain_ms=cuda_ms(lambda: fa.attention_fwd_plain(q, k, v, sc)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=sc)),
        library="F.scaled_dot_product_attention")
    cases = {
        "attention_fwd": _tc_bounds(fwd, 4 * el + 4 * bh * L,
                                    4 * bh * L * L * D),
        "attention_dq": dict(
            common, max_abs_err=(dq - rdq).abs().max().item(),
            rel_err=_rel(dq, rdq), rel_err_kernel_lse=_rel(kdq, rdq),
            tol=ATTN_TOL,
            kernel_ms=cuda_ms(lambda: fa.attention_dq(
                q, k, v, g, rlse, delta, sc)),
            kernel_eager_ms=eager_ms(lambda: fa.attention_dq(
                q, k, v, g, rlse, delta, sc)),
            plain_ms=cuda_ms(lambda: fa.attention_dq_plain(
                q, k, v, g, rlse, delta, sc)),
            library_ms=lib_bwd_ms, library="SDPA backward (dq, dk, dv)",
            bound_ms=dq_b[0], bound_by=dq_b[1]),
        "attention_dkv": dict(
            common, max_abs_err=max((dk - rdk).abs().max().item(),
                                    (dv - rdv).abs().max().item()),
            rel_err=max(_rel(dk, rdk), _rel(dv, rdv)),
            rel_err_kernel_lse=max(_rel(kdk, rdk), _rel(kdv, rdv)),
            tol=ATTN_TOL,
            kernel_ms=cuda_ms(lambda: fa.attention_dkv(
                q, k, v, g, rlse, delta, sc)),
            kernel_eager_ms=eager_ms(lambda: fa.attention_dkv(
                q, k, v, g, rlse, delta, sc)),
            plain_ms=cuda_ms(lambda: fa.attention_dkv_plain(
                q, k, v, g, rlse, delta, sc)),
            library_ms=lib_bwd_ms, library="SDPA backward (dq, dk, dv)",
            bound_ms=dkv_b[0], bound_by=dkv_b[1]),
    }
    return cases


def _flash_ok(name, c):
    if name == "attention_fwd":
        return c["max_abs_err"] <= c["tol"] and \
            c["lse_max_abs_err"] <= c["lse_tol"] and \
            c["bitwise_equal_relaunch"]
    return c["rel_err"] <= c["tol"] and c["rel_err_kernel_lse"] <= c["tol"]


def phase_bert_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # BERT-base's path shape first (B=16, 12 heads of 64, T=128, views
    # into the qkv projection), then long, ragged, and ragged strided
    shapes = [(16, 12, 128, 64, True), (8, 12, 512, 64, False),
              (1, 6, 200, 128, False), (2, 4, 200, 128, True)]
    per = [_flash_case(*sh, gen) for sh in shapes]
    bad = []
    for name in ("attention_fwd", "attention_dq", "attention_dkv"):
        state["cases"][name] = [c[name] for c in per]
        bad += [(name, c) for c in state["cases"][name]
                if not _flash_ok(name, c)]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ceiling = _ceiling_shares(state, state["cases"]["attention_fwd"])
    return {"cases": {n: state["cases"][n] for n in
                      ("attention_fwd", "attention_dq", "attention_dkv")},
            "mma_tf32_ceiling": ceiling}


def phase_bert_train(state):
    """BERT-base pretraining through the example's entry point, on the
    card, with the launch counters read around it."""
    import math
    import torch
    from mxnet_tpu_torch.examples import bert_pretrain
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda_kernels import layernorm_fused
    torch.cuda.reset_peak_memory_stats()
    counted = (layernorm_fused, fa.attention_fwd, fa.attention_dq,
               fa.attention_dkv)
    for fn in counted:
        fn.launches = 0
    argv = ["--steps", str(BERT_STEPS), "--seed", str(SEED)]
    out = bert_pretrain.main(argv)
    launches = {fn.__name__: fn.launches for fn in counted}
    state["bert_launches"] = launches
    losses = out["losses"]
    want = {"layernorm_fused": 25 * BERT_STEPS,
            "attention_fwd": 12 * BERT_STEPS,
            "attention_dq": 12 * BERT_STEPS,
            "attention_dkv": 12 * BERT_STEPS}
    steady = sorted(out["step_s"][1:])
    res = {"args": vars(bert_pretrain.parse_args(argv)),
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "losses": losses,
           "step_ms_median_1_5": steady[len(steady) // 2] * 1e3,
           "step_ms": [t * 1e3 for t in out["step_s"]],
           "tokens_s": out["tokens_s"], "launches": launches,
           "launches_expected": want,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    state["bert_step_ms"] = res["step_ms_median_1_5"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {res}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall from step 0: {res}")
    if launches != want:
        raise AssertionError(f"launch counts differ from the path's: {res}")
    return res


def phase_bert_reference(state):
    """One step from the same seeded weights and batch, on the card and
    through the port on the CPU."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import bert_pretrain
    torch.set_num_threads(os.cpu_count() or 1)
    args = bert_pretrain.parse_args(["--batch-size", "2"])
    cfg = bert_pretrain.config(args)
    tokens, labels = bert_pretrain.synthetic_batch(
        np.random.RandomState(SEED + 2), 2, args.seq_len, args.vocab)
    sides = {}
    for dev in ("cuda", "cpu"):
        tr = bert_pretrain.Trainer(cfg, SEED, args.lr, dev)
        loss, gs = tr.grads(torch.as_tensor(tokens, device=tr.device),
                            torch.as_tensor(labels, device=tr.device))
        tr.update(gs)
        sides[dev] = (float(loss), [x.cpu() for x in gs],
                      [w.detach().cpu() for w in tr.flat])
        del tr, gs
    (lc, gc, wc), (lp, gp, wp) = sides["cuda"], sides["cpu"]
    loss_rel = abs(lc - lp) / abs(lp)
    grad_rel = max(_rel(a, b) for a, b in zip(gc, gp))
    w_err = max((a - b).abs().max().item() for a, b in zip(wc, wp))
    res = {"batch": [2, args.seq_len], "loss_card": lc, "loss_cpu": lp,
           "loss_rel": loss_rel, "loss_tol": BERT_LOSS_RTOL,
           "grad_rel_to_max": grad_rel, "grad_tol": REF_TOL,
           "params_after_step_max_abs_diff": w_err,
           "params_tol": 2 * args.lr, "leaves": len(gc)}
    if not (loss_rel <= BERT_LOSS_RTOL and grad_rel <= REF_TOL and
            w_err <= 2 * args.lr):
        raise AssertionError(f"card disagrees with the CPU: {res}")
    return res


def phase_bert_profile(state):
    """Where one BERT-base train step's time goes, under torch.profiler
    (its own cost inflates the wall time; ``bert_train``'s step time is
    the uninstrumented one)."""
    import numpy as np
    from mxnet_tpu_torch.examples import bert_pretrain
    args = bert_pretrain.parse_args([])
    tr = bert_pretrain.Trainer(bert_pretrain.config(args), SEED, args.lr,
                               "cuda")
    tokens, labels = bert_pretrain.synthetic_batch(
        np.random.RandomState(SEED), args.batch_size, args.seq_len,
        args.vocab)
    float(tr.step(tokens, labels))
    res = _profile(lambda: float(tr.step(tokens, labels)), 1, top=12)
    busy = res.get("device_busy_us_per_call")
    if busy is not None:
        res["idle_share_vs_uninstrumented_step"] = \
            1.0 - busy / (state["bert_step_ms"] * 1e3)
    return res


# ----------------------------------------------------------- image phases
CONV_TOL = 1e-4
IMG_REF_TOL = 1e-4
RESNET50_SEGMENTS = 16          # 3x3/s1 frozen conv+BN segments a forward


def _conv_case(N, H, W, C, Cout, gen, residual=False, relu=True,
               split=False):
    """``conv_affine`` against ``conv_affine_plain`` at one shape, twice
    on the same inputs (the two outputs must be bitwise equal), with its
    plan, timed beside both bounds (fp32 on the CUDA cores; the three TF32
    products of its 3xTF32 scheme on the tensor cores, the line's
    ``bound_ms``), its plain version and ``F.conv2d`` alone (cuDNN,
    channels-last, TF32 off): the nearest single library call, which
    does less work than the kernel (no BN fold, residual or ReLU).
    ``split``: also the device µs of each kernel it launches (the main
    kernel and the cut-tile reduce)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.conv_block import conv_affine, conv_affine_plain
    x = torch.randn(N, H, W, C, device="cuda", generator=gen)
    w = torch.randn(3, 3, C, Cout, device="cuda", generator=gen) * \
        (2.0 / (9 * C)) ** 0.5
    g = 1 + 0.1 * torch.randn(Cout, device="cuda", generator=gen)
    b = 0.1 * torch.randn(Cout, device="cuda", generator=gen)
    mu = 0.1 * torch.randn(Cout, device="cuda", generator=gen)
    var = 0.5 + torch.rand(Cout, device="cuda", generator=gen)
    res = torch.randn(N, H, W, Cout, device="cuda", generator=gen) \
        if residual else None
    args = (x, w, g, b, mu, var, res)
    out = conv_affine(*args, relu=relu)
    again = conv_affine(*args, relu=relu)
    ref = conv_affine_plain(*args, relu=relu)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    xc = x.permute(0, 3, 1, 2)                      # channels-last view
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    npix = N * H * W
    nbytes = 4 * (npix * C + 9 * C * Cout + npix * Cout * (2 if residual
                                                           else 1)
                  + 4 * Cout)
    flops = 2 * npix * 9 * C * Cout
    kms = cuda_ms(lambda: conv_affine(*args, relu=relu))
    case = {"shape": [N, H, W, C, Cout], "residual": residual, "relu": relu,
            "plan": _conv3x3_plan(npix, C, Cout,
                                  "mxt_conv_affine_tc_blocks_per_sm"),
            "max_abs_err": err, "rel_err": err / max(scale, 1e-30),
            "tol": CONV_TOL,
            "bitwise_equal_relaunch": bool(torch.equal(out, again)),
            "kernel_ms": kms,
            "kernel_eager_ms": eager_ms(lambda: conv_affine(*args,
                                                            relu=relu)),
            "plain_ms": cuda_ms(lambda: conv_affine_plain(*args,
                                                          relu=relu)),
            "library_ms": cuda_ms(lambda: F.conv2d(xc, wc, padding=1)),
            "library": "F.conv2d alone (cuDNN, channels-last; no BN fold, "
                       "residual or ReLU)",
            "tflop_s": flops / (kms * 1e-3) / 1e12}
    if split:
        case["kernels_us"] = _kernel_us(lambda: conv_affine(*args,
                                                            relu=relu))
    return _tc_bounds(case, nbytes, flops)


def phase_image_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    # ResNet-50's four 3x3 stages at batch 8 (the path shape first), the
    # batch-1 tail, ResNet-18's residual tail, relu off, and a ragged one
    cases = [_conv_case(8, 56, 56, 64, 64, gen, split=True),
             _conv_case(8, 28, 28, 128, 128, gen, split=True),
             _conv_case(8, 14, 14, 256, 256, gen, split=True),
             _conv_case(8, 7, 7, 512, 512, gen, split=True),
             _conv_case(1, 7, 7, 512, 512, gen, split=True),
             _conv_case(8, 56, 56, 64, 64, gen, residual=True),
             _conv_case(8, 28, 28, 128, 128, gen, relu=False),
             _conv_case(2, 13, 17, 24, 40, gen, residual=True)]
    state["cases"]["conv_affine"] = cases
    bad = [c for c in cases if not (c["rel_err"] <= c["tol"] and
                                    c["bitwise_equal_relaunch"])]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ceiling = _ceiling_shares(state, cases)
    return {"cases": cases, "mma_tf32_ceiling": ceiling}


def _resnet50_params(path):
    """ResNet-50 v1 (1000 classes) with the port's seeded initializer
    and plausible frozen BatchNorm statistics (γ near 1, β and μ small,
    σ² uniform in [0.5, 1.5]), saved to ``path`` as a ``.params``."""
    import torch
    from mxnet_tpu_torch.models import get_model
    net = get_model("resnet50_v1", classes=1000)
    net.initialize(seed=SEED, ctx="cpu")
    net(torch.zeros(1, 32, 32, 3))      # deferred shapes take their values
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, t in net.collect_params().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                t.copy_(1 + 0.1 * torch.randn(t.shape, generator=gen))
            elif leaf in ("beta", "running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif leaf == "running_var":
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
    net.save_parameters(path)


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


def phase_image_serve(state):
    """ResNet-50 v1 at 224x224x3 through ``ModelRegistry.load`` (the
    default ladder 1, 2, 4, 8) and its ``Batcher``: a closed loop of one
    client, then 8 client threads.  The launch counter is set to 0
    before the load and read after the traffic: 16 per forward run."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops.conv_block import conv_affine
    from mxnet_tpu_torch.serve import ModelRegistry

    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "resnet50_v1.params")
    t0 = time.perf_counter()
    _resnet50_params(path)
    init_s = time.perf_counter() - t0
    rs = np.random.RandomState(SEED)
    images = rs.rand(64, 224, 224, 3).astype(np.float32)
    state.update(image_params=path, images=images)

    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()      # earlier phases' state
    conv_affine.launches = 0
    telemetry.reset()
    reg = ModelRegistry()
    t0 = time.perf_counter()
    entry = reg.load("resnet50", path, arch="resnet50_v1",
                     item_shape=(224, 224, 3))
    load_s = time.perf_counter() - t0
    state.update(image_registry=reg, image_engine=entry.engine)

    lat, outs = [], []
    for i in range(32):
        t1 = time.perf_counter()
        outs.append(reg.predict("resnet50", images[i])[0])
        lat.append((time.perf_counter() - t1) * 1e3)

    got, errs = {}, []

    def client(c):
        try:
            for j in range(8):
                k = 8 * c + j
                got[k] = reg.predict("resnet50", images[k], timeout=300)[0]
        except Exception as e:
            errs.append(repr(e))

    h0 = telemetry.raw_snapshot()["histograms"].get("serve.batch_fill", {})
    b0 = telemetry.raw_snapshot()["counters"].get("serve.batches", 0)
    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    t1 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    conc_s = time.perf_counter() - t1
    snap = telemetry.raw_snapshot()
    launches = conv_affine.launches
    h1 = snap["histograms"].get("serve.batch_fill", {})
    batches = snap["counters"].get("serve.batches", 0)
    forwards = entry.engine.forwards     # warmups, the batcher's, traffic
    state["image_launches"] = {"conv_affine": launches}
    state["image_batched"] = got
    if errs or len(got) != 64:
        raise AssertionError(f"concurrent requests failed: {errs}")
    bad = [o for o in outs + list(got.values())
           if o.shape != (1, 1000) or not np.isfinite(o).all()]
    if bad:
        raise AssertionError(f"{len(bad)} responses not finite (1, 1000)")
    if launches != RESNET50_SEGMENTS * forwards:
        raise AssertionError(f"conv_affine launched {launches} times in "
                             f"{forwards} forwards")

    eng = entry.engine
    per_bucket = {}
    for b in eng.buckets:
        x = torch.as_tensor(images[:b], device="cuda")
        per_bucket[b] = {
            # two forwards per CUDA-event window: the host queues both
            # inside the device-side sleep, so the window is device time
            "device_ms": cuda_ms(lambda: eng.run(x), iters=2, repeats=5),
            "eager_ms": eager_ms(lambda: eng.run(x), iters=10)}
    hist = snap["histograms"]
    return {"model": "resnet50_v1", "classes": 1000,
            "item_shape": [224, 224, 3], "buckets": list(eng.buckets),
            "init_s": init_s, "load_and_warmup_s": load_s,
            "closed_loop": {"requests": 32, "p50_ms": _pct(lat, 50),
                            "p99_ms": _pct(lat, 99), "mean_ms":
                            sum(lat) / len(lat), "first_ms": lat[0],
                            "max_ms": max(lat)},
            "concurrent": {"clients": 8, "requests": 64, "seconds": conc_s,
                           "images_s": 64 / conc_s,
                           "batches": batches - b0,
                           "mean_batch_fill":
                           (h1.get("sum", 0) - h0.get("sum", 0)) /
                           max(1, h1.get("count", 0) - h0.get("count", 0))},
            "queue_wait_us_mean": _mean_us({}, hist, "serve.queue_wait_us"),
            "device_us_mean": _mean_us({}, hist, "serve.device_us"),
            "per_bucket": per_bucket,
            "launches": {"conv_affine": launches, "forwards": forwards,
                         "per_forward": launches / forwards},
            "engine": {k: v for k, v in eng.stats().items()
                       if k in ("retraces", "programs", "precision",
                                "param_bytes_per_device")},
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "mem_before_bytes": mem_before}


def phase_image_reference(state):
    """The card's engine against the port on the CPU from the same
    ``.params`` at batch 2, and each batched response against the
    unbatched forward of its image (a tolerance, not bitwise: the
    reference's bitwise batching tests are red on the CPU)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.serve import InferenceEngine
    torch.set_num_threads(os.cpu_count() or 1)
    eng, images = state["image_engine"], state["images"]
    x2 = images[:2]
    card = eng.run(x2)[0].cpu().numpy()
    net = get_model("resnet50_v1", classes=1000)
    net.load_parameters(state["image_params"])
    cpu = InferenceEngine(net, (224, 224, 3), buckets=(2,),
                          device="cpu").run(x2)[0].numpy()
    ref_err = float(np.abs(card - cpu).max())
    ref_scale = float(np.abs(cpu).max())
    top1 = bool((card.argmax(-1) == cpu.argmax(-1)).all())

    bat_err, bat_scale, bitwise = 0.0, 0.0, 0
    for k, out in state["image_batched"].items():
        one = eng.run(images[k:k + 1])[0].cpu().numpy()
        bat_err = max(bat_err, float(np.abs(out - one).max()))
        bat_scale = max(bat_scale, float(np.abs(one).max()))
        bitwise += int(np.array_equal(out, one))
    state["image_registry"].close()
    res = {"batch": 2, "logits_max_abs_diff": ref_err,
           "logits_max_abs": ref_scale, "tol": IMG_REF_TOL,
           "top1_equal": top1,
           "batched_vs_unbatched_max_abs_diff": bat_err,
           "batched_max_abs": bat_scale,
           "batched_bitwise_equal": bitwise,
           "batched_responses": len(state["image_batched"])}
    if not (ref_err <= IMG_REF_TOL * ref_scale and top1 and
            bat_err <= IMG_REF_TOL * bat_scale):
        raise AssertionError(f"card disagrees: {res}")
    return res


def phase_image_profile(state):
    """Where a ResNet-50 forward's time goes: one bucket-8 and one
    bucket-1 forward under torch.profiler."""
    import torch
    eng, images = state["image_engine"], state["images"]
    res = {}
    for b in (8, 1):
        x = torch.as_tensor(images[:b], device="cuda")
        eng.run(x)
        res[f"forward_b{b}"] = _profile(lambda: eng.run(x), 1, top=8)
    return res


# -------------------------------------------------------- training phases
TRAIN_TOL = 1e-4            # z, dx, dW: of the tensor's largest magnitude
STATS_RTOL = 1e-5           # sum(z), sum(z^2)
AFFINE_TOL = 1e-6           # bn_affine: of the output's largest magnitude
TRAIN_ITERS = 8
TRAIN_LOSS_RTOL = 1e-4
TRAIN_REF_TOL = 1e-2        # gradients, updates: of the net's largest
TRAIN_STATS_TOL = 1e-5


def _timed(case, fn, plain, library, nbytes, flops, iters=10):
    """Times of ``fn`` (device and eager), its plain version and the
    library call, beside the bound, into ``case``."""
    bms, by = bound(nbytes, flops)
    kms = cuda_ms(fn, iters=iters)
    case.update(kernel_ms=kms, kernel_eager_ms=eager_ms(fn, iters=iters),
                plain_ms=cuda_ms(plain, iters=iters),
                library_ms=cuda_ms(library, iters=iters), bytes=nbytes,
                flop=flops, bound_ms=bms, bound_by=by,
                tflop_s=flops / (kms * 1e-3) / 1e12)
    return case


def _kernel_us(fn, calls=5):
    """Device µs per call of each kernel ``fn`` launches, by name (its
    namespace and template arguments dropped), from torch.profiler."""
    out = {}
    for t in _profile(fn, calls, top=8).get("top", []):
        name = t["kernel"].replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("<")[0].split("(")[0]
        out[name] = out.get(name, 0.0) + t["us_per_call"]
    return out


def _rel_err(out, ref):
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def _train_conv_cases(N, H, W, C, Cout, gen, dgrad_only=False):
    """conv3x3, its dgrad use, conv_stats and conv_wgrad at one shape,
    against their plain versions.  The library yardsticks (cuDNN,
    channels-last, TF32 off) are F.conv2d for the forward and
    torch.nn.grad.conv2d_input / conv2d_weight for dgrad / wgrad; each
    does no more than the kernel (conv_stats' also leaves out the
    sums)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import conv_block as cb
    x = torch.randn(N, H, W, C, device="cuda", generator=gen)
    w = torch.randn(3, 3, C, Cout, device="cuda", generator=gen) * \
        (2.0 / (9 * C)) ** 0.5
    dy = torch.randn(N, H, W, Cout, device="cuda", generator=gen)
    npix = N * H * W
    flops = 2 * npix * 9 * C * Cout
    conv_bytes = 4 * (npix * (C + Cout) + 9 * C * Cout)
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    dyc = dy.permute(0, 3, 1, 2)
    shape = [N, H, W, C, Cout]
    out = {}

    wr = cb.rotate(w)
    dx = cb.conv3x3_dgrad(w, dy)
    again = cb.conv3x3(dy, wr)
    rdx = cb.conv3x3_plain(dy, wr)
    err, rel = _rel_err(dx, rdx)
    out["conv3x3_dgrad"] = _tc_bounds(_timed(
        {"shape": shape, "use": "dgrad: conv3x3(dy, rotate(w))",
         "plan": _conv3x3_plan(N * H * W, Cout, C),
         "max_abs_err": err, "rel_err": rel, "tol": TRAIN_TOL,
         "bitwise_equal_relaunch": bool(torch.equal(dx, again)),
         "library": "torch.nn.grad.conv2d_input (cuDNN)"},
        lambda: cb.conv3x3(dy, wr), lambda: cb.conv3x3_plain(dy, wr),
        lambda: torch.nn.grad.conv2d_input(xc.shape, wc, dyc, padding=1),
        conv_bytes, flops), conv_bytes, flops)

    out["conv_wgrad"] = _wgrad_case(x, dy, xc, wc, dyc, shape, conv_bytes,
                                    flops)
    if dgrad_only:
        return out

    z = cb.conv3x3(x, w)
    again = cb.conv3x3(x, w)
    rz = cb.conv3x3_plain(x, w)
    err, rel = _rel_err(z, rz)
    out["conv3x3"] = _tc_bounds(_timed(
        {"shape": shape, "use": "forward",
         "plan": _conv3x3_plan(N * H * W, C, Cout), "max_abs_err": err,
         "rel_err": rel, "tol": TRAIN_TOL,
         "bitwise_equal_relaunch": bool(torch.equal(z, again)),
         "library": "F.conv2d (cuDNN, channels-last)"},
        lambda: cb.conv3x3(x, w), lambda: cb.conv3x3_plain(x, w),
        lambda: F.conv2d(xc, wc, padding=1), conv_bytes, flops),
        conv_bytes, flops)
    out["conv3x3"]["kernels_us"] = _kernel_us(lambda: cb.conv3x3(x, w))

    zs, s1, s2 = cb.conv_stats(x, w)
    again = cb.conv_stats(x, w)
    rz, r1, r2 = cb.conv_stats_plain(x, w)
    err, rel = _rel_err(zs, rz)
    mag = rz.abs().sum(dim=(0, 1, 2))
    s1_rel = ((s1 - r1).abs() / mag).max().item()
    s2_rel = ((s2 - r2).abs() / r2.abs()).max().item()
    plan = _conv3x3_plan(N * H * W, C, Cout,
                         "mxt_conv_stats_tc_blocks_per_sm")
    conv_plan = _conv3x3_plan(N * H * W, C, Cout)
    stats_bytes = conv_bytes + 8 * Cout
    out["conv_stats"] = _tc_bounds(_timed(
        {"shape": shape, "plan": plan, "conv3x3_plan": conv_plan,
         "max_abs_err": err, "rel_err": rel,
         "tol": TRAIN_TOL, "sum_rel_err": s1_rel, "sumsq_rel_err": s2_rel,
         "stats_rtol": STATS_RTOL,
         "bitwise_equal_relaunch": all(
             bool(torch.equal(a, b)) for a, b in zip((zs, s1, s2), again)),
         # None where the plans differ: the ranges cut the sums elsewhere
         "z_equals_conv3x3": bool(torch.equal(zs, z))
         if plan == conv_plan else None,
         "library": "F.conv2d alone (cuDNN; no sums)"},
        lambda: cb.conv_stats(x, w), lambda: cb.conv_stats_plain(x, w),
        lambda: F.conv2d(xc, wc, padding=1), stats_bytes, flops),
        stats_bytes, flops)
    out["conv_stats"]["kernels_us"] = _kernel_us(lambda: cb.conv_stats(x, w))
    return out


def _wgrad_case(x, dy, xc, wc, dyc, shape, nbytes, flops):
    """``conv_wgrad`` against its plain version, twice on the same inputs
    (the two dW must be bitwise equal), timed beside both bounds: fp32
    on the CUDA cores and the three TF32 products of its 3xTF32 scheme on
    the tensor cores (the line's ``bound_ms``)."""
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    dw = cb.conv_wgrad(x, dy)
    again = cb.conv_wgrad(x, dy)
    rdw = cb.conv_wgrad_plain(x, dy)
    err, rel = _rel_err(dw, rdw)
    N, H, W, C, Cout = shape
    vec = int(C % 4 == 0 and Cout % 4 == 0)
    plan = cb.wgrad_splits(N * H * W, 9 * C, Cout, cb._sm_count(0),
                           cb._per_sm("mxt_conv_wgrad_blocks_per_sm", 0,
                                      cb.wgrad_tile_cols(Cout), vec))
    return _tc_bounds(_timed(
        {"shape": shape, "plan": plan._asdict(), "max_abs_err": err,
         "rel_err": rel, "tol": TRAIN_TOL,
         "bitwise_equal_relaunch": bool(torch.equal(dw, again)),
         "library": "torch.nn.grad.conv2d_weight (cuDNN)"},
        lambda: cb.conv_wgrad(x, dy), lambda: cb.conv_wgrad_plain(x, dy),
        lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, dyc, padding=1),
        nbytes, flops), nbytes, flops)


def _conv3x3_plan(M, C, Cout, entry="mxt_conv3x3_tc_blocks_per_sm"):
    """The plan ``conv3x3`` (or, by its occupancy ``entry``,
    ``conv_stats`` or ``conv_affine``) runs at this shape on card 0."""
    from mxnet_tpu_torch.ops import conv_block as cb
    vec = int(C % 4 == 0 and Cout % 4 == 0)
    return _plan_dict(cb.conv3x3_splits(
        M, 9 * C, Cout, cb._sm_count(0),
        cb._per_sm(entry, 0, cb.wgrad_tile_cols(Cout), vec)))


def _plan_dict(plan):
    """A stream-K plan's fields and the number of tiles it cuts (finished
    by the cut-tile kernel, not the main one)."""
    from mxnet_tpu_torch.ops import conv_block as cb
    return {**plan._asdict(), "cut_tiles": sum(
        1 for _, k, _ in cb.tile_writers(plan) if k == "cut")}


MMA_TF32_PEAK_SRC = r"""
extern "C" __global__ void mma_tf32_peak(float* out, int iters) {
  const unsigned v = __float_as_uint(1.0f + threadIdx.x * 1e-3f) & 0xffffe000u;
  const unsigned a0 = v, a1 = v ^ 0x2000u, a2 = v, a3 = v ^ 0x4000u;
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
            "+f"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(a1), "r"(a3));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
"""


def _mma_tf32_ceiling():
    """What ``mma.sync.m16n8k8`` TF32 sustains on this card: every warp
    issues independent products on registers (8 accumulators, no memory
    in the loop), 8 warps a block, 2 blocks an SM; compiled by NVRTC
    through ``rtc.CudaModule``.  The ceiling of any ``mma.sync`` TF32
    kernel, beside the 495 TFLOP/s dense peak that ``wgmma`` can reach."""
    import torch
    from mxnet_tpu_torch import rtc
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    kern = rtc.CudaModule(MMA_TF32_PEAK_SRC).get_kernel("mma_tf32_peak")
    run = lambda: kern.launch([iters], grid=(blocks,), block=(256,),  # noqa
                              out_shape=(blocks * 256,))
    ms = cuda_ms(run, iters=3)
    flop = blocks * 8 * iters * 8 * 2 * 16 * 8 * 8
    return {"blocks": blocks, "ms": ms, "flop": flop,
            "tflop_s": flop / (ms * 1e-3) / 1e12,
            "share_of_dense_peak": flop / (ms * 1e-3) / PEAK_TF32_FLOP_S}


def _affine_case(N, H, W, C, gen, residual=False, relu=True):
    import torch
    from mxnet_tpu_torch.ops import conv_block as cb
    z = torch.randn(N, H, W, C, device="cuda", generator=gen)
    scale = 1 + 0.1 * torch.randn(C, device="cuda", generator=gen)
    shift = 0.1 * torch.randn(C, device="cuda", generator=gen)
    res = torch.randn(N, H, W, C, device="cuda", generator=gen) \
        if residual else None
    out = cb.bn_affine(z, scale, shift, res, relu)
    ref = cb.bn_affine_plain(z, scale, shift, res, relu)
    err, rel = _rel_err(out, ref)
    n = N * H * W * C
    return _timed(
        {"shape": [N, H, W, C], "residual": residual, "relu": relu,
         "max_abs_err": err, "rel_err": rel, "tol": AFFINE_TOL,
         "library": "torch.addcmul(shift, z, scale) (no residual, ReLU)"},
        lambda: cb.bn_affine(z, scale, shift, res, relu),
        lambda: cb.bn_affine_plain(z, scale, shift, res, relu),
        lambda: torch.addcmul(shift, z, scale),
        4 * (n * (3 if residual else 2) + 2 * C),
        n * (2 + int(residual) + int(relu)))


def _train_ok(name, c):
    if not c["rel_err"] <= c["tol"]:
        return False
    if name in ("conv3x3", "conv_wgrad"):
        return c["bitwise_equal_relaunch"]
    if name == "conv_stats":
        return c["sum_rel_err"] <= c["stats_rtol"] and \
            c["sumsq_rel_err"] <= c["stats_rtol"] and \
            c["bitwise_equal_relaunch"] and \
            c["z_equals_conv3x3"] is not False
    return True


def phase_train_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    # ResNet-50's four 3x3 stages at batch 64 (the path's first), then a
    # C != Cout backward, and a ragged shape
    per = [_train_conv_cases(64, 56, 56, 64, 64, gen),
           _train_conv_cases(64, 28, 28, 128, 128, gen),
           _train_conv_cases(64, 14, 14, 256, 256, gen),
           _train_conv_cases(64, 7, 7, 512, 512, gen),
           _train_conv_cases(8, 28, 28, 64, 128, gen, dgrad_only=True),
           _train_conv_cases(2, 13, 17, 24, 40, gen)]
    cases = {"conv3x3": [c[k] for c in per for k in ("conv3x3_dgrad",
                                                    "conv3x3") if k in c],
             "conv_stats": [c["conv_stats"] for c in per
                            if "conv_stats" in c],
             "conv_wgrad": [c["conv_wgrad"] for c in per],
             "bn_affine": [_affine_case(64, 56, 56, 64, gen),
                           _affine_case(64, 28, 28, 128, gen),
                           _affine_case(64, 14, 14, 256, gen),
                           _affine_case(64, 7, 7, 512, gen),
                           _affine_case(64, 56, 56, 64, gen, residual=True),
                           _affine_case(64, 28, 28, 128, gen, relu=False),
                           _affine_case(2, 13, 17, 40, gen, residual=True,
                                        relu=False)]}
    state["cases"].update(cases)
    bad = [(n, c) for n, cs in cases.items() for c in cs
           if not _train_ok(n, c)]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ceiling = _ceiling_shares(state, cases["conv3x3"] + cases["conv_stats"] +
                              cases["conv_wgrad"])
    return {"cases": cases, "mma_tf32_ceiling": ceiling}


TRAIN_KERNELS = ("conv3x3", "conv_stats", "bn_affine", "conv_wgrad")


def _train_counters():
    from mxnet_tpu_torch.ops import conv_block as cb
    return [getattr(cb, n) for n in TRAIN_KERNELS + ("conv_affine",)]


def phase_image_train(state):
    """ResNet-50 v1 training through the example's entry point at its
    defaults, with the launch counters read around it."""
    import math
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    torch.cuda.reset_peak_memory_stats()
    from mxnet_tpu_torch.ops import conv_block as cb
    counted = _train_counters()
    for fn in counted:
        fn.launches = 0
    cb._FusedBlock.dout_copies = 0
    argv = ["--iters", str(TRAIN_ITERS), "--seed", str(SEED)]
    out = ic.main(argv)
    launches = {fn.__name__: fn.launches for fn in counted}
    copies = cb._FusedBlock.dout_copies
    state["train_launches"] = launches
    steps = out["steps"]
    want = dict({n: RESNET50_SEGMENTS * steps for n in TRAIN_KERNELS},
                conv_affine=0)
    timed = sorted(out["step_ms"][ic.WARMUP:])
    med = timed[len(timed) // 2]
    args = ic.parse_args(argv)
    res = {"args": vars(args), "losses": out["losses"],
           "step_ms": out["step_ms"], "step_ms_median": med,
           "images_s": out["img_s"],
           "images_s_from_median_step": args.batch_size / med * 1e3,
           "launches": launches, "launches_expected": want,
           "dout_copies_per_step": copies / steps,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    state["train_step_ms"] = med
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite loss: {res}")
    if launches != want:
        raise AssertionError(f"launch counts differ from the path's: {res}")
    return res


def _train_side(args, dev, x, y, dtype="float32", damp=0.1):
    """One step on ``dev`` from the example's seeded weights, with each
    bottleneck's last BatchNorm γ scaled by ``damp`` (0.1: the
    damped-residual init; see ``phase_image_train_reference``): (loss,
    {name: gradient},
    {name: value after the step}, {name: value before}) on the CPU in
    float64.  The weights take their shapes in an inference forward
    first, which leaves the running statistics as they are."""
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    device = torch.device(dev)
    net, trainer, loss_fn = ic.build(args, device)
    net.eval()
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 3, device=device))
        for k, t in net.collect_params().items():
            if k.endswith(".body.7.gamma"):
                t.mul_(damp)
    net.to(getattr(torch, dtype)).train()
    before = {k: t.detach().double().cpu().clone()
              for k, t in net.collect_params().items()}
    xt = torch.as_tensor(x, device=device).to(getattr(torch, dtype))
    loss = ic.forward_backward(net, loss_fn, xt,
                               torch.as_tensor(y, device=device))
    params = net.collect_params()
    grads = {k: t.grad.detach().double().cpu() for k, t in params.items()
             if isinstance(t, torch.nn.Parameter) and t.grad is not None}
    trainer.step(args.batch_size)
    after = {k: t.detach().double().cpu() for k, t in params.items()}
    return loss.double().cpu(), grads, after, before


def _step_diff(a, b):
    """How far apart two sides' steps are: the loss (relative), the
    gradients (of the largest gradient in the net), the parameters after
    the step (of the largest update in the net) and the running
    statistics (each of its largest magnitude)."""
    (la, ga, aa, _), (lb, gb, ab, b0) = a, b
    gmax = max(g.abs().max().item() for g in gb.values())
    params = [k for k in ab if "running_" not in k]
    umax = max((ab[k] - b0[k]).abs().max().item() for k in params)
    grad = {k: (ga[k] - gb[k]).abs().max().item() / gmax for k in gb}
    upd = {k: (aa[k] - ab[k]).abs().max().item() / umax for k in params}
    stats = {k: _rel(aa[k], ab[k]) for k in ab if "running_" in k}
    return {"loss_rel": ((la - lb).abs().max() / lb.abs().max()).item(),
            "grad_rel_to_net_max": max(grad.values()),
            "grad_worst": max(grad, key=grad.get),
            "params_after_step_rel_to_max_update": max(upd.values()),
            "params_worst": max(upd, key=upd.get),
            "running_stats_rel_to_max": max(stats.values()),
            "largest_gradient": gmax, "largest_update": umax,
            "gradients": len(gb), "same_gradients": sorted(ga) == sorted(gb)}


def phase_image_train_reference(state):
    """One ResNet-50 training step at batch 2 on the card and through the
    port on the CPU, from the same seeded weights and batch; the CPU
    step in float64 too, as the floor any fp32 run sits on.

    The weights are the example's, with each bottleneck's last BN γ
    scaled by 0.1 (the damped-residual init of large-batch ResNet
    training).  With γ = 1 at batch 2 the step is badly conditioned: the
    port's own fp32 and fp64 CPU steps differ by a few percent of the
    largest gradient (``cpu_fp32_vs_fp64_gamma1``, printed, not gated),
    so no fp32 pair could be held tighter.  The
    gradients and the updates are read against the net's largest
    gradient and largest update, since a gradient that is small by the
    BatchNorm's cancellation carries rounding of the net's scale."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    torch.set_num_threads(os.cpu_count() or 1)
    args = ic.parse_args(["--batch-size", "2", "--seed", str(SEED)])
    x, y = ic.synthetic_batch(np.random.RandomState(SEED + 4), 2,
                              args.image_size, args.classes)
    card = _train_side(args, "cuda", x, y)
    cpu = _train_side(args, "cpu", x, y)
    cpu64 = _train_side(args, "cpu", x, y, "float64")
    diff = _step_diff(card, cpu)
    # the same floor from the example's own weights (γ = 1), not gated
    floor_gamma1 = _step_diff(_train_side(args, "cpu", x, y, damp=1.0),
                              _train_side(args, "cpu", x, y, "float64",
                                          damp=1.0))
    res = {"batch": [2, args.image_size, args.image_size, 3],
           "loss_card": card[0].tolist(), "loss_cpu": cpu[0].tolist(),
           "card_vs_cpu": diff,
           "cpu_fp32_vs_fp64": _step_diff(cpu, cpu64),
           "cpu_fp32_vs_fp64_gamma1": floor_gamma1,
           "tol": {"loss_rel": TRAIN_LOSS_RTOL,
                   "grad_rel_to_net_max": TRAIN_REF_TOL,
                   "params_after_step_rel_to_max_update": TRAIN_REF_TOL,
                   "running_stats_rel_to_max": TRAIN_STATS_TOL}}
    if not (diff["same_gradients"] and all(
            diff[k] <= t for k, t in res["tol"].items())):
        raise AssertionError(f"card disagrees with the CPU: {res}")
    return res


def phase_image_train_profile(state):
    """Where one ResNet-50 training step's time goes, under torch.profiler
    (its own cost inflates the wall time; ``image_train``'s step time is
    the uninstrumented one)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import image_classification as ic
    args = ic.parse_args(["--seed", str(SEED)])
    device = torch.device("cuda")
    net, trainer, loss_fn = ic.build(args, device)
    x, y = ic.synthetic_batch(np.random.RandomState(SEED), args.batch_size,
                              args.image_size, args.classes)
    x, y = torch.as_tensor(x, device=device), torch.as_tensor(y,
                                                             device=device)

    def step():
        ic.forward_backward(net, loss_fn, x, y)
        trainer.step(args.batch_size)

    from mxnet_tpu_torch.gluon import nn as gnn
    shapes = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: shapes.append(tuple(i[0].shape)))
        for m in net.modules() if isinstance(m, gnn.BatchNorm)]
    step()
    for h in hooks:
        h.remove()
    res = _profile(step, 1, top=12)
    busy = res.get("device_busy_us_per_call")
    if busy is not None:
        res["idle_share_vs_uninstrumented_step"] = \
            1.0 - busy / (state["train_step_ms"] * 1e3)
    res["unfused_batch_norm"] = _bn_cost(shapes)
    return res


def _bn_cost(shapes):
    """The step's unfused BatchNorms (the layers the fused segments leave
    to ``ops.nn.batch_norm``), forward and backward in training mode on
    inputs of the shapes the step gave them: their device ms a step and
    kernels a step, so the profile's elementwise and reduction time can
    be split between them and the rest."""
    import torch
    from mxnet_tpu_torch.ops import nn as tnn
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    args = []
    for sh in shapes:
        x = torch.randn(sh, device="cuda", generator=gen).requires_grad_()
        c = sh[-1]
        g, b = (torch.ones(c, device="cuda").requires_grad_(),
                torch.zeros(c, device="cuda").requires_grad_())
        args.append((x, g, b, torch.zeros(c, device="cuda"),
                     torch.ones(c, device="cuda"),
                     torch.randn(sh, device="cuda", generator=gen)))

    def run():
        for x, g, b, rm, rv, gy in args:
            out, _, _ = tnn.batch_norm(x, g, b, rm, rv, training=True)
            torch.autograd.grad(out, (x, g, b), gy)

    prof = _profile(run, 1)
    return {"layers": len(shapes),
            "device_ms_per_step": cuda_ms(run, iters=2, repeats=3),
            "kernels_per_step": prof.get("kernels_per_call"),
            "by_category": prof.get("by_category")}


# ------------------------------------------------------------ text phases
SOFTMAX_TOL = 1e-6          # absolute: every softmax value lies in [0, 1]
TEXT_REF_TOL = 1e-4         # logits: of the largest logit
TEXT_ARGMAX_AGREE = 0.999   # share of positions whose argmax agrees
TEXT_T = 512                # tokens an item
BERT_SOFTMAXES = 12         # attention softmaxes a BERT-base forward
BERT_LAYERNORMS = 25        # LayerNorms a BERT-base forward


def _softmax_case(rows, cols, gen, masked=False, strided=False):
    """``softmax_fused`` against ``softmax_plain`` at one shape, timed
    beside its bound, its plain version and ``torch.softmax`` (the one
    PyTorch call computing the same function).  ``masked`` puts the
    model's finite mask value -1e9 in every third column and across the
    whole first row (which must come out 1/cols); ``strided`` passes a
    non-contiguous view, which the wrapper copies first."""
    import torch
    from mxnet_tpu_torch.ops.cuda_kernels import softmax_fused, softmax_plain
    if strided:
        x = (torch.randn(rows, cols + 64, device="cuda", generator=gen)
             * 4)[:, :cols]
    else:
        x = torch.randn(rows, cols, device="cuda", generator=gen) * 4
    if masked:
        x[:, ::3] = -1e9
        x[0] = -1e9
    out = softmax_fused(x)
    ref = softmax_plain(x)
    torch.cuda.synchronize()
    case = {"shape": [rows, cols], "masked": masked, "strided": strided,
            "max_abs_err": (out - ref).abs().max().item(), "tol": SOFTMAX_TOL,
            "finite": bool(torch.isfinite(out).all()),
            "row_sum_err": (out.sum(-1) - 1).abs().max().item()}
    if masked:
        case["masked_row_err"] = (out[0] - 1.0 / cols).abs().max().item()
    _timed(case, lambda: softmax_fused(x), lambda: softmax_plain(x),
           lambda: torch.softmax(x, -1), 2 * rows * cols * 4,
           5 * rows * cols)
    case["gb_s"] = case["bytes"] / (case["kernel_ms"] * 1e-3) / 1e9
    return case


SOFTMAX_BF16_STEPS = 1  # bf16 steps between card and CPU, value by value


def _softmax_bf16_case(shape, axis, gen):
    """``ops.nn.softmax`` on a bf16 tensor on the card (the reference's
    closed form; the fp32 kernel must not launch) against the port on the
    CPU on the same values.  Softmax values are never negative, so the
    distance of two bf16 values in steps of their own size is the
    difference of their bit patterns."""
    import torch
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.cuda_kernels import softmax_fused
    x = (torch.randn(*shape, device="cuda", generator=gen) * 4).bfloat16()
    before = softmax_fused.launches
    out = tnn.softmax(x, axis=axis)
    torch.cuda.synchronize()
    launched = softmax_fused.launches - before
    ref = tnn.softmax(x.cpu(), axis=axis)
    got = out.cpu()
    steps = (got.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    return {"shape": list(shape), "axis": axis, "dtype": str(out.dtype),
            "max_abs_err": (got.float() - ref.float()).abs().max().item(),
            "max_bf16_steps": steps.max().item(),
            "tol_bf16_steps": SOFTMAX_BF16_STEPS,
            "all_nonnegative": bool((got >= 0).all() and (ref >= 0).all()),
            "values_differing": int((steps > 0).sum()),
            "values": steps.numel(),
            "finite": bool(torch.isfinite(out).all()),
            "kernel_launches": launched}


def phase_text_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    heads = 12
    # the path's shape at buckets 8 and 1 first, then ragged widths, the
    # long-row kernel (vocabulary rows, scalar and 16-byte), masked rows
    # on both kernels and a strided view
    cases = [_softmax_case(8 * heads * TEXT_T, TEXT_T, gen),
             _softmax_case(heads * TEXT_T, TEXT_T, gen),
             _softmax_case(4096, 77, gen),
             _softmax_case(4096, 1000, gen),
             _softmax_case(4096, 30522, gen),
             _softmax_case(1024, 4096, gen),
             _softmax_case(heads * TEXT_T, TEXT_T, gen, masked=True),
             _softmax_case(1024, 4099, gen, masked=True),
             _softmax_case(2048, 512, gen, strided=True)]
    state["cases"]["softmax_fused"] = cases
    bad = [c for c in cases
           if not (c["max_abs_err"] <= c["tol"] and c["finite"] and
                   c.get("masked_row_err", 0.0) <= c["tol"])]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    half = [_softmax_bf16_case(shape, axis, gen)
            for shape in ((4, 768), (2, 3, 512), (8, 30522))
            for axis in (-1, 0)]
    bad = [c for c in half
           if not (c["max_bf16_steps"] <= c["tol_bf16_steps"] and
                   c["all_nonnegative"] and c["finite"] and
                   c["dtype"] == "torch.bfloat16" and
                   c["kernel_launches"] == 0)]
    if bad:
        raise AssertionError(f"bf16 softmax on the card disagrees with the "
                             f"CPU: {bad}")
    return {"cases": cases, "bf16_vs_cpu": half}


def _bert_base_params(path):
    """BERT-base (``bert_12_768_12``) with weights from
    ``numpy.random.RandomState(SEED)``: embeddings N(0, 1), dense weights
    N(0, 1/fan_in) (attention scores of unit scale, so the softmax is far
    from uniform), LayerNorm γ near 1, small β and biases; saved to
    ``path`` as a ``.params``.  Returns the parameter count."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import bert_gluon
    net = bert_gluon.bert_12_768_12()
    net.initialize(seed=SEED, ctx="cpu")
    net(torch.zeros(1, 8, dtype=torch.int32))   # deferred shapes resolve
    rs = np.random.RandomState(SEED)
    with torch.no_grad():
        for name, t in net.collect_params().items():
            leaf = name.rsplit(".", 1)[-1]
            shape = tuple(t.shape)
            if "embed" in name:
                a = rs.randn(*shape)
            elif leaf == "weight":
                a = rs.randn(*shape) / np.sqrt(shape[1])
            elif leaf == "gamma":
                a = 1 + 0.1 * rs.randn(*shape)
            else:                               # beta, bias
                a = 0.1 * rs.randn(*shape)
            t.copy_(torch.from_numpy(a.astype(np.float32)))
    net.save_parameters(path)
    return sum(t.numel() for t in net.collect_params().values())


def _digest(out):
    """What ``text_serve`` keeps of one (1, T, vocab) response: its sum
    (float64; finite iff every logit is) and the argmax at each
    position.  The response itself, 62.5 MB, is dropped."""
    import numpy as np
    return float(out.sum(dtype=np.float64)), out[0].argmax(-1)


def _to_host_ms(out, repeats=5):
    """Host-clock ms of the batcher's copy of one bucket's logits to the
    host (``.cpu().numpy()`` of a finished forward), median of
    ``repeats``."""
    import torch
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out.cpu().numpy()
        runs.append((time.perf_counter() - t0) * 1e3)
    return sorted(runs)[len(runs) // 2]


def phase_text_serve(state):
    """Gluon BERT-base on 512-token int32 items through
    ``ModelRegistry.load(..., net=bert_12_768_12(), dtype="int32")`` (the
    default ladder 1, 2, 4, 8) and its ``Batcher``: a closed loop of one
    client, then 8 client threads.  The launch counters are set to 0
    before the load and read after the traffic: 12 softmax and 25
    LayerNorm launches per forward run."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.models import bert_gluon
    from mxnet_tpu_torch.ops.cuda_kernels import layernorm_fused, softmax_fused
    from mxnet_tpu_torch.serve import ModelRegistry

    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "bert_12_768_12.params")
    t0 = time.perf_counter()
    n_params = _bert_base_params(path)
    init_s = time.perf_counter() - t0
    rs = np.random.RandomState(SEED)
    seqs = rs.randint(0, 30522, (96, TEXT_T)).astype(np.int32)
    state.update(text_params=path, text_seqs=seqs)

    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()      # earlier phases' state
    softmax_fused.launches = 0
    layernorm_fused.launches = 0
    telemetry.reset()
    reg = ModelRegistry()
    t0 = time.perf_counter()
    entry = reg.load("bert", path, net=bert_gluon.bert_12_768_12(),
                     item_shape=(TEXT_T,), dtype="int32")
    load_s = time.perf_counter() - t0
    eng = entry.engine
    state.update(text_registry=reg, text_engine=eng)

    def spans(h0, h1):
        """Mean µs per request of the batcher's queue wait and end to end,
        and per batch of its forward + copy to the host, between two
        histogram snapshots."""
        return {n: _mean_us(h0, h1, f"serve.{n}")
                for n in ("queue_wait_us", "device_us", "e2e_us")}

    hc0 = telemetry.raw_snapshot()["histograms"]
    digests, lat = {}, []
    for k in range(32):
        t1 = time.perf_counter()
        out = reg.predict("bert", seqs[k])[0]
        lat.append((time.perf_counter() - t1) * 1e3)
        if out.shape != (1, TEXT_T, 30522):
            raise AssertionError(f"response shape {out.shape}")
        digests[k] = _digest(out)
        del out

    errs = []

    def client(c):
        try:
            for j in range(8):
                k = 32 + 8 * c + j
                out = reg.predict("bert", seqs[k], timeout=300)[0]
                if out.shape != (1, TEXT_T, 30522):
                    raise AssertionError(f"response shape {out.shape}")
                digests[k] = _digest(out)
                del out
        except Exception as e:
            errs.append(repr(e))

    hc1 = telemetry.raw_snapshot()["histograms"]
    h0 = hc1.get("serve.batch_fill", {})
    b0 = telemetry.raw_snapshot()["counters"].get("serve.batches", 0)
    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    t1 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    conc_s = time.perf_counter() - t1
    snap = telemetry.raw_snapshot()
    launches = {"softmax_fused": softmax_fused.launches,
                "layernorm_fused": layernorm_fused.launches}
    forwards = eng.forwards      # warmups, the batcher's, traffic
    h1 = snap["histograms"].get("serve.batch_fill", {})
    batches = snap["counters"].get("serve.batches", 0)
    state["text_launches"] = launches
    state["text_digests"] = digests
    if errs or len(digests) != 96:
        raise AssertionError(f"requests failed: {errs}")
    bad = [k for k, (s, _) in digests.items() if not np.isfinite(s)]
    if bad:
        raise AssertionError(f"responses {bad} not finite")
    if (launches["softmax_fused"] != BERT_SOFTMAXES * forwards or
            launches["layernorm_fused"] != BERT_LAYERNORMS * forwards):
        raise AssertionError(f"launches {launches} in {forwards} forwards")

    per_bucket = {}
    for b in eng.buckets:
        x = torch.as_tensor(seqs[:b], device="cuda")
        per_bucket[b] = {
            # two forwards per CUDA-event window: the host queues both
            # inside the device-side sleep, so the window is device time
            "device_ms": cuda_ms(lambda: eng.run(x), iters=2, repeats=5),
            "eager_ms": eager_ms(lambda: eng.run(x), iters=5),
            "to_host_ms": _to_host_ms(eng.run(x)[0])}
    return {"model": "bert_12_768_12", "params": n_params,
            "vocab": 30522, "item_shape": [TEXT_T], "dtype": "int32",
            "buckets": list(eng.buckets), "init_s": init_s,
            "load_and_warmup_s": load_s,
            "closed_loop": {"requests": 32, "p50_ms": _pct(lat, 50),
                            "p99_ms": _pct(lat, 99), "mean_ms":
                            sum(lat) / len(lat), "first_ms": lat[0],
                            "max_ms": max(lat),
                            "sequences_s": 1e3 * len(lat) / sum(lat),
                            "batcher_us": spans(hc0, hc1)},
            "concurrent": {"clients": 8, "requests": 64, "seconds": conc_s,
                           "sequences_s": 64 / conc_s,
                           "tokens_s": 64 * TEXT_T / conc_s,
                           "batches": batches - b0,
                           "mean_batch_fill":
                           (h1.get("sum", 0) - h0.get("sum", 0)) /
                           max(1, h1.get("count", 0) - h0.get("count", 0)),
                           "batcher_us": spans(hc1, snap["histograms"])},
            "per_bucket": per_bucket,
            "launches": {**launches, "forwards": forwards,
                         "softmax_per_forward":
                         launches["softmax_fused"] / forwards,
                         "layernorm_per_forward":
                         launches["layernorm_fused"] / forwards},
            "engine": {k: v for k, v in eng.stats().items()
                       if k in ("retraces", "programs", "precision",
                                "dtype", "param_bytes_per_device")},
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "mem_before_bytes": mem_before}


def phase_text_reference(state):
    """Card logits against the port on the CPU from the same ``.params``
    at batch 1 x 512 (within 1e-4 of the largest logit, argmax equal at
    >= 99.9% of positions).  Then batched against unbatched: the 64
    concurrent requests are served again through the ``Batcher`` by 8
    clients, and each response is held, element by element, against the
    forward of its sequence alone on the card (same tolerance); and the
    digest ``text_serve`` kept of each of its 96 responses is held
    against that forward (argmax agreement, and the sum within what the
    tolerance allows)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import bert_gluon
    from mxnet_tpu_torch.serve import InferenceEngine
    torch.set_num_threads(os.cpu_count() or 1)
    eng, reg, seqs = (state["text_engine"], state["text_registry"],
                      state["text_seqs"])
    x1 = seqs[:1]
    card = eng.run(x1)[0].cpu().numpy()
    net = bert_gluon.bert_12_768_12()
    net.load_parameters(state["text_params"])
    cpu = InferenceEngine(net, (TEXT_T,), dtype="int32", buckets=(1,),
                          device="cpu").run(x1)[0].numpy()
    del net
    ref_err = float(np.abs(card - cpu).max())
    ref_scale = float(np.abs(cpu).max())
    ref_agree = float((card.argmax(-1) == cpu.argmax(-1)).mean())
    del card, cpu

    def alone(k):
        return eng.run(seqs[k:k + 1])[0][0]        # on the card

    rows, errs = [], []

    def client(c):
        try:
            for j in range(8):
                k = 32 + 8 * c + j
                one = alone(k)
                out = torch.from_numpy(reg.predict("bert", seqs[k],
                                                   timeout=300)[0][0])
                rows.append(((out.cuda() - one).abs().max().item(),
                             one.abs().max().item()))
                del out, one
        except Exception as e:
            errs.append(repr(e))

    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    reg.close()
    if errs or len(rows) != 64:
        raise AssertionError(f"requests failed: {errs}")
    bat_err = max(e / s for e, s in rows)

    dig_agree, dig_sum = 1.0, 0.0
    for k, (s, am) in state["text_digests"].items():
        one = alone(k)
        dig_agree = min(dig_agree,
                        float((one.argmax(-1).cpu().numpy() == am).mean()))
        dig_sum = max(dig_sum, abs(s - one.double().sum().item()) /
                      (one.abs().max().item() * one.numel()))
    res = {"batch": 1, "logits_max_abs_diff": ref_err,
           "logits_max_abs": ref_scale, "tol": TEXT_REF_TOL,
           "argmax_agree": ref_agree, "argmax_agree_min": TEXT_ARGMAX_AGREE,
           "batched_vs_unbatched_max_rel_diff": bat_err,
           "batched_responses": len(rows),
           "served_digests": len(state["text_digests"]),
           "served_argmax_agree_min": dig_agree,
           "served_sum_diff_per_logit_rel": dig_sum}
    if not (ref_err <= TEXT_REF_TOL * ref_scale and
            ref_agree >= TEXT_ARGMAX_AGREE and bat_err <= TEXT_REF_TOL and
            dig_agree >= TEXT_ARGMAX_AGREE and dig_sum <= TEXT_REF_TOL):
        raise AssertionError(f"card disagrees: {res}")
    return res


def phase_text_profile(state):
    """Where a Gluon BERT-base forward's time goes: one bucket-8 and one
    bucket-1 forward under torch.profiler."""
    import torch
    eng, seqs = state["text_engine"], state["text_seqs"]
    res = {}
    for b in (8, 1):
        x = torch.as_tensor(seqs[:b], device="cuda")
        eng.run(x)
        res[f"forward_b{b}"] = _profile(lambda: eng.run(x), 1, top=8)
    return res


# ------------------------------------------------------------ int8 phases
QCONV_TOL = 1e-6            # of the output's largest magnitude
INT8_REF_TOL = 1e-3         # logits, card vs CPU: of the largest logit
INT8_BATCH = 64             # int8_score.py's defaults
INT8_WARMUP = 4
INT8_ITERS = 20
INT8_AGREE_N = 256
INT8_SERVE_ITERS = 20

INT8_CATEGORIES = (
    ("qconv3x3_affine (ours)", r"qconv_(affine|reduce)_kernel"),
    ("conv_affine (ours)", r"conv_affine_(tc|reduce)_kernel"),
    ("int8 gemm (_int_mm)", r"i8i8|s8|imma|int8|igemm|i8"),
    ("quantize: round / clamp", r"round|clamp"),
    ("im2col, pad, slice copies", r"CatArrayBatchedCopy|pad|copy"),
    ("pooling", r"pool|reduce_kernel"),
    ("elementwise (epilogues, casts)", r"elementwise|vectorized"),
)


def _qconv_case(N, H, W, C, Cout, gen, residual=False, relu=True,
                exact=False, split=False):
    """``qconv3x3_affine`` against ``qconv3x3_plain`` at one shape on
    random int8 data, twice on the same inputs (the two outputs must be
    bitwise equal), with its plan, timed beside its bound, its plain
    version,
    ``torch._int_mm`` on the pre-built (N*H*W, 9C) patch matrix (no
    im2col, no epilogue) and the fp32 ``conv_affine`` at the same shape.
    ``exact``: scale 1, shift 0, no ReLU or residual, so the output is
    the int32 sum itself.  ``split``: also the device µs of each kernel
    it launches (the main kernel and the cut-tile reduce)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import conv_block as cb
    from mxnet_tpu_torch.ops import cuda_int8 as ci
    from mxnet_tpu_torch.ops.conv_block import conv_affine
    dev = "cuda"
    qx = torch.randint(-127, 128, (N, H, W, C), device=dev, generator=gen,
                       dtype=torch.int8)
    qw = torch.randint(-127, 128, (3, 3, C, Cout), device=dev,
                       generator=gen, dtype=torch.int8)
    wt = ci.pack_weight(qw)
    if exact:
        scale = torch.ones(Cout, device=dev)
        shift = torch.zeros(Cout, device=dev)
    else:
        scale = torch.rand(Cout, device=dev, generator=gen) * 1e-3 + 1e-4
        shift = 0.1 * torch.randn(Cout, device=dev, generator=gen)
    res = torch.randn(N, H, W, Cout, device=dev, generator=gen) \
        if residual else None
    args = (qx, qw, scale, shift, res, relu)
    out = ci.qconv3x3_affine(*args, qw_packed=wt)
    again = ci.qconv3x3_affine(*args, qw_packed=wt)
    ref = ci.qconv3x3_plain(*args, qw_packed=wt)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    scale_ref = ref.abs().max().item()
    vec = int(C % 16 == 0 and Cout % 4 == 0)
    sms = cb._sm_count(0)
    plan = ci.qconv_splits(
        N * H * W, 9 * C, Cout, sms,
        cb._per_sm("mxt_qconv_affine_blocks_per_sm", 0,
                   ci.qconv_tile_cols(N * H * W, Cout, sms), vec))
    case = {"shape": [N, H, W, C, Cout], "residual": residual,
            "relu": relu, "exact": exact, "plan": _plan_dict(plan),
            "vec": bool(vec), "max_abs_err": err,
            "rel_err": err / max(scale_ref, 1e-30), "tol": QCONV_TOL,
            "bitwise_equal": bool(torch.equal(out, ref)),
            "bitwise_equal_relaunch": bool(torch.equal(out, again))}
    K = 9 * C
    patches = ci.im2col(qx, (3, 3), pad=(1, 1)).reshape(-1, K)
    if exact:
        acc = ci.int8_matmul(patches, wt).reshape(N, H, W, Cout)
        case["acc_max_abs"] = acc.abs().max().item()
        case["equals_int32_sum"] = bool(
            case["acc_max_abs"] < 2 ** 24 and
            torch.equal(out.to(torch.int64), acc.to(torch.int64)))
    Kp = -(-K // 8) * 8
    pa = F.pad(patches, (0, Kp - K)).contiguous()
    wb = F.pad(wt, (0, Kp - K)).contiguous().t()
    x32 = qx.float()
    w32 = qw.float()
    ones, zeros = torch.ones(Cout, device=dev), torch.zeros(Cout, device=dev)
    npix = N * H * W
    nbytes = npix * C + 9 * C * Cout + 8 * Cout + 4 * npix * Cout * (
        2 if residual else 1)
    ops = 2 * npix * 9 * C * Cout
    bms, by = bound(nbytes, ops, peak=PEAK_INT8_OPS_S)
    staged = plan.tiles * plan.chunks * (ci.QCONV_ROWS + plan.bn) * \
        ci.QCONV_CHUNK
    it = 10 if N >= 64 else 20
    kms = cuda_ms(lambda: ci.qconv3x3_affine(*args, qw_packed=wt), iters=it)
    case.update(
        kernel_ms=kms,
        kernel_eager_ms=eager_ms(
            lambda: ci.qconv3x3_affine(*args, qw_packed=wt), iters=it),
        plain_ms=cuda_ms(lambda: ci.qconv3x3_plain(*args, qw_packed=wt),
                         iters=it),
        library_ms=cuda_ms(lambda: torch._int_mm(pa, wb), iters=it),
        library="torch._int_mm on the pre-built (N*H*W, 9C) patch matrix "
                "(cuBLASLt; no im2col, no epilogue)",
        fp32_conv_affine_ms=cuda_ms(
            lambda: conv_affine(x32, w32, ones, zeros, zeros, ones,
                                res, relu=relu), iters=it),
        bytes=nbytes, ops=ops, bound_ms=bms, bound_by=by,
        bound_share=bms / kms, tops=ops / (kms * 1e-3) / 1e12,
        # the operand bytes the blocks copy into shared memory (every
        # chunk's 128 pixel rows and bn weight rows of 64 bytes, zero
        # fill included) and their rate
        staged_bytes=staged, staged_tb_s=staged / (kms * 1e-3) / 1e12)
    if split:
        case["kernels_us"] = _kernel_us(
            lambda: ci.qconv3x3_affine(*args, qw_packed=wt))
    return case


def _qconv_ok(c):
    if not c["bitwise_equal_relaunch"]:
        return False
    if c["exact"]:
        return c["bitwise_equal"] and c["equals_int32_sum"]
    return c["bitwise_equal"] or c["rel_err"] <= c["tol"]


MMA_S8_PEAK_SRC = r"""
extern "C" __global__ void mma_s8_peak(int* out, int iters) {
  const unsigned v = 0x01010101u * (threadIdx.x & 0x3f);
  const unsigned a0 = v, a1 = v ^ 0x02020202u, a2 = v ^ 0x04040404u,
                 a3 = v ^ 0x08080808u;
  int acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]),
            "+r"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(a1), "r"(a3));
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
"""


def _mma_s8_ceiling():
    """What ``mma.sync.m16n8k32`` int8 sustains on this card: every warp
    issues independent products on registers (8 accumulators, no memory
    in the loop), 8 warps a block, 2 blocks an SM; compiled by NVRTC
    through ``rtc.CudaModule``.  The ceiling of any ``mma.sync`` int8
    kernel, beside the 1,979 TOPS dense peak that ``wgmma`` can reach."""
    import torch
    from mxnet_tpu_torch import rtc
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    kern = rtc.CudaModule(MMA_S8_PEAK_SRC).get_kernel("mma_s8_peak")
    run = lambda: kern.launch([iters], grid=(blocks,), block=(256,),  # noqa
                              out_shape=(blocks * 256,))
    ms = cuda_ms(run, iters=3)
    ops = blocks * 8 * iters * 8 * 2 * 16 * 8 * 32
    return {"blocks": blocks, "ms": ms, "ops": ops,
            "tops": ops / (ms * 1e-3) / 1e12,
            "share_of_dense_peak": ops / (ms * 1e-3) / PEAK_INT8_OPS_S}


def phase_int8_kernels(state):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    # int8_score's batch-64 stages first (the path's shape), the same at
    # batch 8 (serving), the batch-1 tail, ResNet-18's residual tail,
    # ReLU off, a ragged shape and the exact case
    stages = ((56, 64), (28, 128), (14, 256), (7, 512))
    cases = [_qconv_case(64, h, h, c, c, gen, split=True) for h, c in stages]
    cases += [_qconv_case(8, h, h, c, c, gen, split=True) for h, c in stages]
    cases += [_qconv_case(1, 7, 7, 512, 512, gen, split=True),
              _qconv_case(8, 56, 56, 64, 64, gen, residual=True),
              _qconv_case(8, 28, 28, 128, 128, gen, relu=False),
              _qconv_case(2, 13, 17, 20, 40, gen, residual=True),
              _qconv_case(8, 56, 56, 64, 64, gen, relu=False, exact=True)]
    state["cases"]["qconv3x3_affine"] = cases
    bad = [c for c in cases if not _qconv_ok(c)]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    ceiling = _mma_s8_ceiling()
    for c in cases:
        c["mma_sync_ceiling_share"] = \
            c["ops"] / (c["kernel_ms"] * 1e-3) / 1e12 / ceiling["tops"]
    return {"cases": cases, "mma_s8_ceiling": ceiling,
            "parts": _qconv_parts([(64, h, c) for h, c in stages])}


def _qconv_parts(shapes):
    """Where the int8 kernel's loop spends its time: the kernel as built,
    and with one part taken out (``no_copies``: the ring is never
    filled; ``no_products``: each ``mma.sync`` a register add), each
    built by nvcc from a copy of ``csrc/qconv_affine.cu`` into
    ``build/chip_smoke/qconv_parts`` and timed (device ms) at ``shapes``
    (batch, H = W, C = Cout) on the plan the wrapper runs.  The outputs
    of the cut kernels are garbage; only their times are kept."""
    import ctypes
    import torch
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.ops import conv_block as cb
    from mxnet_tpu_torch.ops import cuda_int8 as ci
    src = open(os.path.join(HERE, "mxnet_tpu_torch", "csrc",
                            "qconv_affine.cu")).read()
    mma = src.index('asm("mma.sync')
    end = src.index('"r"(b[0]), "r"(b[1]));', mma) + len(
        '"r"(b[0]), "r"(b[1]));')
    variants = {
        "kernel": src,
        "no_copies": src.replace("if (pre < nk) ld.load(s, pre % STAGES);",
                                 ";").replace("if (st < nk) ld.load(s, st);",
                                              ";"),
        "no_products": src[:mma] + "c[0] += (int)(a[0] + b[0]);" +
        src[end:]}
    work = os.path.join(HERE, "build", "chip_smoke", "qconv_parts")
    os.makedirs(work, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        if name != "kernel" and text == src:
            raise AssertionError(f"qconv_parts: {name} changed nothing")
        with open(os.path.join(work, name + ".cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS[:4], "-shared", "-Xcompiler",
             "-fPIC", "-o", os.path.join(work, name + ".so"),
             os.path.join(work, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"qconv_parts: nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(work, name + ".so"))
        lib.mxt_qconv_affine_s8.argtypes = \
            _build._SIGNATURES["mxt_qconv_affine_s8"]
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    out = []
    for N, H, C in shapes:
        qx = torch.randint(-127, 128, (N, H, H, C), device="cuda",
                           generator=gen, dtype=torch.int8)
        wt = torch.randint(-127, 128, (C, 9 * C), device="cuda",
                           generator=gen, dtype=torch.int8)
        sc, sh = torch.ones(C, device="cuda"), torch.zeros(C, device="cuda")
        y = torch.empty(N, H, H, C, device="cuda")
        sms = cb._sm_count(0)
        plan = ci.qconv_splits(
            N * H * H, 9 * C, C, sms,
            cb._per_sm("mxt_qconv_affine_blocks_per_sm", 0,
                       ci.qconv_tile_cols(N * H * H, C, sms), 1))
        part = torch.empty(2 * plan.ranges, ci.QCONV_ROWS, plan.bn,
                           device="cuda", dtype=torch.int32)
        row = {"shape": [N, H, H, C, C], "plan": plan._asdict()}
        for name, lib in libs.items():
            def run(lib=lib):
                _build.check(lib.mxt_qconv_affine_s8(
                    qx.data_ptr(), wt.data_ptr(), sc.data_ptr(),
                    sh.data_ptr(), None, part.data_ptr(), y.data_ptr(), N,
                    H, H, C, C, 1, plan.bn, plan.ranges, plan.grain, 1,
                    torch.cuda.current_stream().cuda_stream), name)
            row[name + "_ms"] = cuda_ms(run, iters=10)
        out.append(row)
    return out


def _int8_counters():
    from mxnet_tpu_torch.ops.conv_block import conv_affine
    from mxnet_tpu_torch.ops.cuda_int8 import qconv3x3_affine
    return qconv3x3_affine, conv_affine


def _load_resnet50(path, device):
    from mxnet_tpu_torch.models import get_model
    net = get_model("resnet50_v1", classes=1000)
    net.load_parameters(path)
    net.eval()
    return net.to(device)


def phase_int8_score(state):
    """``benchmark/int8_score.py`` at its defaults on the card: ResNet-50
    v1, 1000 classes, batch 64 of 224x224x3, fp32 and int8 (two
    ``RandomState(1)`` [0, 1) calibration batches, naive) scoring with
    4 warm-up and 20 timed forwards on fresh inputs, and the int8-vs-fp32
    argmax agreement over 256 ``RandomState(0)`` images.  The launch
    counters are set to 0 before the int8 forwards and read after: 16
    ``qconv3x3_affine`` and 0 ``conv_affine`` launches a forward."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import quantization as q
    path = state["image_params"]
    B, S = INT8_BATCH, 224
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    xs = [torch.rand(B, S, S, 3, device="cuda", generator=gen)
          for _ in range(INT8_WARMUP + INT8_ITERS)]

    def score(net):
        with torch.inference_mode():
            for x in xs[:INT8_WARMUP]:
                net(x)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for x in xs[INT8_WARMUP:]:
                net(x)
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end) / INT8_ITERS
        return {"ms_per_batch": ms, "images_s": B / (ms * 1e-3)}

    fp32_net = _load_resnet50(path, "cuda")
    fp32 = score(fp32_net)
    int8_net = _load_resnet50(path, "cuda")
    rs = np.random.RandomState(1)
    calib = [rs.rand(B, S, S, 3).astype(np.float32) for _ in range(2)]
    t0 = time.perf_counter()
    q.quantize_net(int8_net, calib_data=calib, calib_mode="naive")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    qk, ca = _int8_counters()
    qk.launches = ca.launches = 0
    int8 = score(int8_net)
    forwards = INT8_WARMUP + INT8_ITERS
    launches = {"qconv3x3_affine": qk.launches,
                "conv_affine": ca.launches, "forwards": forwards}
    state["int8_launches"] = {"qconv3x3_affine": qk.launches}

    rs = np.random.RandomState(0)
    agree = total = 0
    with torch.inference_mode():
        for _ in range(INT8_AGREE_N // B):
            x = torch.as_tensor(rs.rand(B, S, S, 3).astype(np.float32),
                                device="cuda")
            a = fp32_net(x).argmax(-1)
            b = int8_net(x)
            if not torch.isfinite(b).all():
                raise AssertionError("int8 logits not finite")
            agree += int((a == b.argmax(-1)).sum())
            total += B
    twins = sum(isinstance(b, q._Twin) for b in int8_net.modules())
    del fp32_net, int8_net, xs
    torch.cuda.empty_cache()
    res = {"model": "resnet50_v1", "classes": 1000, "batch": B,
           "image": S, "warmup": INT8_WARMUP, "iters": INT8_ITERS,
           "fp32": fp32, "int8": int8,
           "int8_vs_fp32": int8["images_s"] / fp32["images_s"],
           "int8_argmax_agreement_vs_fp32": agree / total,
           "agreement_images": total, "quantize_s": quant_s,
           "twins": twins, "launches": launches,
           "bf16": "not ported: the bf16 leg (amp.convert_model) is a "
                   "later item of the port's queue"}
    if launches["qconv3x3_affine"] != RESNET50_SEGMENTS * forwards or \
            launches["conv_affine"] != 0 or twins != 54:
        raise AssertionError(f"int8 forward launches: {res}")
    return res


def phase_int8_serve(state):
    """int8 ResNet-50 v1 through ``ModelRegistry.load(...,
    precision="int8")`` (default calibration, buckets 1, 2, 4, 8, warmup
    of every bucket) and its ``Batcher``: 32 closed-loop requests from
    one client, then 64 from 8 client threads; then int8_score.py's
    ``--serve`` leg, the int8 engine's QPS against the fp32 engine's at
    bucket 8 (fp32 standing in for bf16, which is not ported)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serve import InferenceEngine, ModelRegistry

    path, images = state["image_params"], state["images"]
    qk, ca = _int8_counters()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    qk.launches = ca.launches = 0
    telemetry.reset()
    reg = ModelRegistry(precision="int8")
    t0 = time.perf_counter()
    entry = reg.load("resnet50_int8", path, arch="resnet50_v1",
                     item_shape=(224, 224, 3))
    load_s = time.perf_counter() - t0
    state.update(int8_registry=reg, int8_engine=entry.engine)

    lat, outs = [], []
    for i in range(32):
        t1 = time.perf_counter()
        outs.append(reg.predict("resnet50_int8", images[i])[0])
        lat.append((time.perf_counter() - t1) * 1e3)
    got, errs = {}, []

    def client(c):
        try:
            for j in range(8):
                k = 8 * c + j
                got[k] = reg.predict("resnet50_int8", images[k],
                                     timeout=300)[0]
        except Exception as e:
            errs.append(repr(e))

    h0 = telemetry.raw_snapshot()["histograms"].get("serve.batch_fill", {})
    b0 = telemetry.raw_snapshot()["counters"].get("serve.batches", 0)
    ts = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    t1 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    conc_s = time.perf_counter() - t1
    snap = telemetry.raw_snapshot()
    eng = entry.engine
    forwards = eng.forwards
    launches = {"qconv3x3_affine": qk.launches, "conv_affine": ca.launches,
                "forwards": forwards}
    prev = state["int8_launches"]["qconv3x3_affine"]
    state["int8_launches"] = {"qconv3x3_affine": prev + qk.launches}
    state["int8_batched"] = got
    if errs or len(got) != 64:
        raise AssertionError(f"concurrent requests failed: {errs}")
    bad = [o for o in outs + list(got.values())
           if o.shape != (1, 1000) or not np.isfinite(o).all()]
    if bad:
        raise AssertionError(f"{len(bad)} responses not finite (1, 1000)")
    if launches["qconv3x3_affine"] != RESNET50_SEGMENTS * forwards or \
            launches["conv_affine"] != 0:
        raise AssertionError(f"int8 serving launches: {launches}")
    h1 = snap["histograms"].get("serve.batch_fill", {})
    batches = snap["counters"].get("serve.batches", 0)
    hist = snap["histograms"]

    per_bucket = {}
    for b in eng.buckets:
        x = torch.as_tensor(images[:b], device="cuda")
        per_bucket[b] = {
            # one forward per window behind a ~80 ms sleep: the host
            # takes ~15-20 ms to queue an int8 forward's ~600 launches
            "device_ms": cuda_ms(lambda: eng.run(x), iters=1, repeats=5,
                                 sleep=4 * SLEEP_CYCLES),
            "eager_ms": eager_ms(lambda: eng.run(x), iters=10)}
    peak = torch.cuda.max_memory_allocated()

    # int8_score.py --serve: one engine a precision at bucket 8, the
    # response fetched to the host after every run
    serve_leg = {"bucket": 8, "iters": INT8_SERVE_ITERS,
                 "bf16": "not ported; fp32 stands in for it"}
    xs = [images[8 * i:8 * i + 8] for i in range(4)]
    for prec in ("fp32", "int8"):
        net = _load_resnet50(path, "cpu")
        e = InferenceEngine(net, (224, 224, 3), buckets=(8,),
                            name=f"int8row-{prec}", precision=prec)
        e.warmup()
        t2 = time.perf_counter()
        for i in range(INT8_SERVE_ITERS):
            for o in e.run(xs[i % len(xs)]):
                o.cpu()
        dt = time.perf_counter() - t2
        serve_leg[f"{prec}_qps"] = 8 * INT8_SERVE_ITERS / dt
        del e, net
    serve_leg["int8_vs_fp32"] = serve_leg["int8_qps"] / \
        serve_leg["fp32_qps"]
    torch.cuda.empty_cache()
    return {"model": "resnet50_v1", "precision": "int8", "classes": 1000,
            "item_shape": [224, 224, 3], "buckets": list(eng.buckets),
            "load_quantize_and_warmup_s": load_s,
            "closed_loop": {"requests": 32, "p50_ms": _pct(lat, 50),
                            "p99_ms": _pct(lat, 99), "mean_ms":
                            sum(lat) / len(lat), "first_ms": lat[0],
                            "max_ms": max(lat)},
            "concurrent": {"clients": 8, "requests": 64, "seconds": conc_s,
                           "images_s": 64 / conc_s,
                           "batches": batches - b0,
                           "mean_batch_fill":
                           (h1.get("sum", 0) - h0.get("sum", 0)) /
                           max(1, h1.get("count", 0) - h0.get("count", 0))},
            "queue_wait_us_mean": _mean_us({}, hist, "serve.queue_wait_us"),
            "device_us_mean": _mean_us({}, hist, "serve.device_us"),
            "per_bucket": per_bucket, "launches": launches,
            "engine": {k: v for k, v in eng.stats().items()
                       if k in ("retraces", "programs", "precision",
                                "param_bytes_per_device")},
            "peak_mem_bytes": peak, "mem_before_bytes": mem_before,
            "serve_leg": serve_leg}


def phase_int8_reference(state):
    """The card's int8 engine against the port on the CPU from the same
    ``.params`` and the same int8 weights and thresholds (carried with
    ``quantization.state_from_numpy``) at batch 2; and each batched
    response against the unbatched forward of its image on the card."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import quantization as q
    from mxnet_tpu_torch.serve import InferenceEngine
    torch.set_num_threads(os.cpu_count() or 1)
    eng, images = state["int8_engine"], state["images"]
    card_state = {p: {"qw": b._qw.cpu().numpy(),
                      "w_scale": b._w_scale.cpu().numpy(),
                      "bias": None if b._bias is None
                      else b._bias.cpu().numpy(), "in_t": b._in_t}
                  for _, b, p in q._walk(eng.net)
                  if isinstance(b, q._Twin)}
    x2 = images[:2]
    card = eng.run(x2)[0].cpu().numpy()
    net = _load_resnet50(state["image_params"], "cpu")
    q.quantize_net(net, thresholds={p: s["in_t"]
                                    for p, s in card_state.items()})
    q.state_from_numpy(net, card_state)
    cpu = InferenceEngine(net, (224, 224, 3), buckets=(2,),
                          precision="int8", device="cpu").run(x2)[0].numpy()
    ref_err = float(np.abs(card - cpu).max())
    ref_scale = float(np.abs(cpu).max())
    top1 = bool((card.argmax(-1) == cpu.argmax(-1)).all())

    bat_err, bat_scale, bitwise = 0.0, 0.0, 0
    for k, out in state["int8_batched"].items():
        one = eng.run(images[k:k + 1])[0].cpu().numpy()
        bat_err = max(bat_err, float(np.abs(out - one).max()))
        bat_scale = max(bat_scale, float(np.abs(one).max()))
        bitwise += int(np.array_equal(out, one))
    state["int8_registry"].close()
    res = {"batch": 2, "logits_max_abs_diff": ref_err,
           "logits_max_abs": ref_scale, "tol": INT8_REF_TOL,
           "logits_bitwise_equal": bool(np.array_equal(card, cpu)),
           "top1_equal": top1,
           "batched_vs_unbatched_max_abs_diff": bat_err,
           "batched_max_abs": bat_scale,
           "batched_bitwise_equal": bitwise,
           "batched_responses": len(state["int8_batched"])}
    if not (ref_err <= INT8_REF_TOL * ref_scale and top1 and
            bat_err <= INT8_REF_TOL * bat_scale):
        raise AssertionError(f"card disagrees: {res}")
    return res


def phase_int8_profile(state):
    """Where an int8 ResNet-50 forward's time goes: one bucket-8 and one
    bucket-1 forward under torch.profiler."""
    import torch
    eng, images = state["int8_engine"], state["images"]
    res = {}
    for b in (8, 1):
        x = torch.as_tensor(images[:b], device="cuda")
        eng.run(x)
        res[f"forward_b{b}"] = _profile(lambda: eng.run(x), 1, top=8,
                                        categories=INT8_CATEGORIES)
    return res


# ------------------------------------------------------- extension phases
# the largest elementwise operand of a model the port runs: ResNet-50 v1
# batch-64 training's stage-1 block output, 205.5 MB in fp32 (4x the L2)
EXT_SHAPE = (64, 56, 56, 256)
EXT_RAGGED = 1_000_003          # ragged for the 16-byte path
SIGMOID_TOL = 1e-6              # absolute: sigmoid values lie in [0, 1]
STOCK_OPS = ("tvm_vadd", "tvm_vmul", "tvm_sigmoid")
# ops an element (for the bound; the bytes bound them all)
STOCK_FLOPS = {"tvm_vadd": 1, "tvm_vmul": 1, "tvm_sigmoid": 4}
EXT_CALLS = {"tvm_vadd": 2, "tvm_vmul": 2, "tvm_sigmoid": 1,
             "tvm_test_relu": 1, "rtc_axpy": 2}


def _ext_inputs(op, n, dtype, gen, offset=False):
    import torch
    out = []
    for _ in range(op.num_inputs):
        m = n + (1 if offset else 0)
        if dtype.is_floating_point:
            t = 3 * torch.randn(m, device="cuda", dtype=dtype, generator=gen)
        else:
            t = torch.randint(-2 ** 15, 2 ** 15, (m,), device="cuda",
                              dtype=dtype, generator=gen)
        out.append(t[1:] if offset else t)
    return out


def _ext_case(name, n, gen, dtype=None, offset=False, shape=None,
              timed=False):
    """A stock generated op's kernel against its plain version on the
    same inputs: ``tvm_vadd`` / ``tvm_vmul`` bit for bit, ``tvm_sigmoid``
    within 1e-6; timed beside its bound, its plain version and the one
    torch call computing the same function."""
    import torch
    from mxnet_tpu_torch import tvmop
    op = tvmop.get(name)
    dtype = dtype or torch.float32
    xs = _ext_inputs(op, n, dtype, gen, offset)
    if shape is not None:
        xs = [x.view(shape) for x in xs]
    out = op.forward(*xs)
    ref = op.plain(*xs)
    torch.cuda.synchronize()
    exact = name != "tvm_sigmoid"
    err = (out.double() - ref.double()).abs().max().item()
    vec = int(all(t.data_ptr() % 16 == 0 for t in xs + [out]) and
              n >= 16 // out.element_size())
    case = {"shape": list(shape or (n,)), "dtype": str(dtype)[6:],
            "offset_view": offset, "vector_path": bool(vec),
            "max_abs_err": err, "bitwise_equal": bool(torch.equal(out, ref)),
            "tol": 0.0 if exact else SIGMOID_TOL,
            "finite": bool(torch.isfinite(out.double()).all())}
    case["ok"] = (case["bitwise_equal"] if exact else
                  err <= SIGMOID_TOL and case["finite"])
    if timed:
        library = {"tvm_vadd": torch.add, "tvm_vmul": torch.mul,
                   "tvm_sigmoid": torch.sigmoid}[name]
        nbytes = (op.num_inputs + 1) * n * out.element_size()
        bms, by = bound(nbytes, STOCK_FLOPS[name] * n)
        kms = cuda_ms(lambda: op.forward(*xs))
        case.update(kernel_ms=kms,
                    kernel_eager_ms=eager_ms(lambda: op.forward(*xs)),
                    plain_ms=cuda_ms(lambda: op.plain(*xs)),
                    library_ms=cuda_ms(lambda: library(*xs)),
                    library=f"torch.{library.__name__}", bytes=nbytes,
                    bound_ms=bms, bound_by=by,
                    gb_s=nbytes / (kms * 1e-3) / 1e9,
                    bound_share=bms / kms)
    return case


def _compile_ms(src, exports=()):
    """NVRTC compile of ``src``, cold (the cache bypassed) and from the
    CUBIN cache the cold compile wrote."""
    from mxnet_tpu_torch import _nvrtc
    cold = _nvrtc.compile_program(src, (), exports, use_cache=False)
    cached = _nvrtc.compile_program(src, (), exports)
    if not cached.cached or cached.image != cold.image:
        raise AssertionError("the CUBIN cache did not return the compile")
    return {"cold_ms": cold.seconds * 1e3, "cached_ms": cached.seconds * 1e3,
            "cubin_bytes": len(cold.image), "log": cold.log[:400]}


def phase_ext_kernels(state):
    """The three stock generated kernels against their plain versions:
    full width (timed), one element, a ragged length, an offset view
    (the 16-byte path refused; at full width it is timed too) and the
    other element types."""
    import torch
    from mxnet_tpu_torch import tvmop
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    full = 1
    for d in EXT_SHAPE:
        full *= d
    res = {"compile": {}}
    for name in STOCK_OPS:
        res["compile"][name] = _compile_ms(
            tvmop.get(name).source(torch.float32))
        cases = [_ext_case(name, full, gen, shape=EXT_SHAPE, timed=True),
                 _ext_case(name, 1, gen), _ext_case(name, EXT_RAGGED, gen),
                 _ext_case(name, EXT_RAGGED, gen, offset=True)]
        if name == "tvm_vadd":
            cases.append(_ext_case(name, full, gen, offset=True, timed=True))
        dtypes = (torch.float64,) if name == "tvm_sigmoid" else \
            (torch.float64, torch.int32, torch.int64)
        cases += [_ext_case(name, EXT_RAGGED, gen, dtype=dt)
                  for dt in dtypes]
        state["cases"][name] = cases
        res[name] = cases
    bad = [(n, c) for n in STOCK_OPS for c in res[n] if not c["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    if any(res[n][0]["vector_path"] is False or res[n][3]["vector_path"]
           for n in STOCK_OPS):
        raise AssertionError("full width must take the 16-byte path and the "
                             "offset view must not")
    return res


RTC_BAD_SOURCE = 'extern "C" __global__ void bad(float *o) { o[0] = ; }'


def phase_rtc(state):
    """The JAX package's rtc test kernels as CUDA source through
    ``CudaModule``: axpy and the out-dtype-templated ``double_it`` at the
    tests' own sizes and at full width, axpy also at a ragged length (the
    16-byte path and a scalar tail) and on an offset view (the scalar
    path), bit for bit against plain torch; the full width on the 16-byte
    path; one compile for the module however often it launches; a launch
    from a second thread; an NVRTC syntax error and a dtype mismatch
    raise."""
    import torch
    from mxnet_tpu_torch import _nvrtc, rtc
    from mxnet_tpu_torch.examples import rtc_example as rx
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    res = {"compile": _compile_ms(rx.SOURCE.read_text(), rx.EXPORTS)}
    mod = rx.module()
    axpy, dbl = mod.get_kernel("axpy"), mod.get_kernel("double_it")
    checks = {}
    # the tests' own sizes: axpy over 8, double over 16 with grid 2 x 8
    x8 = torch.arange(8, dtype=torch.float32, device="cuda")
    y8 = torch.ones(8, device="cuda")
    o8 = rx.axpy(axpy, x8, y8)
    checks["axpy_8"] = bool(torch.equal(o8, 2 * x8 + 1))
    checks["compiles_after_first_launch"] = mod.compiles
    rx.axpy(axpy, x8, y8)
    x16 = torch.arange(16, dtype=torch.float32, device="cuda")
    for dt in (torch.float32, torch.int32):
        o16 = dbl.launch([x16, 16], grid=(2,), block=(8,), out_dtype=dt)
        checks[f"double_16_{str(dt)[6:]}"] = bool(
            o16.dtype == dt and torch.equal(o16, rx.double_plain(x16, dt)))
    checks["compiles_after_relaunch"] = mod.compiles
    # full width
    x = 3 * torch.randn(EXT_SHAPE, device="cuda", generator=gen)
    y = torch.randn(EXT_SHAPE, device="cuda", generator=gen)
    out = rx.axpy(axpy, x, y)
    ref = rx.axpy_plain(x, y)
    checks["axpy_full"] = bool(torch.equal(out, ref))
    checks["axpy_full_vector_path"] = rx.vector_path(x, y, out)
    # a ragged length: 16-byte vectors and a scalar tail of n % 4
    xr = 3 * torch.randn(EXT_RAGGED, device="cuda", generator=gen)
    yr = torch.randn(EXT_RAGGED, device="cuda", generator=gen)
    outr = rx.axpy(axpy, xr, yr)
    checks["axpy_ragged"] = bool(torch.equal(outr, rx.axpy_plain(xr, yr)))
    # an offset view at full width: 4 bytes past an aligned start, scalar
    xo, yo = (torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:]
              for t in (x, y))
    outo = rx.axpy(axpy, xo, yo)
    refo = rx.axpy_plain(xo, yo)
    checks["axpy_offset"] = bool(torch.equal(outo, refo))
    checks["axpy_offset_scalar_path"] = not rx.vector_path(xo, yo, outo)
    for dt in (torch.float32, torch.int32):
        o = rx.double(dbl, x, dt)
        checks[f"double_full_{str(dt)[6:]}"] = bool(
            torch.equal(o, rx.double_plain(x, dt)))
    # a launch from a thread that has no current context
    got, errs = {}, []

    def worker():
        try:
            xt = torch.randn(EXT_RAGGED, device="cuda")
            yt = torch.randn(EXT_RAGGED, device="cuda")
            got["ok"] = bool(torch.equal(rx.axpy(axpy, xt, yt),
                                         rx.axpy_plain(xt, yt)))
        except Exception as e:
            errs.append(repr(e))

    t = threading.Thread(target=worker)
    t.start()
    t.join(120)
    checks["thread"] = got.get("ok", False) and not errs
    checks["compiles_at_end"] = mod.compiles
    # refusals
    try:
        rtc.CudaModule(RTC_BAD_SOURCE).get_kernel("bad").launch(
            [], out_shape=(1,))
        checks["syntax_error_raises"] = False
    except _nvrtc.NvrtcError as e:
        checks["syntax_error_raises"] = "error" in str(e)
        res["syntax_error_log"] = str(e)[:600]
    try:
        axpy.launch([x.double(), y.double(), x.numel()])
        checks["dtype_mismatch_raises"] = False
    except TypeError as e:
        checks["dtype_mismatch_raises"] = True
        res["dtype_mismatch"] = str(e)
    n = x.numel()
    nbytes = 3 * n * 4
    bms, by = bound(nbytes, 2 * n)
    kms = cuda_ms(lambda: rx.axpy(axpy, x, y))
    lms = cuda_ms(lambda: torch.add(y, x, alpha=2.0))
    case = {"shape": list(EXT_SHAPE), "max_abs_err":
            (out - ref).abs().max().item(), "bitwise_equal":
            checks["axpy_full"], "vector_path":
            checks["axpy_full_vector_path"], "grid": rx.grid_axpy(n, True)[0],
            "kernel_ms": kms,
            "kernel_eager_ms": eager_ms(lambda: rx.axpy(axpy, x, y)),
            "plain_ms": cuda_ms(lambda: rx.axpy_plain(x, y)),
            "library_ms": lms, "library": "torch.add(y, x, alpha=2)",
            "vs_library": kms / lms, "bytes": nbytes,
            "bound_ms": bms, "bound_by": by,
            "gb_s": nbytes / (kms * 1e-3) / 1e9, "bound_share": bms / kms}
    okms = cuda_ms(lambda: rx.axpy(axpy, xo, yo))
    offset = {"shape": list(EXT_SHAPE), "offset_view": True,
              "max_abs_err": (outo - refo).abs().max().item(),
              "bitwise_equal": checks["axpy_offset"], "vector_path": False,
              "kernel_ms": okms, "bound_ms": bms, "bound_by": by,
              "bound_share": bms / okms,
              "library_ms": cuda_ms(lambda: torch.add(yo, xo, alpha=2.0))}
    ragged = {"shape": [EXT_RAGGED], "bitwise_equal": checks["axpy_ragged"],
              "max_abs_err": (outr - rx.axpy_plain(xr, yr)).abs().max()
              .item()}
    state["cases"]["rtc_axpy"] = [case, offset, ragged]
    # the eager cost of one launch at the tests' size, against torch.add
    res["eager_launch_us"] = {
        "rtc_axpy_8": 1e3 * eager_ms(lambda: rx.axpy(axpy, x8, y8),
                                     iters=200),
        "torch_add_8": 1e3 * eager_ms(lambda: torch.add(x8, y8), iters=200)}
    res.update(checks=checks, axpy=case, axpy_offset=offset,
               axpy_ragged=ragged)
    ok = all(v is True for k, v in checks.items()
             if not k.startswith("compiles")) and \
        checks["compiles_after_first_launch"] == 1 and \
        checks["compiles_at_end"] == 1
    if not ok:
        raise AssertionError(f"rtc checks failed: {checks}")
    return res


def phase_ext_path(state):
    """The slice's path at full width, with the launch counters set to 0
    first: ``nd.tvm_vadd`` / ``nd.tvm_vmul``; ``nd.tvm_sigmoid`` forward
    and backward under ``autograd.record()``; a user ``tvmop.register``
    of ``tvm_test_relu``, run and unregistered; ``nd.Custom`` of a
    ``t_sigmoid`` CustomOp forward and backward; the example library
    built by ``compile_example`` and loaded, ``nd.my_relu6`` and
    ``nd.my_scale(k=3.0)`` forward and backward; a user rtc kernel
    (axpy).  Every counter must equal the calls made."""
    import tempfile

    import torch
    from mxnet_tpu_torch import autograd, library, nd, operator, rtc, tvmop
    from mxnet_tpu_torch.examples import rtc_example as rx
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    a = 3 * torch.randn(EXT_SHAPE, device="cuda", generator=gen)
    b = 3 * torch.randn(EXT_SHAPE, device="cuda", generator=gen)
    ops = {n: tvmop.get(n) for n in STOCK_OPS}
    axpy = rx.module().get_kernel("axpy")
    rx.axpy(axpy, a[:1], b[:1])      # compiled before the counted run
    torch.cuda.synchronize()
    res, checks = {}, {}

    @tvmop.register("tvm_test_relu", body="o = x0 < T(0) ? T(0) : x0;")
    def relu(x):
        return torch.clamp_min(x, 0)

    @operator.register("t_sigmoid")
    class _SigmoidProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return _SigmoidOp()

    class _SigmoidOp(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        1.0 / (1.0 + torch.exp(-in_data[0])))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    for op in ops.values():
        op.launches = 0
    relu.launches = 0
    rtc.Kernel.launches = 0
    t_path = time.perf_counter()
    try:
        for _ in range(EXT_CALLS["tvm_vadd"]):
            s = nd.tvm_vadd(a, b)
        for _ in range(EXT_CALLS["tvm_vmul"]):
            p = nd.tvm_vmul(a, b)
        checks["vadd"] = bool(torch.equal(s, a + b))
        checks["vmul"] = bool(torch.equal(p, a * b))
        del s, p
        # sigmoid forward and backward
        x = a.clone().requires_grad_()
        with autograd.record():
            y = nd.tvm_sigmoid(x)
        autograd.backward(y.sum())
        sp = ops["tvm_sigmoid"].plain(a)
        res["sigmoid_fwd_max_abs_err"] = (y.detach() - sp).abs().max().item()
        res["sigmoid_grad_max_abs_err"] = \
            (x.grad - sp * (1 - sp)).abs().max().item()
        checks["sigmoid"] = res["sigmoid_fwd_max_abs_err"] <= SIGMOID_TOL \
            and res["sigmoid_grad_max_abs_err"] <= SIGMOID_TOL
        del x, y
        # a user-registered generated op
        r = nd.tvm_test_relu(a)
        checks["user_relu"] = bool(torch.equal(r, relu.plain(a)))
        checks["user_relu_compiles"] = relu.compiles == 1
        del r
        # a Python custom op, its body torch ops on the card
        x = a.clone().requires_grad_()
        t0 = time.perf_counter()
        with autograd.record():
            y = nd.Custom(x, op_type="t_sigmoid")
        autograd.backward(y.sum())
        torch.cuda.synchronize()
        res["custom_fwd_bwd_ms"] = (time.perf_counter() - t0) * 1e3
        res["custom_max_abs_err"] = max(
            (y.detach() - sp).abs().max().item(),
            (x.grad - sp * (1 - sp)).abs().max().item())
        checks["custom"] = res["custom_max_abs_err"] <= SIGMOID_TOL and \
            y.device == a.device
        del x, y, sp
        # the example library: host code, a round trip each call
        build = os.path.join(HERE, "build", "mxnet_tpu_torch")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as d:
            so = library.compile_example(d)
            library.load(so, verbose=False)
            x = a.clone().requires_grad_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with autograd.record():
                y6 = nd.my_relu6(x)
            torch.cuda.synchronize()
            res["relu6_fwd_round_trip_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            autograd.backward(y6.sum())
            torch.cuda.synchronize()
            res["relu6_bwd_round_trip_ms"] = (time.perf_counter() - t0) * 1e3
            checks["relu6"] = bool(
                y6.device == a.device and
                torch.equal(y6, a.clamp(0, 6)) and
                torch.equal(x.grad, ((a > 0) & (a < 6)).float()))
            del y6
            x.grad = None
            with autograd.record():
                y3 = nd.my_scale(x, k=3.0)
            autograd.backward(y3.sum())
            checks["scale"] = bool(torch.equal(y3, a * 3.0) and
                                   torch.equal(x.grad, torch.full_like(a, 3)))
            del x, y3
        res["round_trip_bytes"] = 2 * a.numel() * 4
        # a user's rtc kernel
        for _ in range(EXT_CALLS["rtc_axpy"]):
            o = rx.axpy(axpy, a, b)
        checks["rtc_axpy"] = bool(torch.equal(o, rx.axpy_plain(a, b)))
        del o
        torch.cuda.synchronize()
        res["path_s"] = time.perf_counter() - t_path
    finally:
        tvmop._REGISTRY.pop("tvm_test_relu", None)
        if hasattr(nd, "tvm_test_relu"):
            delattr(nd, "tvm_test_relu")
    launches = {n: op.launches for n, op in ops.items()}
    launches.update(tvm_test_relu=relu.launches,
                    rtc_axpy=rtc.Kernel.launches)
    state["ext_launches"] = {k: v for k, v in launches.items()
                             if k != "tvm_test_relu"}
    checks["unregistered"] = "tvm_test_relu" not in tvmop.list_ops()
    res.update(shape=list(EXT_SHAPE), launches=launches, calls=EXT_CALLS,
               checks=checks)
    if launches != EXT_CALLS or not all(checks.values()):
        raise AssertionError(f"extension path: {res}")
    return res


# ------------------------------------------------------------------ main
KERNELS = [
    ("layernorm_fused", "mxnet_tpu_torch/csrc/layernorm.cu",
     "mxnet_tpu/ops/pallas_kernels.py:104"),
    ("causal_attention", "mxnet_tpu_torch/csrc/causal_attention.cu",
     "mxnet_tpu/ops/pallas_attention.py:203"),
    ("attention_fwd", "mxnet_tpu_torch/csrc/flash_fwd_tc.cu",
     "mxnet_tpu/ops/pallas_kernels.py:167"),
    ("attention_dq", "mxnet_tpu_torch/csrc/attention.cu",
     "mxnet_tpu/ops/pallas_kernels.py:283"),
    ("attention_dkv", "mxnet_tpu_torch/csrc/attention.cu",
     "mxnet_tpu/ops/pallas_kernels.py:309"),
    ("conv_affine", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:325"),
    ("conv3x3", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:318"),
    ("conv_stats", "mxnet_tpu_torch/csrc/conv3x3_tc.cu",
     "mxnet_tpu/ops/pallas_block.py:343"),
    ("bn_affine", "mxnet_tpu_torch/csrc/conv_train.cu",
     "mxnet_tpu/ops/pallas_block.py:367"),
    ("conv_wgrad", "mxnet_tpu_torch/csrc/conv_wgrad.cu",
     "mxnet_tpu/ops/pallas_block.py:381"),
    ("softmax_fused", "mxnet_tpu_torch/csrc/softmax.cu",
     "mxnet_tpu/ops/pallas_kernels.py:61"),
    ("qconv3x3_affine", "mxnet_tpu_torch/csrc/qconv_affine.cu",
     "mxnet_tpu/ops/pallas_int8.py:197"),
    ("tvm_vadd", "mxnet_tpu_torch/csrc/tvmop_elementwise.cuh",
     "mxnet_tpu/tvmop.py:50"),
    ("tvm_vmul", "mxnet_tpu_torch/csrc/tvmop_elementwise.cuh",
     "mxnet_tpu/tvmop.py:50"),
    ("tvm_sigmoid", "mxnet_tpu_torch/csrc/tvmop_elementwise.cuh",
     "mxnet_tpu/tvmop.py:50"),
    ("rtc_axpy", "mxnet_tpu_torch/examples/rtc_kernels.cu",
     "mxnet_tpu/rtc.py:35"),
]
# what else an entry names: the header holding the body two attention
# entries share, the kernels of a stream-K entry (main, then the one that
# finishes the cut tiles), the registered Pallas body a generated kernel
# replaces, the module that compiles and launches the rtc route
KERNEL_NOTES = {
    "conv_affine": {"kernels": ["conv_affine_tc_kernel",
                                "conv_affine_reduce_kernel"],
                    "loop": "conv_ranges, shared with conv3x3 and "
                            "conv_stats"},
    "qconv3x3_affine": {"kernels": ["qconv_affine_kernel",
                                    "qconv_reduce_kernel"]},
    "causal_attention": {"kernel_body": "mxnet_tpu_torch/csrc/"
                                        "flash_fwd_tc.cuh"},
    "attention_fwd": {"kernel_body": "mxnet_tpu_torch/csrc/"
                                     "flash_fwd_tc.cuh"},
    "tvm_vadd": {"body": "mxnet_tpu/tvmop.py:119", "compiler": "nvrtc"},
    "tvm_vmul": {"body": "mxnet_tpu/tvmop.py:124", "compiler": "nvrtc"},
    "tvm_sigmoid": {"body": "mxnet_tpu/tvmop.py:138", "compiler": "nvrtc"},
    "rtc_axpy": {"body": "tests/test_pallas_rtc.py:85",
                 "launcher": "mxnet_tpu_torch/rtc.py", "compiler": "nvrtc"},
}
PATH_LAUNCHES = ("launches", "bert_launches", "image_launches",
                 "train_launches", "text_launches", "int8_launches",
                 "ext_launches")


def kernels_line(state):
    """One entry per kernel.  ``launches`` sums the main-path runs that
    launch it (GPT serving in ``slice``, BERT training in
    ``bert_train``, ResNet-50 serving in ``image_serve``, ResNet-50
    training in ``image_train``, Gluon BERT serving in ``text_serve``,
    int8 ResNet-50 scoring and serving in ``int8_score`` and
    ``int8_serve``, the extension surface in ``ext_path``);
    the times are at the first case, the
    path's own shape (``conv3x3``: its dgrad use, which is how training
    launches it)."""
    out = []
    for name, source, replaces in KERNELS:
        cases = state["cases"][name]
        main = cases[0]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": sum(state[k].get(name, 0)
                                    for k in PATH_LAUNCHES),
                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                    "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
                    "eager_ms": main["kernel_eager_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"],
                    "shape": main["shape"], "card": state["card"],
                    **{k: main[k] for k in ("bound_fp32_ms",) if k in main},
                    **KERNEL_NOTES.get(name, {})})
    return {"kernels": out}


PHASES = ("env", "build", "kernels", "slice", "reference", "profile",
          "bert_kernels", "bert_train", "bert_reference", "bert_profile",
          "image_kernels", "image_serve", "image_reference", "image_profile",
          "train_kernels", "image_train", "image_train_reference",
          "image_train_profile", "text_kernels", "text_serve",
          "text_reference", "text_profile", "int8_kernels", "int8_score",
          "int8_serve", "int8_reference", "int8_profile", "ext_kernels",
          "rtc", "ext_path")


def _args(argv):
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "card (see the module docstring).")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone, in order")
    return ap.parse_args(argv)


def main(argv=None):
    args = _args(sys.argv[1:] if argv is None else argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the mxnet_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    names = args.phases.split(",") if args.phases else PHASES
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        print(f"chip_smoke: no phases {unknown}", file=sys.stderr)
        return 2

    state = {"card": None, "cases": {}}
    for name in names:
        t0 = time.perf_counter()
        try:
            res = globals()["phase_" + name](state)
        except Exception as e:
            traceback.print_exc()
            emit({"phase": name, "ok": False, "card": state["card"],
                  "error": f"{type(e).__name__}: {e}"[:4000]})
            return 1
        emit({"phase": name, "ok": True, "card": state["card"],
              "phase_s": time.perf_counter() - t0, **res})
    if args.phases:
        return 0
    emit(kernels_line(state))
    print(state["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
