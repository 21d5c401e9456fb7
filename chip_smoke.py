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
1000 classes, SGD lr 0.1, momentum 0.9, wd 1e-4).  Phases, one JSON
line each; the run stops with a non-zero exit at the first phase that
fails:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions; TF32 is switched off for matmul and cuDNN.
2. ``build``: nvcc builds the kernels of ``mxnet_tpu_torch/csrc``.
3. ``kernels``: each kernel at the shapes the path gives it, against its
   plain PyTorch version on the same inputs (LayerNorm within 1e-5,
   attention within 1e-4: its sums run in another order), with CUDA
   event times of the kernel, the plain version and one PyTorch library
   call computing the same function (timed here, never used by the port).
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
   1e-5, dq/dk/dv within 1e-4 of the tensor's largest magnitude), timed
   beside their bounds, the plain versions and SDPA (forward; backward
   for dq and dk/dv together).
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
    kernel against its plain version at ResNet-50's four 3x3 stages at
    batch 8, the 7x7x512 stage at batch 1, ResNet-18's residual tail,
    ReLU off and a ragged shape (within 1e-4 of the output's largest
    magnitude: the 9*C sums run in another order), timed beside its
    bound, its plain version and ``F.conv2d`` alone.
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

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the
result line ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside this file, it exits non-zero and prints
no result.
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

# H100 SXM peaks (NVIDIA data sheet): device memory and fp32 on CUDA cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12

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


def cuda_ms(fn, iters=20, repeats=5):
    """Device time of one call of ``fn`` in ms: the median over
    ``repeats`` CUDA-event windows of ``iters`` back-to-back calls.  Each
    window starts behind a ~20 ms device-side sleep, so the host has
    queued every call before the first one runs and the window holds
    device time only, not the host's launch overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
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


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_flops = flops / PEAK_FP32_FLOP_S * 1e3
    return (max(t_bytes, t_flops),
            "bytes" if t_bytes >= t_flops else "operations")


# ---------------------------------------------------------------- phases
def phase_env(state):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from mxnet_tpu_torch import context
    context.exact_fp32()
    state["card"] = smi
    return {"card": smi, "device": torch.cuda.get_device_name(0),
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
        m = re.search(r"entry function '\S*?(causal_attn_fwd|layernorm_fwd|"
                      r"attn_fwd|attn_dq|attn_dkv|conv_affine_kernel|"
                      r"conv3x3_kernel|conv_stats_kernel|"
                      r"conv_wgrad_kernel|bn_affine_kernel)"
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
    ref = causal_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    nbytes = 4 * B * H * L * hd * 4
    flops = 4 * B * H * hd * (L * (L + 1) // 2)
    bms, by = bound(nbytes, flops)
    return {"shape": [B * H, L, hd], "max_abs_err": err, "tol": ATTN_TOL,
            "kernel_ms": cuda_ms(lambda: causal_attention(q, k, v, scale)),
            "kernel_eager_ms": eager_ms(
                lambda: causal_attention(q, k, v, scale)),
            "plain_ms": cuda_ms(
                lambda: causal_attention_plain(q, k, v, scale)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)),
            "bytes": nbytes, "flop": flops, "bound_ms": bms,
            "bound_by": by}


def phase_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ln = [_ln_case(r, 768, gen) for r in (4096, 512, 8, 1)]
    attn = [_attn_case(8, 6, 512, 128, gen), _attn_case(1, 6, 512, 128, gen),
            _attn_case(8, 12, 512, 64, gen), _attn_case(1, 6, 200, 128, gen)]
    bad = [c for c in ln + attn if not c["max_abs_err"] <= c["tol"]]
    state["cases"] = {"layernorm_fused": ln, "causal_attention": attn}
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    return {"cases": state["cases"]}


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
    ("conv_affine (ours)", r"conv_affine_kernel"),
    ("conv3x3 / dgrad (ours)", r"conv3x3_kernel"),
    ("conv_stats (ours)", r"conv_stats_kernel|stats_reduce_kernel"),
    ("bn_affine (ours)", r"bn_affine_kernel"),
    ("conv_wgrad (ours)", r"conv_wgrad_kernel|wgrad_reduce_kernel"),
    ("batch norm", r"batch_norm|bn_fw"),
    ("layout transform", r"nchwToNhwc|nhwcToNchw"),
    ("cuDNN conv backward", r"dgrad|wgrad|bprop"),
    ("cuDNN conv", r"fprop|convolve|implicit_gemm|cudnn"),
    ("gemm", r"gemm|gemv|splitKreduce"),
    ("attention (ours)", r"attn_(fwd|dq|dkv)|causal_attn_fwd"),
    ("layernorm (ours)", r"layernorm_fwd"),
    ("optimizer foreach", r"multi_tensor_apply"),
    ("softmax", r"softmax"),
    ("pooling", r"pool"),
    ("reduction", r"reduce_kernel"),
    ("embedding / index", r"embedding|index|scatter|gather"),
    ("elementwise", r"elementwise|vectorized"),
)


def _category(name):
    for cat, pat in KERNEL_CATEGORIES:
        if re.search(pat, name, re.I):
            return cat
    return "other"


def _profile(fn, calls, top=6):
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
        k = cats.setdefault(_category(n), [0, 0.0])
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
    the same lse and delta; times of each beside its bound, its plain
    version and SDPA (``attention_fwd``: the forward; ``attention_dq``
    and ``attention_dkv``: SDPA's backward, which computes dq, dk and dv
    together)."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    q, k, v = _bert_qkv(B, H, L, D, strided, gen)
    g = torch.randn(B, H, L, D, device="cuda", generator=gen)
    sc = D ** -0.5
    o, lse = fa.attention_fwd(q, k, v, sc)
    ro, rlse = fa.attention_fwd_plain(q, k, v, sc)
    delta = (g * ro).sum(dim=-1).contiguous()
    dq = fa.attention_dq(q, k, v, g, rlse, delta, sc)
    rdq = fa.attention_dq_plain(q, k, v, g, rlse, delta, sc)
    dk, dv = fa.attention_dkv(q, k, v, g, rlse, delta, sc)
    rdk, rdv = fa.attention_dkv_plain(q, k, v, g, rlse, delta, sc)
    torch.cuda.synchronize()

    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, scale=sc)
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (lq, lk, lv), g, retain_graph=True))
    bh, el = B * H, 4 * B * H * L * D       # one (B, H, L, D) fp32 in bytes
    shape = [bh, L, D]
    common = {"shape": shape, "strided": strided}
    fwd_b = bound(4 * el + 4 * bh * L, 4 * bh * L * L * D)
    dq_b = bound(5 * el + 8 * bh * L, 6 * bh * L * L * D)
    dkv_b = bound(6 * el + 8 * bh * L, 8 * bh * L * L * D)
    cases = {
        "attention_fwd": dict(
            common, max_abs_err=(o - ro).abs().max().item(),
            lse_max_abs_err=(lse - rlse).abs().max().item(),
            tol=ATTN_TOL, lse_tol=LSE_TOL,
            kernel_ms=cuda_ms(lambda: fa.attention_fwd(q, k, v, sc)),
            kernel_eager_ms=eager_ms(lambda: fa.attention_fwd(q, k, v, sc)),
            plain_ms=cuda_ms(lambda: fa.attention_fwd_plain(q, k, v, sc)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=sc)),
            library="F.scaled_dot_product_attention",
            bound_ms=fwd_b[0], bound_by=fwd_b[1]),
        "attention_dq": dict(
            common, max_abs_err=(dq - rdq).abs().max().item(),
            rel_err=_rel(dq, rdq), tol=ATTN_TOL,
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
            rel_err=max(_rel(dk, rdk), _rel(dv, rdv)), tol=ATTN_TOL,
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
            c["lse_max_abs_err"] <= c["lse_tol"]
    return c["rel_err"] <= c["tol"]


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
    return {"cases": {n: state["cases"][n] for n in
                      ("attention_fwd", "attention_dq", "attention_dkv")}}


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


def _conv_case(N, H, W, C, Cout, gen, residual=False, relu=True):
    """``conv_affine`` against ``conv_affine_plain`` at one shape, timed
    beside its bound, its plain version and ``F.conv2d`` alone (cuDNN,
    channels-last, TF32 off): the nearest single library call, which
    does less work than the kernel (no BN fold, residual or ReLU)."""
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
    bms, by = bound(nbytes, flops)
    kms = cuda_ms(lambda: conv_affine(*args, relu=relu))
    return {"shape": [N, H, W, C, Cout], "residual": residual, "relu": relu,
            "max_abs_err": err, "rel_err": err / max(scale, 1e-30),
            "tol": CONV_TOL, "kernel_ms": kms,
            "kernel_eager_ms": eager_ms(lambda: conv_affine(*args,
                                                            relu=relu)),
            "plain_ms": cuda_ms(lambda: conv_affine_plain(*args,
                                                          relu=relu)),
            "library_ms": cuda_ms(lambda: F.conv2d(xc, wc, padding=1)),
            "library": "F.conv2d alone (cuDNN, channels-last; no BN fold, "
                       "residual or ReLU)",
            "bytes": nbytes, "flop": flops, "bound_ms": bms, "bound_by": by,
            "tflop_s": flops / (kms * 1e-3) / 1e12}


def phase_image_kernels(state):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    # ResNet-50's four 3x3 stages at batch 8 (the path shape first), the
    # batch-1 tail, ResNet-18's residual tail, relu off, and a ragged one
    cases = [_conv_case(8, 56, 56, 64, 64, gen),
             _conv_case(8, 28, 28, 128, 128, gen),
             _conv_case(8, 14, 14, 256, 256, gen),
             _conv_case(8, 7, 7, 512, 512, gen),
             _conv_case(1, 7, 7, 512, 512, gen),
             _conv_case(8, 56, 56, 64, 64, gen, residual=True),
             _conv_case(8, 28, 28, 128, 128, gen, relu=False),
             _conv_case(2, 13, 17, 24, 40, gen, residual=True)]
    state["cases"]["conv_affine"] = cases
    bad = [c for c in cases if not c["rel_err"] <= c["tol"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    return {"cases": cases}


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
    rdx = cb.conv3x3_plain(dy, wr)
    err, rel = _rel_err(dx, rdx)
    out["conv3x3_dgrad"] = _timed(
        {"shape": shape, "use": "dgrad: conv3x3(dy, rotate(w))",
         "max_abs_err": err, "rel_err": rel, "tol": TRAIN_TOL,
         "library": "torch.nn.grad.conv2d_input (cuDNN)"},
        lambda: cb.conv3x3(dy, wr), lambda: cb.conv3x3_plain(dy, wr),
        lambda: torch.nn.grad.conv2d_input(xc.shape, wc, dyc, padding=1),
        conv_bytes, flops)

    dw = cb.conv_wgrad(x, dy)
    rdw = cb.conv_wgrad_plain(x, dy)
    err, rel = _rel_err(dw, rdw)
    splits, _ = cb.wgrad_splits(npix, 9 * C, Cout,
                                torch.cuda.get_device_properties(0)
                                .multi_processor_count)
    out["conv_wgrad"] = _timed(
        {"shape": shape, "splits": splits, "max_abs_err": err,
         "rel_err": rel, "tol": TRAIN_TOL,
         "library": "torch.nn.grad.conv2d_weight (cuDNN)"},
        lambda: cb.conv_wgrad(x, dy), lambda: cb.conv_wgrad_plain(x, dy),
        lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, dyc, padding=1),
        conv_bytes, flops)
    if dgrad_only:
        return out

    z = cb.conv3x3(x, w)
    rz = cb.conv3x3_plain(x, w)
    err, rel = _rel_err(z, rz)
    out["conv3x3"] = _timed(
        {"shape": shape, "use": "forward", "max_abs_err": err,
         "rel_err": rel, "tol": TRAIN_TOL,
         "library": "F.conv2d (cuDNN, channels-last)"},
        lambda: cb.conv3x3(x, w), lambda: cb.conv3x3_plain(x, w),
        lambda: F.conv2d(xc, wc, padding=1), conv_bytes, flops)

    z, s1, s2 = cb.conv_stats(x, w)
    rz, r1, r2 = cb.conv_stats_plain(x, w)
    err, rel = _rel_err(z, rz)
    mag = rz.abs().sum(dim=(0, 1, 2))
    s1_rel = ((s1 - r1).abs() / mag).max().item()
    s2_rel = ((s2 - r2).abs() / r2.abs()).max().item()
    out["conv_stats"] = _timed(
        {"shape": shape, "max_abs_err": err, "rel_err": rel,
         "tol": TRAIN_TOL, "sum_rel_err": s1_rel, "sumsq_rel_err": s2_rel,
         "stats_rtol": STATS_RTOL,
         "library": "F.conv2d alone (cuDNN; no sums)"},
        lambda: cb.conv_stats(x, w), lambda: cb.conv_stats_plain(x, w),
        lambda: F.conv2d(xc, wc, padding=1), conv_bytes + 8 * Cout, flops)
    return out


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
    if name == "conv_stats":
        return c["sum_rel_err"] <= c["stats_rtol"] and \
            c["sumsq_rel_err"] <= c["stats_rtol"]
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
    return {"cases": cases}


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


# ------------------------------------------------------------------ main
KERNELS = [
    ("layernorm_fused", "mxnet_tpu_torch/csrc/layernorm.cu",
     "mxnet_tpu/ops/pallas_kernels.py:104"),
    ("causal_attention", "mxnet_tpu_torch/csrc/causal_attention.cu",
     "mxnet_tpu/ops/pallas_attention.py:203"),
    ("attention_fwd", "mxnet_tpu_torch/csrc/attention.cu",
     "mxnet_tpu/ops/pallas_kernels.py:167"),
    ("attention_dq", "mxnet_tpu_torch/csrc/attention.cu",
     "mxnet_tpu/ops/pallas_kernels.py:283"),
    ("attention_dkv", "mxnet_tpu_torch/csrc/attention.cu",
     "mxnet_tpu/ops/pallas_kernels.py:309"),
    ("conv_affine", "mxnet_tpu_torch/csrc/conv_affine.cu",
     "mxnet_tpu/ops/pallas_block.py:325"),
    ("conv3x3", "mxnet_tpu_torch/csrc/conv_train.cu",
     "mxnet_tpu/ops/pallas_block.py:318"),
    ("conv_stats", "mxnet_tpu_torch/csrc/conv_train.cu",
     "mxnet_tpu/ops/pallas_block.py:343"),
    ("bn_affine", "mxnet_tpu_torch/csrc/conv_train.cu",
     "mxnet_tpu/ops/pallas_block.py:367"),
    ("conv_wgrad", "mxnet_tpu_torch/csrc/conv_train.cu",
     "mxnet_tpu/ops/pallas_block.py:381"),
]
PATH_LAUNCHES = ("launches", "bert_launches", "image_launches",
                 "train_launches")


def kernels_line(state):
    """One entry per kernel.  ``launches`` sums the main-path runs that
    launch it (GPT serving in ``slice``, BERT training in
    ``bert_train``, ResNet-50 serving in ``image_serve``, ResNet-50
    training in ``image_train``); the times are at the first case, the
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
                    "shape": main["shape"], "card": state["card"]})
    return {"kernels": out}


def main():
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

    state = {"card": None}
    for name, fn in (("env", phase_env), ("build", phase_build),
                     ("kernels", phase_kernels), ("slice", phase_slice),
                     ("reference", phase_reference),
                     ("profile", phase_profile),
                     ("bert_kernels", phase_bert_kernels),
                     ("bert_train", phase_bert_train),
                     ("bert_reference", phase_bert_reference),
                     ("bert_profile", phase_bert_profile),
                     ("image_kernels", phase_image_kernels),
                     ("image_serve", phase_image_serve),
                     ("image_reference", phase_image_reference),
                     ("image_profile", phase_image_profile),
                     ("train_kernels", phase_train_kernels),
                     ("image_train", phase_image_train),
                     ("image_train_reference", phase_image_train_reference),
                     ("image_train_profile", phase_image_train_profile)):
        t0 = time.perf_counter()
        try:
            res = fn(state)
        except Exception as e:
            traceback.print_exc()
            emit({"phase": name, "ok": False, "card": state["card"],
                  "error": f"{type(e).__name__}: {e}"[:4000]})
            return 1
        emit({"phase": name, "ok": True, "card": state["card"],
              "phase_s": time.perf_counter() - t0, **res})
    emit(kernels_line(state))
    print(state["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
