"""Serving benchmark — synthetic open-loop load against the full tier
(≙ ``mxnet_tpu/serve/bench.py`` ``serve_bench``).

Open-loop means arrivals are scheduled on a fixed clock independent of
completions (a closed loop understates tail latency: a slow server
throttles its own offered load).  A submitter thread issues one
single-item request every 1/QPS seconds through the model's batcher;
the batcher coalesces whatever has queued when a deadline or a full
bucket flushes.  Every request carries fresh random bytes.

Reports achieved QPS, p50/p99 end-to-end latency from
``telemetry.quantile``, batch fill, padding and rejection counts as one
JSON row.  ``tp_serving_bench`` (tensor-parallel serving) raises: it
belongs to the mesh item of the port's queue (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import os
import sys
import threading
import time

import numpy as onp

from .. import telemetry as _telemetry

__all__ = ["serve_bench", "tp_serving_bench"]


def _build_model(name: str):
    """BENCH_SERVE_MODEL: 'mlp' (default: a small Dense stack, so the row
    measures the serving tier) or any model zoo name (e.g.
    resnet50_v1).  The zoo's image nets are NHWC, so their item is
    (224, 224, 3) (the reference's (3, 224, 224) would give its stem 224
    input channels)."""
    from ..gluon import nn
    if name == "mlp":
        net = nn.HybridSequential()
        net.add(nn.Dense(256, activation="relu"),
                nn.Dense(256, activation="relu"),
                nn.Dense(64))
        item = (64,)
    else:
        from ..models import get_model
        net = get_model(name)
        item = (224, 224, 3)
    return net, item


def serve_bench(device=None) -> dict:
    """One bench row: sustained QPS + p50/p99 under open-loop load
    (``BENCH_SERVE_MODEL``, ``BENCH_SERVE_QPS`` (200), ``BENCH_SERVE_S``
    (5)), on the card unless ``device="cpu"``."""
    import mxnet_tpu_torch as mx
    from .. import context as _context
    from .batcher import QueueFull
    from .registry import ModelRegistry

    model = os.environ.get("BENCH_SERVE_MODEL", "mlp")
    qps = float(os.environ.get("BENCH_SERVE_QPS", "200"))
    duration = float(os.environ.get("BENCH_SERVE_S", "5"))

    dev = _context.resolve(device)
    mx.seed(0)
    net, item = _build_model(model)
    net.initialize(ctx=dev)
    net.hybridize()

    _telemetry.reset()
    reg = ModelRegistry(max_models=1, device=dev)
    t0 = time.perf_counter()
    entry = reg.register(model, net, item)
    warmup_s = time.perf_counter() - t0

    rs = onp.random.RandomState(0)
    pending = []
    rejected = [0]
    stop = threading.Event()

    def _submit_loop():
        period = 1.0 / qps
        t_next = time.perf_counter()
        end = t_next + duration
        while not stop.is_set():
            now = time.perf_counter()
            if now >= end:
                return
            if now < t_next:
                time.sleep(min(t_next - now, 0.002))
                continue
            t_next += period
            # fresh bytes per request: no cache can serve a repeat
            x = rs.randn(*item).astype(entry.engine.dtype)
            try:
                pending.append(entry.batcher.submit_async(x))
            except QueueFull:
                rejected[0] += 1

    th = threading.Thread(target=_submit_loop, name="serve-bench-load",
                          daemon=True)
    t_start = time.perf_counter()
    th.start()
    th.join(duration + 30.0)
    stop.set()
    deadline = time.perf_counter() + 30.0
    completed = 0
    for req in pending:
        if req.event.wait(max(0.0, deadline - time.perf_counter())) \
                and req.error is None:
            completed += 1
    wall = time.perf_counter() - t_start

    snap = _telemetry.raw_snapshot()
    counters = snap.get("counters", {})
    hists = snap.get("histograms", {})

    def q(name, p):
        v = _telemetry.quantile("serve", name, p, snap=snap)
        return round(v / 1000.0, 3) if v is not None else None

    fill = hists.get("serve.batch_fill", {})
    fill_cnt = fill.get("count", 0)
    out = {
        "model": model,
        "target_qps": qps,
        "duration_s": duration,
        "achieved_qps": round(completed / wall, 1) if wall > 0 else None,
        "submitted": len(pending) + rejected[0],
        "completed": completed,
        "rejected": rejected[0],
        "batches": int(counters.get("serve.batches", 0)),
        "coalesced_batches": int(counters.get("serve.coalesced_batches",
                                              0)),
        "padded_items": int(counters.get("serve.padded", 0)),
        "mean_fill": round(fill.get("sum", 0.0) / fill_cnt, 2)
        if fill_cnt else None,
        "retraces": entry.engine.retraces,
        "warmup_s": round(warmup_s, 3),
        "e2e_p50_ms": q("e2e_us", 0.50),
        "e2e_p99_ms": q("e2e_us", 0.99),
        "queue_wait_p50_ms": q("queue_wait_us", 0.50),
        "device_p50_ms": q("device_us", 0.50),
        "device_p99_ms": q("device_us", 0.99),
    }
    reg.close()
    print(f"[bench] serve: {out['achieved_qps']} qps sustained "
          f"(target {qps:g}), p50 {out['e2e_p50_ms']}ms "
          f"p99 {out['e2e_p99_ms']}ms, fill {out['mean_fill']}, "
          f"{out['rejected']} rejected, {out['retraces']} retraces",
          file=sys.stderr)
    return out


def tp_serving_bench() -> dict:
    raise NotImplementedError(
        "tp_serving_bench: tensor-parallel serving belongs to the mesh "
        "item of the port's queue (ROADMAP Queue 1 item 7), not ported yet")
