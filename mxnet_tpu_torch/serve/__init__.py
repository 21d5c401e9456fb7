"""mxnet_tpu_torch.serve — the serving tier of the port (≙
``mxnet_tpu/serve``).

- :class:`InferenceEngine` (engine.py) — one model over a ladder of batch
  buckets, warmed before traffic.
- :class:`Batcher` (batcher.py) — request-level continuous batching with
  bounded-queue admission control (:class:`QueueFull`);
  :class:`DecodeBatcher` — token-level continuous batching for GPT.
- :class:`ModelRegistry` (registry.py) — several models, LRU-capped,
  loaded from ``CheckpointManager`` roots or ``.params`` files, warm
  swaps (``publish``).
- :class:`InferenceServer` (server.py) — stdlib HTTP front end:
  ``/v1/predict``, ``/v1/models``, readiness-aware ``/healthz``,
  ``/metrics``, 429 / 503 with a derived ``Retry-After``, drain and
  undrain, ``MXNET_SERVE_FAULT`` injection (faults.py).
- :class:`Router` (router.py) — probing, ejection and reinstatement,
  per-replica breakers, least-loaded picks, retries, hedging.
- ``bench.serve_bench`` — open-loop load, QPS and p50/p99;
  ``chaos.resilience_bench`` — a two-replica fleet, SIGKILL, respawn.

``python -m mxnet_tpu_torch.serve --model NAME=ARCH:SOURCE --item-shape
224,224,3`` serves a checkpoint root or ``.params`` file over HTTP (on the
card unless ``--device cpu``); ``--selftest-model NAME`` serves the seeded
bench mlp instead; ``--check`` runs :func:`_selfcheck`.
"""
from __future__ import annotations

import sys

from .batcher import Batcher, DecodeBatcher, QueueFull, RequestError
from .engine import (DEFAULT_BUCKETS, InferenceEngine, bucket_ladder,
                     resolve_precision)
from .registry import ModelEntry, ModelRegistry
from .router import Router
from .server import InferenceServer

__all__ = ["Batcher", "DecodeBatcher", "QueueFull", "RequestError",
           "InferenceEngine", "DEFAULT_BUCKETS", "bucket_ladder",
           "resolve_precision", "ModelRegistry", "ModelEntry",
           "InferenceServer", "Router"]


# --------------------------------------------------------------------- check
BURST_TOL = 1e-5    # of the largest |logit|: batched against unbatched


def _selfcheck(verbose: bool = True, device=None) -> int:
    """The reference's serve-check, end to end.

    A small Dense net is registered and warmed over the (1, 2, 4, 8)
    ladder; a barrier-released burst of 16 concurrent single-item
    requests must be served through coalesced batches with every
    prediction within ``BURST_TOL`` of the largest logit of the
    unbatched forward and of the same argmax (the reference asks for bit
    equality, which a matrix product on the CPU does not keep across
    batch sizes: its own check fails there too), at least one batch of
    more than one request, 0 retraces, a p99 from ``telemetry.quantile``
    and no leaked ``serve-`` threads.  A second
    leg streams two concurrent generations of a tiny GPT through a
    :class:`DecodeBatcher`, equal to the unbatched greedy decode, with
    joins and leaves at iteration boundaries."""
    import threading
    import time

    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from .. import context as _context
    from .. import telemetry as _telemetry
    from ..gluon import nn

    dev = _context.resolve(device)
    _telemetry.reset()
    mx.seed(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu"), nn.Dense(10))
    net.initialize(ctx=dev)
    net.hybridize()

    item = (16,)
    reg = ModelRegistry(max_models=2, device=dev)
    entry = reg.register("check", net, item, buckets=(1, 2, 4, 8),
                         warmup=True)
    # a generous deadline so the burst coalesces instead of trickling
    entry.batcher.max_wait_s = 0.03

    n_req = 16
    rs = np.random.RandomState(7)
    xs = [rs.randn(*item).astype("float32") for _ in range(n_req)]
    results = [None] * n_req
    errors = [None] * n_req
    barrier = threading.Barrier(n_req)

    def _client(i):
        try:
            barrier.wait()
            results[i] = reg.predict("check", xs[i])
        except Exception as e:  # noqa: BLE001 — recorded, asserted below
            errors[i] = e

    threads = [threading.Thread(target=_client, args=(i,),
                                name=f"check-client-{i}")
               for i in range(n_req)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)

    agree = True
    with torch.inference_mode():
        for i in range(n_req):
            if errors[i] is not None or results[i] is None:
                agree = False
                break
            ref = net(torch.as_tensor(xs[i][None], device=dev)).cpu().numpy()
            got = results[i][0]
            if got.shape != ref.shape or \
                    np.abs(got - ref).max() > BURST_TOL * np.abs(ref).max() \
                    or got.argmax() != ref.argmax():
                agree = False
                break

    snap = _telemetry.raw_snapshot()
    counters = snap.get("counters", {})
    coalesced = int(counters.get("serve.coalesced_batches", 0))
    batches = int(counters.get("serve.batches", 0))
    p99 = _telemetry.quantile("serve", "e2e_us", 0.99, snap=snap)
    retraces = entry.engine.retraces

    # ------------------------------------------- streaming decode leg
    from .. import generate as _generate
    from ..models import gpt as _gpt

    gcfg = _gpt.GPTConfig(vocab_size=61, hidden=32, layers=2, heads=2,
                          intermediate=64, max_len=64)
    gparams = _gpt.init_params(gcfg, seed=0, device=dev)
    eng = _generate.DecodeEngine(gparams, gcfg, name="sc-gpt", window=16,
                                 buckets=(2,), prompts=(8,),
                                 device=dev).warmup()
    gprompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    gsingles = [eng.generate([p], max_new=6)[0] for p in gprompts]
    gstream = [None] * len(gprompts)
    gerrors = [None] * len(gprompts)
    bat = DecodeBatcher(eng, slots=2, name="sc-gpt")
    try:
        gbarrier = threading.Barrier(len(gprompts))

        def _gen_client(i):
            try:
                gbarrier.wait()
                gstream[i] = list(bat.submit_stream(gprompts[i],
                                                    max_new=6))
            except Exception as e:  # noqa: BLE001 — asserted below
                gerrors[i] = e

        gthreads = [threading.Thread(target=_gen_client, args=(i,),
                                     name=f"check-gen-client-{i}")
                    for i in range(len(gprompts))]
        for t in gthreads:
            t.start()
        for t in gthreads:
            t.join(60.0)
        dstats = bat.stats()
    finally:
        bat.close()
    stream_exact = (all(e is None for e in gerrors) and
                    [list(s) for s in gstream] ==
                    [list(s) for s in gsingles])
    dec_retraces = eng.retraces

    reg.close()
    time.sleep(0.1)
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith("serve-")]

    checks = [
        ("all %d requests served" % n_req,
         all(e is None for e in errors) and
         all(r is not None for r in results)),
        ("predictions match the unbatched forward (%g, argmax)"
         % BURST_TOL, agree),
        ("≥1 coalesced batch (fill > 1) in %d batches" % batches,
         coalesced >= 1),
        ("0 retraces after warm-up", retraces == 0),
        ("p99 e2e latency reported", p99 is not None),
        ("streamed decode bit-for-bit vs unbatched greedy",
         stream_exact),
        ("decode joins/leaves at iteration boundaries",
         dstats["joins"] >= 2 and dstats["leaves"] >= 2),
        ("0 decode retraces across streaming", dec_retraces == 0),
        ("no leaked serve threads", not leaked),
    ]
    ok = all(c for _, c in checks)
    if verbose:
        for name, c in checks:
            print(f"[serve-check] {'ok  ' if c else 'FAIL'} {name}")
        print(f"[serve-check] batches={batches} coalesced={coalesced} "
              f"retraces={retraces} "
              f"p99={p99 / 1000.0 if p99 else p99}ms leaked={leaked}")
    if not ok:
        errs = [repr(e) for e in errors if e is not None]
        if errs:
            print(f"[serve-check] request errors: {errs[:3]}",
                  file=sys.stderr)
        print("[serve-check] FAIL", file=sys.stderr)
        return 1
    print("[serve-check] OK")
    return 0


def _main(argv):
    """``python -m mxnet_tpu_torch.serve``: ``--check`` runs
    :func:`_selfcheck`; otherwise register the models and serve them
    over HTTP until interrupted."""
    import argparse

    p = argparse.ArgumentParser(prog="mxnet_tpu_torch.serve")
    p.add_argument("--check", action="store_true",
                   help="run the serving self-check and exit")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--model", action="append", default=[],
                   metavar="NAME=ARCH:SOURCE",
                   help="register a model from a checkpoint dir or "
                        ".params file (repeatable)")
    p.add_argument("--selftest-model", default=None, metavar="NAME",
                   help="register the small seeded bench mlp under NAME "
                        "(the chaos harness's replica mode: no checkpoint "
                        "on disk needed)")
    p.add_argument("--item-shape", default="3,224,224",
                   help="comma shape of one request item (the zoo's image "
                        "nets are NHWC: 224,224,3)")
    p.add_argument("--device", default=None,
                   help="cpu, or a card (default: the current card)")
    args = p.parse_args(argv)
    if args.check:
        return _selfcheck(verbose=not args.quiet, device=args.device)

    item = tuple(int(d) for d in args.item_shape.split(",") if d.strip())
    reg = ModelRegistry(device=args.device)
    if args.selftest_model:
        import mxnet_tpu_torch as mx
        from .. import context as _context
        from .bench import _build_model
        mx.seed(0)
        net, st_item = _build_model("mlp")
        net.initialize(ctx=_context.resolve(args.device))
        net.hybridize()
        reg.register(args.selftest_model, net, st_item)
        print(f"[serve] registered selftest model "
              f"{args.selftest_model!r} (mlp, item {st_item})", flush=True)
    for spec in args.model:
        name, rest = spec.split("=", 1)
        arch, source = rest.split(":", 1)
        reg.load(name, source, arch=arch, item_shape=item)
        print(f"[serve] loaded {name} ({arch}) from {source}", flush=True)
    srv = InferenceServer(reg, host=args.host, port=args.port)
    print(f"[serve] listening on {srv.host}:{srv.port} "
          f"models={reg.names()}", flush=True)
    srv.serve_forever()
    return 0
