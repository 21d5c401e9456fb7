"""The end-to-end distributed-tracing gate (≙ ``mxnet_tpu/tracecheck.py``).

Two legs, each spawning a real second OS process:

A. serving: one replica subprocess (``python -m mxnet_tpu_torch.serve
   --selftest-model trace``) behind an in-process ``Router``.  A burst of
   routed predicts must leave at least one trace id whose spans live in
   both pids (``router.forward`` … ``router.attempt`` here,
   ``serve.request`` … ``serve.engine_run`` in the replica), every
   parent/child pair must nest (child interval ⊆ parent interval: both
   ends come from one wall clock, so this holds across processes), and
   every coalesced ``serve.execute`` span must link exactly the requests
   it served (``len(links)`` == its ``requests``).

B. feeding and training: one decode-worker subprocess feeding a
   synchronous ``FeedClient`` (``prefetch=0``: the fetch runs on the step
   loop's thread) that drives a fused trainer step.  The step's trace
   rotation (``set_current_trace`` in the fused step) must put
   ``train.step`` and the following ``feed.fetch`` → ``feed.http_fetch``
   → worker-side ``feed_worker.batch`` under one trace id across both
   pids, nested.

Both legs collect the remote shard by ``SIGUSR2`` (the flight recorder's
dump hook) with ``MXNET_TRACE_DIR``, then :mod:`.tracemerge` must make
valid Chrome trace-event JSON of the shards.

``python -m mxnet_tpu_torch.tracecheck [--device cpu] [--quiet]``.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

from . import telemetry as _telemetry
from . import tracemerge as _tracemerge

__all__ = ["_selfcheck"]

FEED_SPEC = "synthetic:8x3x16x16:10:64"
FED_STEPS = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_ready(port: int, timeout_s: float = 180.0, proc=None) -> bool:
    import http.client
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            return False
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
            c.request("GET", "/healthz")
            ok = c.getresponse().status == 200
            c.close()
            if ok:
                return True
        except OSError:
            pass
        time.sleep(0.25)
    return False


def _wait_shard(d: str, timeout_s: float = 30.0) -> bool:
    """Wait for the signalled subprocess to land its trace shard."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if any(f.endswith(".json") for f in os.listdir(d)):
            return True
        time.sleep(0.1)
    return False


def _sub_env(trace_dir: str, label: str) -> dict:
    env = dict(os.environ)
    for k in list(env):
        if k.startswith("DMLC_"):
            env.pop(k)
    # the subprocesses run inside the scratch directory (their SIGUSR2
    # diagnostic dumps land there): keep the package importable
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pp = env.get("PYTHONPATH")
    env["PYTHONPATH"] = repo + (os.pathsep + pp if pp else "")
    env.update({
        "MXNET_TELEMETRY_DUMP_ON_EXIT": "",
        "MXNET_TRACE": "1",
        "MXNET_TRACE_DIR": trace_dir,
        "MXNET_TRACE_LABEL": label,
    })
    return env


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


# ------------------------------------------------------------ analysis
def _spans(events):
    return [e for e in events if e.get("ph") == "X"]


def _traces(spans):
    """trace_id → its spans."""
    by = {}
    for s in spans:
        tid = (s.get("args") or {}).get("trace_id")
        if tid:
            by.setdefault(tid, []).append(s)
    return by


def _cross_process_traces(spans):
    """Trace ids whose spans live in two or more pids."""
    return {tid: ss for tid, ss in _traces(spans).items()
            if len({s["pid"] for s in ss}) >= 2}


def _nesting_violations(spans):
    """Parent/child pairs whose child interval escapes the parent's (both
    ends of every span come from ``time.time_ns()`` on one host, so this
    holds exactly, across pids too)."""
    by_sid = {}
    for s in spans:
        sid = (s.get("args") or {}).get("span_id")
        if sid:
            by_sid[sid] = s
    bad = []
    for s in spans:
        a = s.get("args") or {}
        p = by_sid.get(a.get("parent_id"))
        if p is None or a.get("trace_id") != (p.get("args") or {}) \
                .get("trace_id"):
            continue
        if s["ts"] < p["ts"] or \
                s["ts"] + s.get("dur", 0) > p["ts"] + p.get("dur", 0):
            bad.append((p["name"], s["name"],
                        s["ts"] - p["ts"],
                        (p["ts"] + p.get("dur", 0)) -
                        (s["ts"] + s.get("dur", 0))))
    return bad


def _bad_execute_links(spans):
    """``serve.execute`` spans whose links do not cover exactly the
    requests they coalesced (the ``requests`` attribute)."""
    bad = []
    for s in spans:
        if s["name"] != "serve.execute":
            continue
        a = s.get("args") or {}
        n_links = len(a.get("links") or [])
        if n_links != int(a.get("requests", -1)):
            bad.append((n_links, a.get("requests")))
    return bad


# ------------------------------------------------------------ leg A
def _leg_serve(tmp, verbose, device):
    from .serve.router import Router
    leg = os.path.join(tmp, "serve")
    rdir = os.path.join(leg, "replica0")
    os.makedirs(rdir, exist_ok=True)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.serve",
         "--selftest-model", "trace", "--host", "127.0.0.1",
         "--port", str(port), "--device", str(device)],
        env=_sub_env(rdir, "replica0"), cwd=tmp,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    statuses, shard_ok, ready = [], False, False
    try:
        ready = _wait_ready(port, proc=proc)
        if ready:
            _telemetry.trace_reset()
            body = json.dumps({"model": "trace",
                               "inputs": [0.5] * 64}).encode()
            with Router([f"127.0.0.1:{port}"], port=0) as router:
                for _ in range(4):
                    st, _hdrs, _payload = router.forward(body)
                    statuses.append(st)
            proc.send_signal(signal.SIGUSR2)
            shard_ok = _wait_shard(rdir)
            _telemetry.dump_trace(os.path.join(leg, "router.json"))
    finally:
        _stop(proc)
    if verbose:
        print(f"[trace-check] serve leg: ready={ready} "
              f"statuses={statuses} shard={shard_ok}", flush=True)
    return leg, {"ready": ready, "statuses": statuses,
                 "shard": shard_ok}


# ------------------------------------------------------------ leg B
def _dense_trainer(device):
    from . import seed
    from .gluon import Trainer, nn
    from .gluon.loss import SoftmaxCrossEntropyLoss
    seed(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(10))
    net.initialize(ctx=device)
    net.hybridize()
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05})
    return net, tr.fuse_step(SoftmaxCrossEntropyLoss())


def _leg_feed_train(tmp, verbose, device, trainer, spec, layout):
    import torch

    from .io.data_service import FeedClient

    leg = os.path.join(tmp, "feed")
    wdir = os.path.join(leg, "worker0")
    os.makedirs(wdir, exist_ok=True)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.io.data_service",
         "--worker", "--spec", spec, "--seed", "0",
         "--host", "127.0.0.1", "--port", str(port)],
        env=_sub_env(wdir, "feed-worker0"), cwd=tmp,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    steps, shard_ok, ready, step = 0, False, False, None
    try:
        ready = _wait_ready(port, proc=proc)
        if ready:
            _telemetry.trace_reset()
            _net, step = trainer if trainer is not None else \
                _dense_trainer(device)
            # prefetch=0: the fetch runs on the step loop's thread, so
            # the fetch after step N inherits step N's trace id: the
            # cross-process "what fed this step" join under test
            client = FeedClient(workers=[f"127.0.0.1:{port}"],
                                spec=spec, seed=0, prefetch=0,
                                retries=2, backoff_ms=10,
                                timeout_ms=5000)
            try:
                for _ in range(FED_STEPS):
                    d, lab, _pad = client.next_raw()
                    x = torch.from_numpy(d).to(device).float()
                    if layout == "NHWC":
                        x = x.permute(0, 2, 3, 1).contiguous()
                    y = torch.from_numpy(lab.reshape(-1)).to(
                        device, torch.int64)
                    loss = step(x, y)
                    float(loss.sum())   # step N done before N + 1
                    steps += 1
            finally:
                client.close()
            proc.send_signal(signal.SIGUSR2)
            shard_ok = _wait_shard(wdir)
            _telemetry.dump_trace(os.path.join(leg, "trainer.json"))
    finally:
        _stop(proc)
    if verbose:
        print(f"[trace-check] feed leg: ready={ready} steps={steps} "
              f"shard={shard_ok}", flush=True)
    return leg, {"ready": ready, "steps": steps, "shard": shard_ok,
                 "step": step}


# ------------------------------------------------------------ gate
def _selfcheck(verbose: bool = True, device=None, trainer=None,
               spec: str = FEED_SPEC, layout=None, result=None) -> int:
    """Both legs and the merge → 0 when every gate held.  ``device``
    places the replica and leg B's step (``"cpu"`` without a card);
    ``trainer`` is leg B's ``(net, fused_step)`` (default a Dense net
    on ``device``), fed ``spec``'s batches, transposed to NHWC on the
    device when ``layout="NHWC"``.  ``result``, a dict, receives the
    checks, the legs and the merged trace's path and span counts."""
    from .context import resolve
    device = resolve(device)
    os.environ["MXNET_TRACE"] = "1"
    _telemetry.set_trace_enabled(True)
    tmp = tempfile.mkdtemp(prefix="mxtpu-tracecheck-")

    leg_a, info_a = _leg_serve(tmp, verbose, device)
    ev_a = _tracemerge.merge_events([leg_a]) if info_a["shard"] else []
    sp_a = _spans(ev_a)
    cross_a = _cross_process_traces(sp_a)
    # the routed predict's trace: router-side and replica-side span names
    # under one id (forward() is driven in process here, so the router's
    # root is router.forward, not the HTTP router.request)
    routed = [tid for tid, ss in cross_a.items()
              if {"router.forward", "router.attempt",
                  "serve.request"} <= {s["name"] for s in ss}]
    nest_a = _nesting_violations(sp_a)
    links_a = _bad_execute_links(sp_a)
    n_exec = sum(1 for s in sp_a if s["name"] == "serve.execute")

    leg_b, info_b = _leg_feed_train(tmp, verbose, device, trainer, spec,
                                    layout)
    ev_b = _tracemerge.merge_events([leg_b]) if info_b["shard"] else []
    sp_b = _spans(ev_b)
    cross_b = _cross_process_traces(sp_b)
    # the fed step's trace: train.step here and feed_worker.batch in the
    # worker's pid under one step-scoped id
    fed = [tid for tid, ss in cross_b.items()
           if {"train.step", "feed.fetch", "feed.http_fetch",
               "feed_worker.batch"} <= {s["name"] for s in ss}]
    nest_b = _nesting_violations(sp_b)

    # the merge over both legs must be loadable Chrome trace JSON
    merged = os.path.join(tmp, "merged.json")
    merge_ok, merged_spans = False, 0
    try:
        _tracemerge.merge([leg_a, leg_b], merged, verbose=False)
        with open(merged) as f:
            data = json.load(f)
        evs = data.get("traceEvents")
        merged_spans = sum(1 for e in evs or []
                           if isinstance(e, dict) and e.get("ph") == "X")
        merge_ok = isinstance(evs, list) and merged_spans > 0 and \
            any(e.get("ph") == "M" and e.get("name") == "process_name"
                for e in evs)
    except Exception as e:  # noqa: BLE001 — a torn merge is a failure
        if verbose:
            print(f"[trace-check] merge failed: {e!r}", file=sys.stderr)

    checks = [
        ("replica served the routed burst",
         bool(info_a["ready"] and info_a["statuses"] and
              all(s == 200 for s in info_a["statuses"]))),
        ("replica shard collected via SIGUSR2", info_a["shard"]),
        ("routed predict: ≥1 trace id spans ≥2 processes",
         len(routed) >= 1),
        ("serve leg: every parent/child pair nests (child ⊆ parent)",
         bool(sp_a) and not nest_a),
        ("every serve.execute links == its member request count "
         f"({n_exec} execute spans)", n_exec >= 1 and not links_a),
        ("worker fed %d fused steps" % info_b["steps"],
         info_b["ready"] and info_b["steps"] >= FED_STEPS),
        ("worker shard collected via SIGUSR2", info_b["shard"]),
        ("fed step: one step-scoped trace id spans ≥2 processes "
         "(train.step + feed.fetch + feed.http_fetch + "
         "feed_worker.batch)", len(fed) >= 1),
        ("feed leg: every parent/child pair nests (child ⊆ parent)",
         bool(sp_b) and not nest_b),
        ("tracemerge → valid Chrome trace JSON "
         f"({merged_spans} spans)", merge_ok),
    ]
    ok = all(c for _, c in checks)
    if result is not None:
        result.update({
            "checks": [(n, bool(c)) for n, c in checks],
            "serve_leg": {k: v for k, v in info_a.items()},
            "feed_leg": {k: v for k, v in info_b.items() if k != "step"},
            "step": info_b["step"], "routed_traces": len(routed),
            "fed_traces": len(fed), "execute_spans": n_exec,
            "merged_spans": merged_spans, "merged": merged,
            "nesting_violations": len(nest_a) + len(nest_b)})
    if verbose:
        for name, c in checks:
            print(f"[trace-check] {'ok  ' if c else 'FAIL'} {name}")
        if nest_a or nest_b:
            for p, c, lo, hi in (nest_a + nest_b)[:5]:
                print(f"[trace-check]   escape: {c} ⊄ {p} "
                      f"(start+{lo}us end-{hi}us)", file=sys.stderr)
        if links_a:
            print(f"[trace-check]   bad links: {links_a[:5]}",
                  file=sys.stderr)
        print(f"[trace-check] shards under {tmp} "
              f"(merged: {merged})")
    if not ok:
        print("[trace-check] FAIL", file=sys.stderr)
        return 1
    print("[trace-check] OK")
    return 0


def _main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.tracecheck",
                                 description="the distributed-tracing gate")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: the current card)")
    args = ap.parse_args(argv)
    return _selfcheck(verbose=not args.quiet, device=args.device)


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
