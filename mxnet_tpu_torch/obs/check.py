"""The observability plane proved end to end on a real mini fleet (≙
``mxnet_tpu/obs/check.py``), nothing mocked:

* a **replica** subprocess (``python -m mxnet_tpu_torch.serve
  --selftest-model web``) and **decode worker** subprocesses (``python -m
  mxnet_tpu_torch.io.data_service --worker``), scraped over their
  ``/metrics``;
* an in-process **router** in front of the replica, carrying light
  open-loop predict traffic;
* an in-process **fused-step trainer** (this process, labeled
  ``trainer-rank0``) fed by the workers through ``FeedClient`` →
  ``DataFeed``, with the obs recorder sampling and the seeded watchdog
  armed.

Once the trainer runs steadily the gate injects a ``client:delay``
fault into the feed (the fault domain reads ``MXNET_FEED_FAULT`` on
every call, so setting it in this process is enough), asserts that the
``input_starved`` rule FIRES, removes the fault and asserts that the rule
CLEARS through its hysteresis.  While the fleet is still loaded,
``obs.fleet.scrape`` merges the replica's and the workers' ``/metrics``
with the trainer's recorder shard; the merged report must show every
role with non-zero rates and finite input-stall, goodput and MFU
signals.

:func:`check` takes the fleet's sizes (the feed's spec, the number of
workers, a prebuilt trainer); :func:`_check` runs it at the reference's
(one worker of ``synthetic:8x3x16x16:10:256``, a Dense trainer).  The
reference's delay is a fixed 150 ms; here it is sized from the measured
step (at least 150 ms), so the gate holds on a loaded host and at a
full-width step alike.  The fault starves in cycles: the
:data:`PREFETCH` fetches sleep together, so a cycle delivers that many
batches and then the trainer waits, for longer than the recorder's
window.  The recorder keeps its window throughout; its stall signal
counts the part of a wait still open in a window
(``obs.signals.WaitAccrual``), so every window inside a wait reads it.
``device`` places the replica, the feed and the default trainer
(``"cpu"`` for a machine without a card).

Every wait has a cap, and the caps add up to :data:`BUDGET_S`, so a
slow run fails at the gate whose wait ran out, with a ``[obs-check]
FAIL`` line that names it and the seconds it waited, well inside the
caller's time limit.
"""
from __future__ import annotations

import http.client
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

SPEC = "synthetic:8x3x16x16:10:256"
SEED = 7
LOG_TAIL = 3000         # bytes of each subprocess's log shown on a failure
STEADY = 8              # recorder windows that must look healthy in a row
QPS = 15.0              # the router's open-loop predict rate
INTERVAL_MS = 250.0     # the recorder's window
PACE_S = 0.01           # the trainer's pause between steps
PREFETCH = 4            # the feed client's fetches in flight
# the caps of the waits, in the order they run; their sum is the check's
# budget (the fleet's tests allow it 300 s with the interpreter's start)
READY_S = 90.0          # the subprocesses' import, card and warm-up
STEADY_S = 60.0         # the healthy steady state
FIRE_S = 45.0           # input_starved fires under the fault
CLEAR_S = 45.0          # and clears after it
SCRAPE_S = 10.0         # the fleet scrape (2.5 s) and the shard flushes
TEARDOWN_S = 15.0       # the subprocesses' exit and the threads' stop
BUDGET_S = READY_S + STEADY_S + FIRE_S + CLEAR_S + SCRAPE_S + TEARDOWN_S


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sub_env(label: str) -> dict:
    """A subprocess's environment: no launcher or fault state, its role
    label, telemetry on, the package importable."""
    env = dict(os.environ)
    for k in list(env):
        if k.startswith("DMLC_"):
            env.pop(k)
    pp = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _repo_root() + (os.pathsep + pp if pp else "")
    env.update({
        "MXNET_TRACE_LABEL": label,
        "MXNET_TELEMETRY": "1",
        "MXNET_TELEMETRY_DUMP_ON_EXIT": "",
        "MXNET_LOCK_CHECK": env.get("MXNET_LOCK_CHECK", "1"),
    })
    for k in ("MXNET_FEED_FAULT", "MXNET_SERVE_FAULT",
              "MXNET_OBS_INTERVAL_MS", "MXNET_OBS_DIR"):
        env.pop(k, None)
    return env


def _wait_ready(port: int, timeout_s: float = READY_S, proc=None) -> bool:
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


def _serve_load(router, stop_evt: threading.Event):
    """Light open-loop predict traffic, so the serving tier has request
    rates for the goodput signal."""
    import numpy as onp
    rs = onp.random.RandomState(0)
    period = 1.0 / QPS
    while not stop_evt.is_set():
        body = json.dumps(
            {"model": "web",
             "inputs": rs.randn(64).astype("float32").tolist()}).encode()
        try:
            router.forward(body)
        except Exception:
            pass                     # replica hiccups are not the gate
        stop_evt.wait(period)


def _train_loop(feed, step, flatten, stop_evt: threading.Event,
                errs: list, steps: list):
    """Consume the feed through the fused step until told to stop: the
    ``datafeed.wait_us`` / ``fused.step_us`` ratio is the stall
    signal."""
    import torch
    try:
        while not stop_evt.is_set():
            try:
                b = next(feed)
            except StopIteration:
                feed.reset()         # epoch rollover
                continue
            x = b.data[0]
            if flatten:
                x = x.reshape(x.shape[0], -1)
            y = b.label[0].reshape(-1).to(torch.int64)
            step(x, y)
            steps[0] += 1
            # pace the consumer below the feed's throughput: a healthy
            # baseline must not be input-bound
            stop_evt.wait(PACE_S)
        step.sync()
    except Exception as e:           # surfaced as a gate failure
        errs.append(e)


def _poll(predicate, timeout_s: float, interval_s: float = 0.2) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


def _dense_trainer(device):
    """The reference gate's trainer: Dense(16, relu) → Dense(10), SGD
    lr 0.05, fused."""
    from ..gluon import Trainer, nn
    from ..gluon.loss import SoftmaxCrossEntropyLoss
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(10))
    net.initialize(ctx=device)
    net.hybridize()
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.05})
    return net, tr.fuse_step(SoftmaxCrossEntropyLoss())


def _signal_between(frames, key, t0, t1):
    """Mean of signal ``key`` over the frames sampled in [t0, t1)."""
    vals = [f["signals"][key] for f in frames
            if t0 <= f["mono"] < t1 and key in f.get("signals", {})]
    return sum(vals) / len(vals) if vals else None


def _starved_for_s() -> float:
    """``input_starved``'s ``for_s``: how long its breach must last."""
    from .rules import seeded_rules
    return next(r.for_s for r in seeded_rules() if r.name == "input_starved")


def _fault_delay_ms(period_ms: float, fetch_ms: float) -> float:
    """The ``client:delay`` that starves the measured step.  The
    :data:`PREFETCH` fetches in flight sleep the delay together, so a
    cycle of ``delay + fetch`` ms delivers that many batches, which the
    trainer takes a step period apart, and then it waits for the next
    cycle.  The wait is set to outlast ``input_starved``'s ``for_s`` by two
    recorder windows, and by one more burst of steps against a step that
    slows under the fault: a window that falls among the steps of a
    burst longer than the window reads no stall and restarts the rule's
    clock, so the rule must be able to fire within one wait.  At least
    the reference's 150 ms."""
    burst_ms = PREFETCH * period_ms
    wait_ms = 1e3 * _starved_for_s() + 2 * INTERVAL_MS + burst_ms
    return float(max(150.0, round(burst_ms + wait_ms - fetch_ms)))


def _timeline(frames):
    """Each recorder window as [mono s, steps/s, input_stall_frac, step
    p50 µs, feed wait p50 µs, fetch p50 µs]."""
    out = []
    for f in frames:
        sig, q = f.get("signals", {}), f.get("quantiles", {})
        out.append([round(f["mono"], 3), sig.get("steps_per_s"),
                    sig.get("input_stall_frac"), sig.get("step_p50_us"),
                    q.get("datafeed.wait_us", {}).get("p50_us"),
                    q.get("feed_service.fetch_us", {}).get("p50_us")])
    return out


def check(verbose: bool = True, device=None, spec: str = SPEC,
          workers: int = 1, trainer=None, layout=None) -> dict:
    """Bring the mini fleet up, drive the fault cycle, merge the fleet
    and gate it → a dict: ``failures`` (the names of the failed gates,
    empty when all held), ``checks``, the merged ``report``, the
    watchdog's ``events``, ``fault_ms`` (the injected delay,
    :func:`_fault_delay_ms`), the mean ``input_stall_frac``
    before, under and after the fault (``stall``), the baseline's step
    (``step_ms`` from the step rate, ``step_p50_ms``) and ``mfu``,
    ``goodput``, the recorder's ``frames`` and ``dropped_frames``, the
    feed client's ``feed_stats``, and the recorder's windows
    (``timeline``, :func:`_timeline`) with the fault's ``marks``.

    ``trainer`` is ``(net, fused_step)``, not yet called (so its build
    publishes the model's FLOPs into the running recorder); default the
    reference's Dense trainer on ``device``.  ``layout="NHWC"`` has the
    feed transpose the images on the device (the zoo's nets); without it
    each image is flattened for a Dense trainer."""
    os.environ["MXNET_TELEMETRY"] = "1"
    os.environ["MXNET_TRACE_LABEL"] = "trainer-rank0"
    # the MFU constant: small by default, so the toy model's utilization
    # is finite and non-zero on the CPU
    os.environ.setdefault("MXNET_OBS_PEAK_FLOPS", "1e9")
    os.environ.pop("MXNET_FEED_FAULT", None)

    from .. import telemetry as _telemetry
    from ..context import resolve
    from ..io.data_service import FeedClient
    from ..io.datafeed import DataFeed
    from ..serve.router import Router
    from . import fleet as _fleet
    from . import recorder as _recorder

    _telemetry.set_enabled(True)
    dev = resolve(device)
    obs_dir = tempfile.mkdtemp(prefix="mxtpu-obs-check-")
    procs, logs, checks = [], [], []
    stop_evt = threading.Event()
    train_errs: list = []
    steps = [0]
    rec = router = client = feed = None
    out = {"fault_ms": None, "stall": {}}

    def note(name, ok, detail=""):
        checks.append((name, bool(ok), detail))
        if verbose:
            print(f"[obs-check] {'ok  ' if ok else 'FAIL'} {name}"
                  + (f" — {detail}" if detail else ""), flush=True)

    def waited(t0, cap):
        return f"{time.monotonic() - t0:.1f} s of {cap:g}"

    def spawn(label, argv):
        log = os.path.join(obs_dir, f"{label}.log")
        logs.append(log)
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", *argv], env=_sub_env(label),
                cwd=obs_dir, stdout=fh, stderr=subprocess.STDOUT))
        return procs[-1]

    try:
        # ------------------------------------------------ fleet bring-up
        rport = _free_port()
        fports = [_free_port() for _ in range(workers)]
        rproc = spawn("serve0", [
            "mxnet_tpu_torch.serve", "--selftest-model", "web",
            "--host", "127.0.0.1", "--port", str(rport),
            "--device", str(dev)])
        wprocs = [spawn(f"feed-worker{i}", [
            "mxnet_tpu_torch.io.data_service", "--worker", "--spec",
            spec, "--seed", str(SEED), "--host", "127.0.0.1",
            "--port", str(p)]) for i, p in enumerate(fports)]
        # the subprocesses start together and share one deadline
        t_up = time.monotonic()
        note("replica ready", _wait_ready(rport, READY_S, rproc),
             f"port {rport}, {waited(t_up, READY_S)}")
        for p, w in zip(fports, wprocs):
            left = max(READY_S - (time.monotonic() - t_up), 0.0)
            note("feed worker ready", _wait_ready(p, left, w),
                 f"port {p}, {waited(t_up, READY_S)}")
        if not all(ok for _, ok, _ in checks):
            return out

        router = Router([f"127.0.0.1:{rport}"], port=_free_port(),
                        probe_interval_ms=200.0).start()

        # recorder and watchdog armed before the first step, so the
        # step's build publishes the model's FLOPs into a live ring; a
        # window must hold a step even under the fault, or the stall
        # signal goes missing and the rule's clock resets
        rec = _recorder.start(interval_ms=INTERVAL_MS, out_dir=obs_dir)
        note("recorder running", rec is not None and rec.running())
        engine = rec.engine

        client = FeedClient(workers=[f"127.0.0.1:{p}" for p in fports],
                            spec=spec, seed=SEED, prefetch=4, retries=4,
                            timeout_ms=5000)
        feed = DataFeed(client, depth=4, device=dev, layout=layout)
        if trainer is None:
            trainer = _dense_trainer(dev)
        _net, step = trainer

        threading.Thread(target=_serve_load, args=(router, stop_evt),
                         daemon=True, name="obs-check-load").start()
        threading.Thread(target=_train_loop,
                         args=(feed, step, layout is None, stop_evt,
                               train_errs, steps),
                         daemon=True, name="obs-check-train").start()

        def _events(since=0):
            return [(e["rule"], e["event"]) for e in engine.events[since:]]

        def _steady():
            fs = [f.get("signals", {}) for f in rec.frames()[-STEADY:]]
            return (len(fs) == STEADY and
                    all(g.get("steps_per_s", 0) > 0 and
                        g.get("input_stall_frac", 0.0) < 0.25
                        for g in fs) and
                    "input_starved" not in engine.firing())

        # healthy steady state: steps and no stall in every recent
        # window, the rule not firing (the first steps may stall while
        # the ring fills)
        t_st = time.monotonic()
        steady = _poll(_steady, STEADY_S)
        note("steady state reached", steady,
             f"steps={steps[0]}, {waited(t_st, STEADY_S)}")
        if not steady:
            return out
        t_base = time.monotonic()
        _poll(lambda: False, 4 * INTERVAL_MS / 1e3)
        t_on = time.monotonic()
        note("watchdog quiet before the fault",
             "input_starved" not in engine.firing(), f"{_events()}")
        frames = [f for f in rec.frames() if f["mono"] >= t_base]
        base = [f.get("signals", {}) for f in frames]
        rate = [g["steps_per_s"] for g in base if "steps_per_s" in g]
        fetch = [q["p50_us"] for f in frames for q in
                 [f.get("quantiles", {}).get("feed_service.fetch_us", {})]
                 if q.get("p50_us") is not None]
        p50 = sorted(g["step_p50_us"] for g in base if "step_p50_us" in g)
        mfu = sorted(g["mfu"] for g in base if "mfu" in g)
        out.update({
            "step_ms": 1e3 * len(rate) / sum(rate) if rate and sum(rate)
            else None,
            "step_p50_ms": p50[len(p50) // 2] / 1e3 if p50 else None,
            "mfu": mfu[len(mfu) // 2] if mfu else None})
        fetch_ms = sum(fetch) / len(fetch) / 1e3 if fetch else 0.0
        fault_ms = out["fault_ms"] = _fault_delay_ms(
            out["step_ms"] or 30.0, fetch_ms)
        out["stall"]["before"] = _signal_between(rec.frames(),
                                                 "input_stall_frac",
                                                 t_base, t_on)

        # ------------------------------- fault: a delay on every fetch
        n_ev = len(engine.events)
        os.environ["MXNET_FEED_FAULT"] = f"client:delay:1.0:{fault_ms:g}"
        fired = _poll(
            lambda: ("input_starved", "firing") in _events(n_ev), FIRE_S)
        note("input_starved fires under feed fault", fired,
             f"delay {fault_ms:g} ms, {waited(t_on, FIRE_S)}, "
             f"events={_events(n_ev)}")

        # ------------------------------------ clear: hysteresis release
        os.environ.pop("MXNET_FEED_FAULT", None)
        t_off = time.monotonic()
        cleared = _poll(
            lambda: ("input_starved", "cleared") in _events(n_ev), CLEAR_S)
        t_clear = time.monotonic()
        note("input_starved clears after fault removed", cleared,
             f"{waited(t_off, CLEAR_S)}, events={_events(n_ev)}")
        kinds = _events(n_ev)
        note("watchdog logged firing→cleared transition",
             fired and cleared
             and kinds.index(("input_starved", "firing"))
             < kinds.index(("input_starved", "cleared")), f"{kinds}")
        out["stall"]["fault"] = _signal_between(rec.frames(),
                                                "input_stall_frac",
                                                t_on, t_off)
        snap = _telemetry.raw_snapshot()["counters"]
        note("obs.alerts.input_starved counted",
             snap.get("obs.alerts.input_starved", 0) >= 1)

        # -------------------------- merge the fleet while still loaded
        t_scrape = time.monotonic()
        rec.flush()
        targets = [f"serve@127.0.0.1:{rport}"] + [
            f"feed.{i}@127.0.0.1:{p}" for i, p in enumerate(fports)]
        timeline = _fleet.scrape(targets, shards_dir=obs_dir,
                                 interval_ms=400.0, duration_s=2.5)
        rec.flush()      # frames that landed during the scrape too
        timeline["frames"].extend(
            f for f in _fleet.read_shards(obs_dir)
            if f["t"] > max((x["t"] for x in timeline["frames"]
                             if x.get("source") == "shard"),
                            default=0.0))
        report = _fleet.build_report(timeline)
        out["report"] = report
        if verbose:
            sys.stdout.write(_fleet.render_report(report))
        frames = rec.frames()
        out["stall"]["after"] = _signal_between(frames, "input_stall_frac",
                                                t_clear, t_scrape + 10.0)

        roles = report["roles"]
        for role in ("serve", "feed", "trainer"):
            note(f"role {role} merged with non-zero rates",
                 roles.get(role, {}).get("nonzero_rates", 0) > 0,
                 f"{roles.get(role)}")
        sig = report["signals"]
        for name in ("input_stall_frac", "goodput", "mfu"):
            v = sig.get(name)
            note(f"signal {name} present and finite",
                 v is not None and math.isfinite(v), f"{name}={v}")
        note("mfu non-zero", bool(sig.get("mfu", 0.0) > 0.0),
             f"mfu={sig.get('mfu')}")
        note("trainer thread healthy", not train_errs,
             f"{train_errs[:1]}")
        out.update({
            "marks": {"base": t_base, "fault_on": t_on,
                      "fault_off": t_off, "cleared": t_clear},
            "goodput": sig.get("goodput"), "signals": sig,
            "events": list(engine.events[n_ev:]),
            "frames": len(frames),
            "dropped_frames": rec.state()["dropped_frames"],
            "train_steps": steps[0], "feed_stats": client.stats(),
            "seconds": {"fault_on_to_clear": t_clear - t_on}})
        return out
    finally:
        stop_evt.set()
        os.environ.pop("MXNET_FEED_FAULT", None)
        if rec is not None:
            out["timeline"] = _timeline(rec.frames())
        out["failures"] = [n for n, ok, _ in checks if not ok] or \
            ([] if checks else ["fleet did not start"])
        out["checks"] = checks
        for fn in ((lambda: _recorder.stop()) if rec is not None else None,
                   feed.close if feed is not None else None,
                   client.close if client is not None else None,
                   router.stop if router is not None else None):
            if fn is not None:
                try:
                    fn()
                except Exception:
                    pass
        for p in procs:
            try:
                p.terminate()
            except Exception:
                pass
        t_end = time.monotonic() + TEARDOWN_S / 2
        for p in procs:
            try:
                p.wait(max(t_end - time.monotonic(), 0.1))
            except Exception:
                try:
                    p.kill()
                    p.wait(5)
                except Exception:
                    pass
        if out["failures"] and verbose:
            for log in logs:
                try:
                    with open(log) as f:
                        tail = f.read()[-LOG_TAIL:]
                except OSError:
                    continue
                print(f"[obs-check] --- {os.path.basename(log)} ---\n{tail}",
                      file=sys.stderr)
        shutil.rmtree(obs_dir, ignore_errors=True)


def _check(verbose: bool = True, device=None) -> int:
    """The reference's gate at its sizes → 0 when every gate held."""
    return 1 if check(verbose=verbose, device=device)["failures"] else 0


def _main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.obs",
        description="the mini-fleet observability gate")
    ap.add_argument("--check", action="store_true",
                    help="run the mini-fleet observability gate")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: the current card)")
    args = ap.parse_args(argv)
    if not args.check:
        ap.error("nothing to do (want --check)")
    rc = _check(verbose=not args.quiet, device=args.device)
    print(f"[obs-check] {'OK' if rc == 0 else 'FAIL'}")
    return rc
