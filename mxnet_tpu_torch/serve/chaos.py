"""Chaos harness — prove the serving resilience plane against a real
replica kill, and price the router's scaling (≙
``mxnet_tpu/serve/chaos.py``).

``python -m mxnet_tpu_torch.serve.chaos --check`` runs three legs on one
host, everything subprocess-real:

1. **QPS, 1 replica** — open-loop load through a Router fronting one
   replica.
2. **QPS, 2 replicas** — the same offered load through a Router fronting
   both; the aggregate must reach ≥ 1.5× leg 1.  Replica service time
   is made sleep-bound (``MXNET_SERVE_FAULT=batcher:delay:1.0:<ms>`` + a
   single-bucket ladder) so the scaling is measurable on a shared host.
3. **Kill/relaunch** — open-loop load below one replica's capacity while
   one replica is SIGKILLed mid-stream; ``supervise_respawn``
   (supervise.py, per-worker respawn) relaunches it, and the leg then
   trickles requests until the relaunched replica's breaker closes
   again.  The contract: zero client-visible failures across the leg
   and the breaker observed open → half-open → closed in the router's
   own telemetry.

The replicas are ``python -m mxnet_tpu_torch.serve --selftest-model web``
processes (the seeded bench mlp) on pre-picked ports, so a relaunch
lands where the router expects; they run on the card (``--device cpu``
or ``resilience_bench(device="cpu")`` keeps them on the CPU) under the
lock-order watchdog (``MXNET_LOCK_CHECK``).

Knobs (env, all optional): ``BENCH_CHAOS_QPS`` (offered load for the
scaling legs, default 90), ``BENCH_CHAOS_S`` (seconds per scaling leg,
default 4), ``BENCH_CHAOS_DELAY_MS`` (synthetic per-item service time,
default 20), ``BENCH_CHAOS_KILL_QPS`` (kill-leg load, default 30).
"""
from __future__ import annotations

import http.client
import json
import os
import socket
import sys
import threading
import time
from typing import List, Optional

from .. import telemetry as _telemetry

__all__ = ["resilience_bench"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _replica_env(delay_ms: float) -> dict:
    env = dict(os.environ)
    # scrub inherited dist/test state
    for k in list(env):
        if k.startswith("DMLC_"):
            env.pop(k)
    # the replicas import this package from the checkout it runs from
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    env.update({
        # single-bucket ladder + injected per-batch delay: service time
        # is sleep-bound, so N replicas really do N× the throughput of
        # one even on a single core
        "MXNET_SERVE_BUCKETS": "1",
        "MXNET_SERVE_FAULT": f"batcher:delay:1.0:{delay_ms:g}",
        "MXNET_TELEMETRY_DUMP_ON_EXIT": "",
        # every chaos replica runs under the lock-order watchdog: an
        # ABBA inversion forming anywhere in the serving plane kills
        # the replica loudly instead of deadlocking the gate
        "MXNET_LOCK_CHECK": env.get("MXNET_LOCK_CHECK", "1"),
    })
    return env


def _spawn_replica_cmd(port: int, device=None) -> List[str]:
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.serve",
           "--selftest-model", "web", "--host", "127.0.0.1",
           "--port", str(port)]
    if device is not None:
        cmd += ["--device", str(device)]
    return cmd


def _wait_ready(port: int, timeout_s: float = 120.0) -> bool:
    """Poll a replica's readiness-aware /healthz until 200."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
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


def _drain_quiet(port: int, timeout_s: float = 30.0):
    """Wait until a replica's queue is empty (between legs, so one
    leg's backlog can't pollute the next leg's numbers)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
            c.request("GET", "/metrics")
            text = c.getresponse().read().decode("utf-8", "replace")
            c.close()
            depth = 0.0
            for line in text.splitlines():
                if line.startswith("mxtpu_serve_queue_depth "):
                    depth = float(line.split()[-1])
            if depth <= 0.0:
                return
        except OSError:
            return
        time.sleep(0.2)


def _open_loop(router, qps: float, duration_s: float,
               rs=None) -> List[dict]:
    """Open-loop load: arrivals on a fixed clock, each request on its
    own thread (a slow fleet must NOT throttle its own offered load —
    same discipline as serve/bench.py).  Returns one slot per issued
    request: {"status", "lat_s", "t0"}."""
    import numpy as onp
    rs = rs or onp.random.RandomState(0)
    slots: List[dict] = []
    threads: List[threading.Thread] = []
    period = 1.0 / qps
    t_next = time.perf_counter()
    end = t_next + duration_s

    def _one(slot, body):
        t0 = time.perf_counter()
        try:
            st, _, _ = router.forward(body)
        except Exception:   # noqa: BLE001 — a crash IS the measurement
            st = -1
        slot["status"] = st
        slot["lat_s"] = time.perf_counter() - t0
        slot["t0"] = t0

    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if now < t_next:
            time.sleep(min(t_next - now, 0.002))
            continue
        t_next += period
        body = json.dumps(
            {"model": "web",
             "inputs": rs.randn(64).astype("float32").tolist()}).encode()
        slot: dict = {}
        th = threading.Thread(target=_one, args=(slot, body),
                              daemon=True)
        th.start()
        slots.append(slot)
        threads.append(th)
    for th in threads:
        th.join(60.0)
    return slots


def _p99_ms(slots: List[dict]) -> Optional[float]:
    lats = sorted(s["lat_s"] for s in slots
                  if s.get("status") == 200)
    if not lats:
        return None
    return round(lats[min(len(lats) - 1,
                          int(0.99 * len(lats)))] * 1e3, 1)


def _tally(slots: List[dict]) -> dict:
    done = [s for s in slots if "status" in s]
    ok = sum(1 for s in done if s["status"] == 200)
    shed = sum(1 for s in done if s["status"] in (429, 503))
    fail = len(done) - ok - shed + (len(slots) - len(done))
    return {"issued": len(slots), "ok": ok, "shed": shed,
            "failures": fail}


def _router_counters() -> dict:
    snap = _telemetry.raw_snapshot().get("counters", {})
    return {k: v for k, v in snap.items() if k.startswith("router.")}


def resilience_bench(verbose: bool = True, device=None) -> dict:
    """The three chaos legs; returns the serving_resilience bench row.
    The replicas run on the card unless ``device="cpu"``."""
    import subprocess

    from .router import Router
    from .supervise import supervise_respawn

    qps = _env_float("BENCH_CHAOS_QPS", 90.0)
    leg_s = _env_float("BENCH_CHAOS_S", 4.0)
    delay_ms = _env_float("BENCH_CHAOS_DELAY_MS", 20.0)
    kill_qps = _env_float("BENCH_CHAOS_KILL_QPS", 30.0)

    def log(msg):
        if verbose:
            print(f"[chaos] {msg}", file=sys.stderr)

    ports = [_free_port(), _free_port()]
    env = _replica_env(delay_ms)
    stop = threading.Event()
    procs: List = [None, None]
    respawns = [0]

    def spawn(rank, attempt):
        return subprocess.Popen(_spawn_replica_cmd(ports[rank], device),
                                env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)

    def on_respawn(rank, attempt, rc):
        respawns[0] += 1

    sup_rc = [None]

    def _supervise():
        sup_rc[0] = supervise_respawn(
            spawn, 2, restarts=2, stop=stop, on_respawn=on_respawn,
            procs_out=procs)

    sup = threading.Thread(target=_supervise, name="chaos-supervisor",
                           daemon=True)
    sup.start()
    out: dict = {"qps_offered": qps, "leg_s": leg_s,
                 "delay_ms": delay_ms, "kill_qps": kill_qps}
    try:
        log(f"waiting for 2 replicas on ports {ports} ...")
        t0 = time.perf_counter()
        if not all(_wait_ready(p) for p in ports):
            out["error"] = "replicas never became ready"
            return out
        log(f"replicas ready in {time.perf_counter() - t0:.1f}s")
        _telemetry.reset()

        # ---- leg 1: one replica ------------------------------------
        with Router([f"127.0.0.1:{ports[0]}"], port=0,
                    probe_interval_ms=250) as r1:
            slots = _open_loop(r1, qps, leg_s)
        t1 = _tally(slots)
        served_s = max(s.get("t0", 0) + s.get("lat_s", 0)
                       for s in slots) - min(s.get("t0", 1e18)
                                             for s in slots)
        out["qps_1replica"] = round(t1["ok"] / max(served_s, 1e-9), 1)
        out["p99_ms_1replica"] = _p99_ms(slots)
        out["leg1"] = t1
        log(f"leg1 (1 replica): {out['qps_1replica']} qps ok "
            f"p99={out['p99_ms_1replica']}ms {t1}")
        _drain_quiet(ports[0])

        # ---- leg 2: two replicas -----------------------------------
        with Router([f"127.0.0.1:{p}" for p in ports], port=0,
                    probe_interval_ms=250) as r2:
            slots = _open_loop(r2, qps, leg_s)
        t2 = _tally(slots)
        served_s = max(s.get("t0", 0) + s.get("lat_s", 0)
                       for s in slots) - min(s.get("t0", 1e18)
                                             for s in slots)
        out["qps_2replica"] = round(t2["ok"] / max(served_s, 1e-9), 1)
        out["p99_ms_2replica"] = _p99_ms(slots)
        out["leg2"] = t2
        out["qps_ratio"] = round(
            out["qps_2replica"] / max(out["qps_1replica"], 1e-9), 2)
        log(f"leg2 (2 replicas): {out['qps_2replica']} qps ok "
            f"p99={out['p99_ms_2replica']}ms ratio={out['qps_ratio']} "
            f"{t2}")
        for p in ports:
            _drain_quiet(p)

        # ---- leg 3: SIGKILL + relaunch under load ------------------
        _telemetry.reset()
        router = Router([f"127.0.0.1:{p}" for p in ports], port=0,
                        probe_interval_ms=400, unhealthy_after=2,
                        breaker_fails=2, cooldown_ms=500,
                        retries=4, backoff_ms=25,
                        timeout_ms=10000).start()
        kill_note: dict = {}

        def _killer():
            time.sleep(1.5)
            victim = procs[1]
            if victim is not None:
                kill_note["t_kill"] = time.perf_counter()
                victim.kill()           # SIGKILL, mid-stream
                log(f"SIGKILLed replica on port {ports[1]}")

        killer = threading.Thread(target=_killer, daemon=True)
        killer.start()
        slots = _open_loop(router, kill_qps, leg_s + 2.0)
        killer.join(10.0)
        t3 = _tally(slots)

        # trickle until the relaunched replica's breaker closes again
        closed = False
        trickle: List[dict] = []
        deadline = time.monotonic() + 150.0
        ready_again = False
        while time.monotonic() < deadline:
            if not ready_again:
                ready_again = _wait_ready(ports[1], timeout_s=1.0)
            trickle += _open_loop(router, 5.0, 1.0)
            c = _router_counters()
            if c.get("router.breaker_close", 0) >= 1:
                closed = True
                break
        t3t = _tally(trickle)
        counters = _router_counters()
        router.stop()

        t_kill = kill_note.get("t_kill")
        pre = [s for s in slots if s.get("t0", 0) < (t_kill or 1e18)]
        post = [s for s in slots
                if t_kill is not None and s.get("t0", 0) >= t_kill
                and s.get("t0", 0) < t_kill + 3.0]
        out["kill"] = {
            "load": t3, "trickle": t3t,
            "failures": t3["failures"] + t3t["failures"],
            "shed": t3["shed"] + t3t["shed"],
            "p99_ms_before_kill": _p99_ms(pre),
            "p99_ms_kill_window": _p99_ms(post),
            "respawns": respawns[0],
            "breaker_open": int(counters.get("router.breaker_open", 0)),
            "breaker_half_open": int(
                counters.get("router.breaker_half_open", 0)),
            "breaker_close": int(counters.get("router.breaker_close", 0)),
            "ejections": int(counters.get("router.ejections", 0)),
            "reinstatements": int(
                counters.get("router.reinstatements", 0)),
            "retries": int(counters.get("router.retries", 0)),
        }
        log(f"leg3 (kill/relaunch): {out['kill']}")

        checks = {
            "zero_client_visible_failures": out["kill"]["failures"] == 0,
            "breaker_cycle_observed": (
                out["kill"]["breaker_open"] >= 1
                and out["kill"]["breaker_half_open"] >= 1
                and closed),
            "replica_respawned": respawns[0] >= 1,
            "qps_scaling_ge_1p5": (out.get("qps_ratio") or 0) >= 1.5,
        }
        out["checks"] = checks
        out["ok"] = all(checks.values())
        return out
    finally:
        stop.set()
        sup.join(15.0)


def _main(argv):
    device = None
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    row = resilience_bench(verbose=True, device=device)
    print(json.dumps(row, indent=2))
    if "--check" in argv:
        if not row.get("ok"):
            print(f"[chaos-check] FAIL "
                  f"checks={row.get('checks')}", file=sys.stderr)
            return 1
        print("[chaos-check] OK")
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
