"""mx.profiler — chrome-trace profiling (≙ ``mxnet_tpu/profiler.py``).

Host-side scoped ``Task`` / ``Marker`` / ``Counter`` events are collected
into the reference's chrome://tracing JSON (``dump``) and aggregated by
``dumps``.  Where the reference also starts ``jax.profiler``'s device
trace into ``set_config(tensorboard_dir=...)``, the port runs
``torch.profiler`` (CPU and, with a card, CUDA activity) from ``start``
to ``stop`` and exports its chrome trace into that directory as
``trace_<pid>.json``.  ``MXNET_PROFILER_AUTOSTART=1`` profiles the whole
process and dumps to ``MXNET_PROFILER_FILENAME`` (default
``profile.json``) at exit.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

__all__ = ["set_config", "start", "stop", "pause", "resume", "dump", "dumps",
           "Task", "Marker", "Counter", "scope"]

_config = {"filename": "profile.json", "profile_all": False}
_events: List[dict] = []
_lock = threading.Lock()
_active = False
_torch_prof = None
_torch_trace_dir: Optional[str] = None


def set_config(**kwargs):
    _config.update(kwargs)


def start(profile_process="worker"):
    global _active, _torch_prof, _torch_trace_dir
    _active = True
    trace_dir = _config.get("tensorboard_dir")
    if trace_dir and _torch_prof is None:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        _torch_prof = torch.profiler.profile(activities=acts)
        _torch_prof.__enter__()
        _torch_trace_dir = trace_dir


def stop():
    """Stop recording; a device trace started by :func:`start` is
    exported to ``<tensorboard_dir>/trace_<pid>.json``."""
    global _active, _torch_prof, _torch_trace_dir
    _active = False
    if _torch_prof is not None:
        prof, _torch_prof = _torch_prof, None
        prof.__exit__(None, None, None)
        os.makedirs(_torch_trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(_torch_trace_dir, f"trace_{os.getpid()}.json"))
        _torch_trace_dir = None


def pause():
    global _active
    _active = False


def resume():
    global _active
    _active = True


def _emit(name, ph, cat="host", ts=None, dur=None, args=None):
    ev = {"name": name, "ph": ph, "cat": cat, "pid": 0,
          "tid": threading.get_ident() % 10000,
          "ts": (ts if ts is not None else time.perf_counter_ns() / 1000)}
    if dur is not None:
        ev["dur"] = dur
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)


def dump(finished=True, path=None):
    path = path or _config.get("filename", "profile.json")
    with _lock:
        data = {"traceEvents": list(_events)}
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def dumps(reset=False, format="table"):
    with _lock:
        by_name = {}
        counters = {}
        for e in _events:
            if e.get("dur") is not None:
                d = e["dur"]
                s = by_name.setdefault(e["name"],
                                       [0, 0.0, float("inf"), 0.0])
                s[0] += 1
                s[1] += d
                s[2] = d if d < s[2] else s[2]
                s[3] = d if d > s[3] else s[3]
            elif e.get("ph") == "C":
                c = counters.setdefault(e["name"], [0, 0])
                c[0] += 1
                c[1] = (e.get("args") or {}).get("value", 0)
        if reset:
            _events.clear()
    # the reference's aggregate table: Count/Total plus Min/Max/Avg a name
    lines = [f"{'Name':<40}{'Count':>8}{'Total(us)':>14}{'Min(us)':>12}"
             f"{'Max(us)':>12}{'Avg(us)':>12}"]
    for name, (cnt, tot, mn, mx) in sorted(by_name.items(),
                                           key=lambda kv: -kv[1][1]):
        avg = tot / cnt if cnt else 0.0
        lines.append(f"{name:<40}{cnt:>8}{tot:>14.1f}{mn:>12.1f}"
                     f"{mx:>12.1f}{avg:>12.1f}")
    # counters (ph "C", e.g. the DataFeed gauges) get their own section:
    # a gauge's latest value is the signal, not a sum of its samples
    if counters:
        lines.append("")
        lines.append(f"{'Counter':<40}{'Updates':>8}{'Last':>14}")
        for name, (cnt, last) in sorted(counters.items()):
            lines.append(f"{name:<40}{cnt:>8}{last:>14}")
    return "\n".join(lines)


class Task:
    """Scoped named event ≙ profiler.Task."""

    def __init__(self, name, domain=None):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter_ns() / 1000

    def stop(self):
        if self._t0 is not None and _active:
            _emit(self.name, "X", ts=self._t0,
                  dur=time.perf_counter_ns() / 1000 - self._t0)
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class Marker:
    def __init__(self, name, domain=None):
        self.name = name

    def mark(self, scope="process"):
        if _active:
            _emit(self.name, "i")


class Counter:
    def __init__(self, name, domain=None, value=0):
        self.name = name
        self.value = value
        # increment/decrement read-modify-write self.value from several
        # threads: the update is under a lock
        self._mu = threading.Lock()

    def set_value(self, v):
        with self._mu:
            self.value = v
        if _active:
            _emit(self.name, "C", args={"value": v})

    def increment(self, delta=1):
        with self._mu:
            self.value = v = self.value + delta
        if _active:
            _emit(self.name, "C", args={"value": v})

    def decrement(self, delta=1):
        with self._mu:
            self.value = v = self.value - delta
        if _active:
            _emit(self.name, "C", args={"value": v})

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


def scope(name):
    return Task(name)


# ------------------------------------------------------------- autostart
def _maybe_autostart():
    """MXNET_PROFILER_AUTOSTART: profile the whole process without
    touching user code — start at import, dump the chrome trace at exit
    to MXNET_PROFILER_FILENAME (default profile.json)."""
    import atexit
    if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") not in ("1", "true"):
        return
    set_config(filename=os.environ.get("MXNET_PROFILER_FILENAME",
                                       _config["filename"]),
               profile_all=True)
    start()

    def _finish():
        try:
            stop()
            dump()
        except Exception:
            pass

    atexit.register(_finish)


_maybe_autostart()
