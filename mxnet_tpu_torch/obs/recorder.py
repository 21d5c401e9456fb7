"""Time-series recorder over the telemetry registry (≙
``mxnet_tpu/obs/recorder.py``).

A daemon sampler thread (``MXNET_OBS_INTERVAL_MS``, default off)
snapshots the registry into a bounded ring of ``(t, snapshot)`` frames.
Each frame carries the raw counters, gauges and histograms plus two
derivations:

* **counter → rate**: per-second deltas against the previous frame (a
  negative delta, a ``telemetry.reset()``, yields no rate);
* **histogram → delta quantile**: the bucket-count delta between two
  frames is a histogram of that window's observations alone, so
  ``quantile_from_hist`` on it gives windowed p50 / p99.

Ring overflow overwrites the oldest frame and counts
``obs.dropped_frames``.  With ``MXNET_OBS_DIR`` set the ring is
persisted as one newline-JSON shard a process (atomic tmp + rename,
labeled with ``MXNET_TRACE_LABEL``): the fleet artifact that
``python -m mxnet_tpu_torch.obs.fleet scrape`` merges.

The disabled path is one module-global load and a branch
(``active()``).
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import re
import sys
import threading
import time
from typing import Dict, List, Optional

from .. import telemetry as _telemetry

__all__ = [
    "Recorder", "start", "stop", "active", "get", "split_label",
    "derive_between", "delta_hist", "SHARD_SUFFIX",
]

SHARD_SUFFIX = ".obs.jsonl"


def _env_int(name: str, default: int) -> int:
    try:
        return int(float(os.environ.get(name, "") or default))
    except (TypeError, ValueError):
        return default


def split_label(label: str):
    """``trainer-rank3`` → ``("trainer", 3)``; ``feed-worker1`` →
    ``("feed-worker", 1)``; no trailing index → rank 0."""
    m = re.match(r"^(.*?)(?:-?rank)?(\d+)$", label or "")
    if m and m.group(1):
        return m.group(1).rstrip("-_"), int(m.group(2))
    return (label or "proc"), 0


# ------------------------------------------------------------- derivation
def delta_hist(prev: Optional[dict], cur: dict) -> Optional[dict]:
    """The histogram of observations that landed BETWEEN two snapshots
    of one cumulative histogram — same dict shape as the snapshot form
    ({"le", "counts", "count", "sum"}), so ``quantile_from_hist`` works
    on it unchanged.  None when the window saw no observations or the
    registry was reset in between."""
    if cur is None:
        return None
    if prev is None:
        prev = {"counts": [0] * len(cur.get("counts", [])),
                "count": 0, "sum": 0.0}
    dcount = int(cur.get("count", 0)) - int(prev.get("count", 0))
    if dcount <= 0:
        return None
    pc, cc = list(prev.get("counts", [])), list(cur.get("counts", []))
    if len(pc) < len(cc):
        pc += [0] * (len(cc) - len(pc))
    dc = [c - p for c, p in zip(cc, pc)]
    if any(d < 0 for d in dc):
        return None
    return {"le": list(cur.get("le", [])), "counts": dc, "count": dcount,
            "sum": float(cur.get("sum", 0.0)) - float(prev.get("sum", 0.0))}


def derive_between(prev: Optional[dict], cur: dict, dt: float) -> dict:
    """Rates + windowed quantiles between two raw snapshots.

    Returns ``{"rates": {counter: per_s}, "quantiles": {hist:
    {"rate", "mean_us", "p50_us", "p99_us"}}}``.  ``prev=None`` treats
    every cumulative value as the window (rates since birth).  Shared
    by the recorder and ``obs.fleet scrape``, so every rate column is
    the same arithmetic.
    """
    dt = max(float(dt), 1e-9)
    pc = (prev or {}).get("counters", {})
    rates: Dict[str, float] = {}
    for name, v in cur.get("counters", {}).items():
        d = int(v) - int(pc.get(name, 0))
        if d >= 0:
            rates[name] = d / dt
    quantiles: Dict[str, dict] = {}
    ph = (prev or {}).get("histograms", {})
    for name, h in cur.get("histograms", {}).items():
        dh = delta_hist(ph.get(name), h)
        if dh is None:
            continue
        q = {"rate": dh["count"] / dt,
             "mean_us": dh["sum"] / dh["count"]}
        for tag, frac in (("p50_us", 0.5), ("p99_us", 0.99)):
            v = _telemetry.quantile_from_hist(dh, frac)
            if v is not None:
                q[tag] = v
        quantiles[name] = q
    return {"rates": rates, "quantiles": quantiles}


# ---------------------------------------------------------------- recorder
class Recorder:
    """Bounded ring of derived telemetry frames, fed by a sampler
    thread; see module docstring.  ``rules`` is an optional
    :class:`mxnet_tpu_torch.obs.rules.RuleEngine` evaluated on every frame's
    flattened view (the in-process watchdog)."""

    def __init__(self, interval_s: float, ring: Optional[int] = None,
                 out_dir: Optional[str] = None, rules=None):
        self.interval_s = max(float(interval_s), 0.005)
        cap = ring if ring is not None else _env_int("MXNET_OBS_RING", 256)
        self._ring: "collections.deque" = collections.deque(
            maxlen=max(8, int(cap)))
        self.out_dir = out_dir if out_dir is not None else \
            (os.environ.get("MXNET_OBS_DIR") or None)
        self.engine = rules
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prev_raw: Optional[dict] = None
        self._prev_mono: Optional[float] = None
        from .signals import WaitAccrual
        self._wait = WaitAccrual()
        self._samples = 0
        self._dropped = 0
        self._flush_every = max(1, _env_int("MXNET_OBS_FLUSH_EVERY", 10))
        self._shard_path: Optional[str] = None
        # the sampler's periodic flush and a caller's may overlap: they
        # write the same tmp name, so one flush at a time
        self._flush_mu = threading.Lock()

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "Recorder":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="obs-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None
        self.flush()

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as e:
                # the observer must never take down the observed
                sys.stderr.write(f"[mxnet_tpu_torch.obs] sample failed: {e}\n")
        # final frame so short-lived processes still leave a window
        try:
            self.sample_once()
        except Exception:
            pass

    # ----------------------------------------------------------- sampling
    def sample_once(self) -> dict:
        """Take one frame now (the sampler's body; also the test/bench
        entry point for deterministic sampling)."""
        frame = self.derive(_telemetry.raw_snapshot(), time.monotonic())
        # derived health signals ride the frame and the registry (obs.*
        # gauges), so /metrics sees them too
        from . import signals as _signals
        _signals.publish(frame["signals"])

        engine = self.engine
        if engine is not None:
            try:
                engine.update(frame)
            except Exception as e:
                sys.stderr.write(f"[mxnet_tpu_torch.obs] watchdog failed: {e}\n")

        with self._mu:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
                dropped = self._dropped
            else:
                dropped = None
            self._ring.append(frame)
            self._samples += 1
            n = self._samples
        if dropped is not None:
            _telemetry.counter_add("obs.dropped_frames")
        _telemetry.counter_add("obs.frames")
        if self.out_dir and n % self._flush_every == 0:
            self.flush()
        return frame

    def derive(self, raw: dict, mono: float) -> dict:
        """The frame of registry snapshot ``raw`` taken at monotonic time
        ``mono``: rates and quantiles against the previous frame's, the
        feed wait accrued in the window (``accrued_us``) and the derived
        signals.  Advances the recorder's previous-frame state."""
        prev_raw, prev_mono = self._prev_raw, self._prev_mono
        dt = (mono - prev_mono) if prev_mono is not None else None
        derived = derive_between(prev_raw, raw, dt) if dt else \
            {"rates": {}, "quantiles": {}}
        accrued = self._wait.update(raw, mono)
        frame = {
            "t": time.time(),
            "mono": mono,
            "dt": dt,
            "label": _telemetry._proc_label(),
            "pid": os.getpid(),
            "counters": dict(raw.get("counters", {})),
            "gauges": dict(raw.get("gauges", {})),
            "histograms": dict(raw.get("histograms", {})),
            "rates": derived["rates"],
            "quantiles": derived["quantiles"],
            "accrued_us": ({} if accrued is None or not dt
                           else {"datafeed.wait_us": accrued}),
        }
        self._prev_raw, self._prev_mono = raw, mono
        from . import signals as _signals
        frame["signals"] = _signals.compute(frame)
        return frame

    # -------------------------------------------------------------- state
    def frames(self) -> List[dict]:
        with self._mu:
            return list(self._ring)

    def last_frame(self) -> Optional[dict]:
        with self._mu:
            return self._ring[-1] if self._ring else None

    def state(self) -> dict:
        """Compact ring state for `telemetry.dump()` (embedded under
        "obs"): meta + the derived view of every frame, raw registry
        maps elided (the dump's own snapshot already carries them)."""
        with self._mu:
            frames = list(self._ring)
            samples, dropped = self._samples, self._dropped
        return {
            "interval_ms": round(self.interval_s * 1000.0, 3),
            "ring_capacity": self._ring.maxlen,
            "frames": len(frames),
            "samples": samples,
            "dropped_frames": dropped,
            "running": self.running(),
            "shard": self._shard_path,
            "window": [
                {"t": f["t"], "dt": f["dt"], "rates": f["rates"],
                 "quantiles": f["quantiles"],
                 "signals": f.get("signals", {}),
                 "gauges": f["gauges"]}
                for f in frames],
            "alerts": self.engine.summary() if self.engine else None,
        }

    # ------------------------------------------------------------- shards
    def flush(self) -> Optional[str]:
        """Persist the ring as this process's newline-JSON shard under
        ``out_dir`` (atomic tmp + rename; first line is the shard meta).
        No-op without an out_dir."""
        if not self.out_dir:
            return None
        frames = self.frames()
        label = _telemetry._proc_label()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(
            self.out_dir,
            re.sub(r"[^A-Za-z0-9._-]", "_", label) +
            f"-{os.getpid()}{SHARD_SUFFIX}")
        role, rank = split_label(label)
        meta = {"version": 1, "kind": "obs-shard", "label": label,
                "role": role, "rank": rank, "pid": os.getpid(),
                "interval_ms": round(self.interval_s * 1000.0, 3),
                "argv": list(sys.argv)}
        tmp = f"{path}.{os.getpid()}.tmp"
        with self._flush_mu:
            with open(tmp, "w") as f:
                f.write(json.dumps(meta, default=str) + "\n")
                for fr in frames:
                    f.write(json.dumps(fr, default=str) + "\n")
            os.replace(tmp, path)
            self._shard_path = path
        return path


# ------------------------------------------------------- module singleton
_rec: Optional[Recorder] = None
_mu = threading.Lock()


def _interval_s_from_env() -> float:
    try:
        ms = float(os.environ.get("MXNET_OBS_INTERVAL_MS", "0") or 0.0)
    except ValueError:
        ms = 0.0
    return ms / 1000.0


def get() -> Optional[Recorder]:
    return _rec


def active() -> bool:
    """One load + one branch — the disabled-path contract."""
    r = _rec
    return r is not None and r.running()


def start(interval_ms: Optional[float] = None, ring: Optional[int] = None,
          out_dir: Optional[str] = None, rules="seeded") -> Optional[Recorder]:
    """Start (or return) the process-wide recorder.  ``interval_ms=None``
    reads ``MXNET_OBS_INTERVAL_MS``; ≤0 means stay off.  ``rules`` is a
    RuleEngine, ``"seeded"`` for the default watchdog, or None."""
    global _rec
    interval_s = (_interval_s_from_env() if interval_ms is None
                  else float(interval_ms) / 1000.0)
    if interval_s <= 0:
        return None
    with _mu:
        if _rec is not None and _rec.running():
            return _rec
        if rules == "seeded":
            from .rules import RuleEngine, seeded_rules
            rules = RuleEngine(seeded_rules())
        _rec = Recorder(interval_s, ring=ring, out_dir=out_dir, rules=rules)
        _rec.start()
        _telemetry.register_dump_extra("obs", _rec.state)
        return _rec


def stop(timeout: float = 5.0):
    global _rec
    with _mu:
        r, _rec = _rec, None
    if r is not None:
        r.stop(timeout)


def _atexit_flush():
    r = _rec
    if r is not None:
        try:
            r.stop(timeout=2.0)
        except Exception:
            pass


atexit.register(_atexit_flush)
