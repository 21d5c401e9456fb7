"""Process-wide metrics and diagnostics of the port (≙
``mxnet_tpu/telemetry.py``): the reference's pure-Python registry
(``_PyRegistry``, the shape its native tier also gives), its trace
context and flight recorder, and its exports.  The port loads no native
registry, so every tier records here.

- **Metrics**: ``counter_add``, ``gauge_set``, ``observe`` (histograms
  take microseconds in the fixed ``BUCKET_BOUNDS_US``), ``timed``;
  ``raw_snapshot()`` is ``{"enabled", "counters", "gauges",
  "histograms", "engines"}``; ``snapshot()`` sections it by prefix
  (``SECTIONS``), adds live ``DataFeed`` ring stats and the card's memory
  (``device_memory``: ``torch.cuda.memory_stats`` under the reference's
  PJRT keys, ``bytes_in_use``, ``peak_bytes_in_use``, ...), and feeds
  every counter and gauge into a ``profiler.Counter`` of the same name.
  ``MXNET_TELEMETRY=0`` (or ``set_enabled(False)``) stops recording.
- **Traces**: ``span`` records ``(trace_id, span_id, parent_id, name,
  start µs, duration µs, thread, attrs, links)`` into a bounded
  lock-sharded ring (``MXNET_TRACE=0`` disables, ``MXNET_TRACE_RING``
  sizes it); context is thread-local and crosses processes in the
  ``X-MXNet-Trace`` header (``trace_header`` / ``parse_trace_header``);
  ``trace_events`` / ``dump_trace`` export Chrome trace-event JSON.
- **Exports**: ``quantile_from_hist`` / ``quantile`` (linear inside the
  bucket), ``summary``, ``dump_prometheus`` (cumulative buckets, ``+Inf``,
  ``# HELP`` / ``# TYPE`` per family), ``dump`` (snapshot, thread stacks
  and the span ring, written atomically).  ``SIGUSR2`` and
  ``MXNET_TELEMETRY_DUMP_ON_EXIT=1`` call ``dump``; with
  ``MXNET_TRACE_DIR`` every process leaves its trace shard there at exit.

What the port emits, under the reference's names: ``decode.*``
(``generate``, ``DecodeBatcher``); ``serve.*`` (requests, admitted,
rejected, abandoned, batches, coalesced_batches, padded, errors, swaps,
evictions, ``http_*``, ``fault.*``, ``precision.*``; gauges
``queue_depth``, ``models``, ``programs``, ``param_bytes_per_device``;
histograms ``queue_wait_us``, ``device_us``, ``e2e_us``, ``batch_fill``
(items, not µs), ``warmup_us``); ``router.*``; ``checkpoint.*``
(``pause_us``, ``save_us``, ``restore_us``, ``saves``, ``bytes_written``,
``last_success_step``, ``corrupt.*``, ``restore_fallbacks``, ...);
``fused.*``; ``datafeed.*``; ``lockwatch.*``.  Spans: ``serve.request``,
``serve.execute``, ``serve.engine_run``, ``router.*``, ``train.step``,
``checkpoint.pause``, ``datafeed.wait``, ``decode.generate``.
"""
from __future__ import annotations

import atexit
import json
import os
import random as _random
import re
import signal as _signal
import sys
import threading
import time
import traceback
import weakref
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["snapshot", "raw_snapshot", "summary", "dump_prometheus", "dump",
           "reset", "enabled", "set_enabled", "counter_add", "gauge_set",
           "observe", "timed", "register_ring", "register_publisher",
           "quantile", "quantile_from_hist", "BUCKET_BOUNDS_US", "SECTIONS",
           "span", "trace_enabled", "set_trace_enabled", "trace_header",
           "parse_trace_header", "current_context", "set_current_trace",
           "dump_trace", "trace_events", "trace_spans", "trace_stats",
           "trace_reset", "TRACE_HEADER"]

BUCKET_BOUNDS_US = [1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                    1000.0, 2500.0, 5000.0, 10000.0, 25000.0, 50000.0,
                    100000.0, 250000.0, 1000000.0]

# Metric-name prefixes that get their own section in snapshot(); anything
# else lands under "other".
SECTIONS = ("engine", "storage", "dataio", "kvstore", "datafeed", "dispatch",
            "fused", "checkpoint", "serve", "router", "collective",
            "feed_service", "quant", "obs", "decode")

_FALSY = ("0", "false", "off")


# ------------------------------------------------------ pure-python registry
class _PyRegistry:
    """The registry, in the reference's snapshot shape."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, int] = {}
        # name → [bucket counts (len(le)+1), count, sum]
        self._hists: Dict[str, list] = {}

    def counter_add(self, name, delta):
        with self._mu:
            self._counters[name] = self._counters.get(name, 0) + int(delta)

    def gauge_set(self, name, value):
        with self._mu:
            self._gauges[name] = int(value)

    def observe(self, name, value_us):
        b = len(BUCKET_BOUNDS_US)
        for i, bound in enumerate(BUCKET_BOUNDS_US):
            if value_us <= bound:
                b = i
                break
        with self._mu:
            h = self._hists.setdefault(
                name, [[0] * (len(BUCKET_BOUNDS_US) + 1), 0, 0.0])
            h[0][b] += 1
            h[1] += 1
            h[2] += float(value_us)

    def observe_many(self, name, values):
        """``observe(name, v)`` for each ``v`` of the float64 array
        ``values``, in order, under one lock: the same counts and the
        same sum as the calls one by one."""
        import numpy as np
        idx = np.searchsorted(np.asarray(BUCKET_BOUNDS_US), values,
                              side="left")
        counts = np.bincount(idx, minlength=len(BUCKET_BOUNDS_US) + 1)
        vals = values.tolist()
        with self._mu:
            h = self._hists.setdefault(
                name, [[0] * (len(BUCKET_BOUNDS_US) + 1), 0, 0.0])
            for b, c in enumerate(counts.tolist()):
                h[0][b] += c
            h[1] += len(vals)
            total = h[2]
            for v in vals:
                total += v
            h[2] = total

    def merge_hist(self, name, counts, count, total):
        """Add bucket ``counts``, ``count`` observations and their sum
        ``total`` to histogram ``name`` (the native engine's block,
        folded in by ``engine``)."""
        with self._mu:
            h = self._hists.setdefault(
                name, [[0] * (len(BUCKET_BOUNDS_US) + 1), 0, 0.0])
            for b, c in enumerate(counts):
                h[0][b] += int(c)
            h[1] += int(count)
            h[2] += float(total)

    def snapshot(self):
        with self._mu:
            return {
                "enabled": _py_enabled,
                "counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
                "histograms": {
                    n: {"le": list(BUCKET_BOUNDS_US), "counts": list(h[0]),
                        "count": h[1], "sum": h[2]}
                    for n, h in sorted(self._hists.items())},
                "engines": [],
            }

    def reset(self):
        with self._mu:
            for k in self._counters:
                self._counters[k] = 0
            for k in self._gauges:
                self._gauges[k] = 0
            for h in self._hists.values():
                h[0] = [0] * (len(BUCKET_BOUNDS_US) + 1)
                h[1] = 0
                h[2] = 0.0


_pyreg = _PyRegistry()
_py_enabled = os.environ.get("MXNET_TELEMETRY", "1").lower() not in _FALSY


# ------------------------------------------------------------ recording API
def enabled() -> bool:
    """Whether recording is on (initially from MXNET_TELEMETRY)."""
    return _py_enabled


def set_enabled(on: bool) -> bool:
    """Turn recording on/off; returns the previous flag."""
    global _py_enabled
    prev = _py_enabled
    _py_enabled = bool(on)
    return prev


def counter_add(name: str, delta: int = 1):
    """Add to a monotonic counter."""
    if _py_enabled:
        _pyreg.counter_add(name, delta)


def gauge_set(name: str, value: int):
    """Set a point-in-time gauge."""
    if _py_enabled:
        _pyreg.gauge_set(name, value)


def observe(name: str, value_us: float):
    """Record one histogram observation (microseconds for latencies;
    the fixed bucket bounds are BUCKET_BOUNDS_US)."""
    if _py_enabled:
        _pyreg.observe(name, value_us)


def _merge_hist(name: str, counts, count: int, total: float):
    """Fold observations recorded elsewhere (the native engine's block:
    bucket counts on :data:`BUCKET_BOUNDS_US`, their number and sum) into
    histogram ``name``."""
    if _py_enabled:
        _pyreg.merge_hist(name, counts, count, total)


_engine_states: list = []


def _set_engine_states(states):
    """The live engines' queue states that :func:`raw_snapshot` lists
    under ``"engines"`` (set by ``engine`` at each snapshot)."""
    global _engine_states
    _engine_states = list(states)


def _observe_many(name: str, values):
    """Record each value of the float64 numpy array ``values`` into
    histogram ``name``, as that many ``observe`` calls would (one lock;
    the calibration hooks' 512 values a layer and batch)."""
    if _py_enabled and len(values):
        _pyreg.observe_many(name, values)


class timed:
    """Context manager observing the elapsed microseconds into histogram
    ``name``."""

    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._t0 = None

    def __enter__(self):
        if _py_enabled:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            observe(self.name, (time.perf_counter_ns() - self._t0) / 1000.0)
            self._t0 = None


def reset():
    """Zero every metric (names stay registered) and clear the span ring
    (so a check or bench leg starts from a clean flight recorder)."""
    _pyreg.reset()
    trace_reset()


# ------------------------------------------------------------------ tracing
# The flight recorder: spans land in a bounded lock-sharded per-process
# ring buffer, always on by default (MXNET_TRACE=0 disables; the off
# path is one module-global load + branch, same bar as metrics).  Trace
# context is thread-local and crosses processes via the X-MXNet-Trace
# header ("<trace_id hex16>-<span_id hex16>"); export is Chrome
# trace-event JSON (dump_trace / MXNET_TRACE_DIR shard files) that
# chrome://tracing and Perfetto load directly — the reference profiler's
# chrome-trace output (src/profiler/profiler.h), recast to span OS
# processes instead of one engine.

TRACE_HEADER = "X-MXNet-Trace"

_trace_on = os.environ.get("MXNET_TRACE", "1").lower() not in _FALSY
_TRACE_SHARDS = 8           # power of two: shard index is ident & mask


def _trace_ring_cap() -> int:
    try:
        return max(_TRACE_SHARDS * 8,
                   int(os.environ.get("MXNET_TRACE_RING", "8192")))
    except ValueError:
        return 8192


class _SpanShard:
    __slots__ = ("mu", "buf", "idx", "n", "dropped")

    def __init__(self, cap: int):
        self.mu = threading.Lock()
        self.buf: list = [None] * cap
        self.idx = 0            # next write slot
        self.n = 0              # live records (≤ cap)
        self.dropped = 0        # overwrites of unread records


class _SpanRecorder:
    """Lock-sharded bounded ring of finished spans.  A record is the
    tuple (trace_id, span_id, parent_id, name, t_start_us, dur_us, tid,
    attrs|None, links|None) — ids are ints, times are wall-clock µs so
    shards from different processes land on one merged timeline."""

    def __init__(self, capacity: Optional[int] = None):
        cap = capacity if capacity is not None else _trace_ring_cap()
        per = max(8, cap // _TRACE_SHARDS)
        self.shards = [_SpanShard(per) for _ in range(_TRACE_SHARDS)]
        self.capacity = per * _TRACE_SHARDS

    def record(self, rec: tuple):
        sh = self.shards[threading.get_ident() & (_TRACE_SHARDS - 1)]
        with sh.mu:
            if sh.n == len(sh.buf):
                sh.dropped += 1         # flight recorder: oldest goes
            else:
                sh.n += 1
            sh.buf[sh.idx] = rec
            sh.idx = (sh.idx + 1) % len(sh.buf)

    def spans(self) -> List[tuple]:
        out = []
        for sh in self.shards:
            with sh.mu:
                cap = len(sh.buf)
                start = (sh.idx - sh.n) % cap
                out.extend(sh.buf[(start + i) % cap] for i in range(sh.n))
        out.sort(key=lambda r: r[4])
        return out

    def stats(self) -> dict:
        spans = dropped = 0
        for sh in self.shards:
            with sh.mu:
                spans += sh.n
                dropped += sh.dropped
        return {"spans": spans, "dropped": dropped}

    def reset(self):
        for sh in self.shards:
            with sh.mu:
                sh.buf = [None] * len(sh.buf)
                sh.idx = sh.n = sh.dropped = 0


_span_recorder = _SpanRecorder()
_tid_names: Dict[int, str] = {}     # thread ident → name, for "M" rows


class _TraceTL(threading.local):
    trace_id: Optional[int] = None
    span_id: Optional[int] = None


_trace_tl = _TraceTL()
_INHERIT = object()                 # sentinel: parent from thread-local


def trace_enabled() -> bool:
    """Whether span recording is on (initially from MXNET_TRACE)."""
    return _trace_on


def set_trace_enabled(on: bool) -> bool:
    """Flip span recording; returns the previous flag (bench harness)."""
    global _trace_on
    prev = _trace_on
    _trace_on = bool(on)
    return prev


# ids must be unique ACROSS the fleet: every process calls mx.seed(0),
# which seeds the global `random` module — drawing from it would give
# every rank the identical id stream (and colliding span ids on the
# merged timeline).  SystemRandom reads urandom directly: immune to
# seeding and to fork-duplicated PRNG state.
_id_rand = _random.SystemRandom()


def _new_id() -> int:
    # non-zero 64-bit id
    return _id_rand.getrandbits(64) | 1


def current_context() -> Optional[Tuple[int, Optional[int]]]:
    """The calling thread's (trace_id, span_id), or None outside any
    span/trace.  Capture this to hand trace context to another thread
    (thread-locals do NOT cross thread hops)."""
    if not _trace_on or _trace_tl.trace_id is None:
        return None
    return (_trace_tl.trace_id, _trace_tl.span_id)


def set_current_trace(trace_id: Optional[int] = None) -> Optional[int]:
    """Pin the calling thread's trace id (fresh when None) with no open
    parent span — the per-step rotation point: the trainer calls this at
    the top of each step so the step span, the DataFeed wait that
    follows it and the checkpoint pause all share one step-scoped trace
    id.  Returns the trace id (None when tracing is off)."""
    if not _trace_on:
        return None
    _trace_tl.trace_id = trace_id if trace_id is not None else _new_id()
    _trace_tl.span_id = None
    return _trace_tl.trace_id


def trace_header() -> Optional[str]:
    """The X-MXNet-Trace value for the calling thread's context
    ("<trace_id>-<span_id>", zero-padded hex16), or None when tracing is
    off / no context is set.  Inject into outbound HTTP so the remote
    hop's spans become children of the current span."""
    if not _trace_on:
        return None
    tid, sid = _trace_tl.trace_id, _trace_tl.span_id
    if tid is None:
        return None
    return f"{tid:016x}-{(sid or 0):016x}"


def parse_trace_header(value) -> Optional[Tuple[int, Optional[int]]]:
    """Parse an X-MXNet-Trace value into (trace_id, parent_span_id).
    Malformed values parse to None — a bad header must never fail a
    request, it just starts a fresh trace."""
    if not value or not isinstance(value, str):
        return None
    try:
        a, b = value.strip().split("-", 1)
        tid, sid = int(a, 16), int(b, 16)
    except ValueError:
        return None
    if tid == 0:
        return None
    return (tid, sid or None)


class span:
    """Context manager recording one trace span into the flight
    recorder: (trace_id, span_id, parent_id, t_start_us, dur_us, attrs).

    Parentage defaults to the calling thread's current span (nested
    `with` blocks nest); pass ``parent=`` an explicit context — a
    header string, a (trace_id, span_id) tuple, or None to force a new
    root trace.  ``links=`` attaches (trace_id, span_id) pairs of OTHER
    spans this one served (the batcher's fan-in join).  Timing is
    wall-clock µs from one clock at enter and exit, so a child's
    interval is contained in its parent's and shards from different
    processes align on one merged timeline.  With MXNET_TRACE=0 enter
    and exit are a single module-global check."""

    __slots__ = ("name", "attrs", "_links", "_parent", "_t0",
                 "_trace_id", "_span_id", "_parent_id", "_prev")

    def __init__(self, name: str, parent=_INHERIT, links=None, **attrs):
        self.name = name
        self.attrs = attrs
        self._links = links
        self._parent = parent
        self._t0 = None

    def __enter__(self):
        if not _trace_on:
            return self
        tl = _trace_tl
        if self._parent is _INHERIT:
            trace_id, parent_id = tl.trace_id, tl.span_id
        else:
            p = self._parent
            if isinstance(p, str):
                p = parse_trace_header(p)
            trace_id, parent_id = p if p else (None, None)
        if trace_id is None:
            trace_id = _new_id()
        self._trace_id, self._parent_id = trace_id, parent_id
        self._span_id = _new_id()
        self._prev = (tl.trace_id, tl.span_id)
        tl.trace_id, tl.span_id = trace_id, self._span_id
        self._t0 = time.time_ns() // 1000
        return self

    def set(self, **attrs) -> "span":
        """Attach attributes to an open span (e.g. the hedge loser's
        ``cancelled=True``)."""
        self.attrs.update(attrs)
        return self

    def context(self) -> Optional[Tuple[int, int]]:
        """(trace_id, span_id) of this span while open, for links and
        cross-thread handoff; None when tracing is off."""
        if self._t0 is None:
            return None
        return (self._trace_id, self._span_id)

    def header(self) -> Optional[str]:
        """X-MXNet-Trace value naming this span as the remote parent."""
        if self._t0 is None:
            return None
        return f"{self._trace_id:016x}-{self._span_id:016x}"

    def __exit__(self, exc_type, exc, tb):
        if self._t0 is None:
            return False
        t_end = time.time_ns() // 1000
        tl = _trace_tl
        tl.trace_id, tl.span_id = self._prev
        if exc_type is not None and "error" not in self.attrs:
            self.attrs["error"] = exc_type.__name__
        ident = threading.get_ident()
        if ident not in _tid_names:
            _tid_names[ident] = threading.current_thread().name
        _span_recorder.record(
            (self._trace_id, self._span_id, self._parent_id, self.name,
             self._t0, max(0, t_end - self._t0), ident,
             self.attrs or None, self._links))
        self._t0 = None
        return False


def trace_spans() -> List[tuple]:
    """The flight recorder's live contents, oldest first — raw record
    tuples for tests and in-process analysis."""
    return _span_recorder.spans()


def trace_stats() -> dict:
    """{"spans": live records, "dropped": ring overwrites} — recorder
    pressure, embedded per bench row."""
    return _span_recorder.stats()


def trace_reset():
    """Clear the span ring (drop counters included)."""
    _span_recorder.reset()


def _proc_label() -> str:
    lbl = os.environ.get("MXNET_TRACE_LABEL")
    if lbl:
        return lbl
    base = os.path.basename(sys.argv[0] or "") or "python"
    return base


def _hexid(v) -> Optional[str]:
    return f"{v:016x}" if v else None


def trace_events() -> List[dict]:
    """The span ring as Chrome trace-event dicts (ph "X" complete
    events + "M" process/thread metadata rows)."""
    pid = os.getpid()
    evs: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": f"{_proc_label()} [{pid}]"}},
    ]
    seen_tids = set()
    for (trace_id, span_id, parent_id, name, t_start_us, dur_us, tid,
         attrs, links) in _span_recorder.spans():
        if tid not in seen_tids:
            seen_tids.add(tid)
            evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid,
                        "args": {"name": _tid_names.get(tid, str(tid))}})
        args = {"trace_id": _hexid(trace_id),
                "span_id": _hexid(span_id),
                "parent_id": _hexid(parent_id)}
        if attrs:
            args.update(attrs)
        if links:
            args["links"] = [f"{lt:016x}-{(ls or 0):016x}"
                             for lt, ls in links]
        evs.append({"ph": "X", "cat": "mxtpu", "name": name,
                    "ts": t_start_us, "dur": dur_us,
                    "pid": pid, "tid": tid, "args": args})
    return evs


def dump_trace(path: Optional[str] = None) -> str:
    """Write this process's span ring as a Chrome trace-event JSON file
    (atomic tmp + rename).  Default path is
    ``$MXNET_TRACE_DIR/trace_<pid>.json`` when MXNET_TRACE_DIR is set
    (the per-fleet-member shard `tools/trace.py merge` stitches), else
    ``mxtpu_trace_<pid>.json`` in the CWD.  Returns the path."""
    if path is None:
        tdir = os.environ.get("MXNET_TRACE_DIR")
        if tdir:
            os.makedirs(tdir, exist_ok=True)
            path = os.path.join(tdir, f"trace_{os.getpid()}.json")
        else:
            path = os.path.join(os.getcwd(),
                                f"mxtpu_trace_{os.getpid()}.json")
    data = {"traceEvents": trace_events(),
            "displayTimeUnit": "ms",
            "otherData": {"pid": os.getpid(), "label": _proc_label(),
                          "argv": list(sys.argv),
                          "stats": trace_stats()}}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, default=str)
    os.replace(tmp, path)
    return path


# ----------------------------------------------------------- ring registry
# DataFeed staging rings register themselves (weakly) so snapshot() can
# poll their live stats() without keeping dead rings alive.
_rings: "weakref.WeakSet" = weakref.WeakSet()


def register_ring(ring):
    _rings.add(ring)


def _ring_stats() -> List[dict]:
    out = []
    for r in list(_rings):
        try:
            out.append(r.stats())
        except Exception:
            continue
    return out


# ------------------------------------------------------------- snapshotting
# Zero-arg callables flushed before every raw_snapshot(): subsystems that
# keep cheap local counters on their hot path (the dispatch cache) batch
# them into the registry here instead of paying a registry call per op.
_publishers: List[Callable[[], None]] = []


def register_publisher(fn: Callable[[], None]):
    _publishers.append(fn)


def _run_publishers():
    for fn in list(_publishers):
        try:
            fn()
        except Exception:
            pass    # a broken publisher must never break a snapshot


def raw_snapshot() -> dict:
    """The registry verbatim: {"enabled", "counters", "gauges",
    "histograms", "engines"}."""
    _run_publishers()
    snap = _pyreg.snapshot()
    snap["engines"] = list(_engine_states)
    return snap


# the reference's PJRT memory_stats keys ← torch.cuda.memory_stats keys
_MEMORY_KEYS = (("bytes_in_use", "allocated_bytes.all.current"),
                ("peak_bytes_in_use", "allocated_bytes.all.peak"),
                ("bytes_reserved", "reserved_bytes.all.current"),
                ("peak_bytes_reserved", "reserved_bytes.all.peak"),
                ("num_allocs", "allocation.all.allocated"))


def _device_memory() -> dict:
    """Per-device memory accounting: the cards' inventory, with the
    caching allocator's statistics (``torch.cuda.memory_stats``) under
    the reference's keys once CUDA is initialized in this process (the
    snapshot never initializes it); without a card, the CPU with no
    statistics, as the reference reports a CPU backend."""
    devices = []
    try:
        import torch
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                ent = {"id": i, "platform": "gpu",
                       "device_kind": torch.cuda.get_device_name(i)}
                if torch.cuda.is_initialized():
                    ms = torch.cuda.memory_stats(i)
                    for key, src in _MEMORY_KEYS:
                        if src in ms:
                            ent[key] = int(ms[src])
                    ent["bytes_limit"] = int(
                        torch.cuda.get_device_properties(i).total_memory)
                devices.append(ent)
        else:
            devices.append({"id": 0, "platform": "cpu", "device_kind": "cpu"})
    except Exception:
        pass
    return {"device_count": len(devices), "devices": devices}


_prof_counters: Dict[str, object] = {}


def _feed_profiler(flat: Dict[str, int]):
    """Publish every counter/gauge into a profiler.Counter of the SAME
    name, so the chrome trace carries 'C' samples aligned with scrapes."""
    try:
        from . import profiler
    except Exception:
        return
    for name, v in flat.items():
        c = _prof_counters.get(name)
        if c is None:
            c = profiler.Counter(name)
            _prof_counters[name] = c
        c.set_value(v)


def snapshot() -> dict:
    """One sectioned dict over everything observable:

    {"enabled", "time", "pid",
     "engine":  {"counters", "gauges", "histograms", "state"},
     "serve" | "router" | "checkpoint" | ...: {"counters", "gauges",
                                               "histograms"},
     "datafeed": {..., "rings": [per-ring stats()]},
     "device_memory": {"device_count", "devices": [...]},
     "other": {...}}   # metrics outside the known prefixes
    """
    raw = raw_snapshot()
    out = {"enabled": raw.get("enabled", True), "time": time.time(),
           "pid": os.getpid()}
    secs = {s: {"counters": {}, "gauges": {}, "histograms": {}}
            for s in SECTIONS}
    other = {"counters": {}, "gauges": {}, "histograms": {}}
    for kind in ("counters", "gauges", "histograms"):
        for name, v in raw.get(kind, {}).items():
            sec = secs.get(name.split(".", 1)[0], other)
            sec[kind][name] = v
    out.update(secs)
    out["other"] = other
    out["engine"]["state"] = raw.get("engines", [])
    out["datafeed"]["rings"] = _ring_stats()
    out["device_memory"] = _device_memory()
    flat = {}
    flat.update(raw.get("counters", {}))
    flat.update(raw.get("gauges", {}))
    _feed_profiler(flat)
    return out


def quantile_from_hist(h: dict, q: float) -> Optional[float]:
    """Estimate the q-quantile (0..1) of one snapshot histogram dict
    ({"le", "counts", "count", "sum"}) by linear interpolation inside the
    bucket containing the target rank — the single audited quantile path
    for the fixed µs buckets (serving SLAs, diagnose reports).  Returns
    None for an empty histogram; ranks landing in the overflow bucket
    clamp to the last finite bound."""
    cnt = int(h.get("count", 0))
    if cnt <= 0:
        return None
    q = min(max(float(q), 0.0), 1.0)
    rank = q * cnt
    le, counts = list(h.get("le", [])), list(h.get("counts", []))
    cum, lo = 0.0, 0.0
    for bound, c in zip(le, counts):
        if c and cum + c >= rank:
            frac = (rank - cum) / c
            return lo + frac * (float(bound) - lo)
        cum += c
        lo = float(bound)
    return le[-1] if le else None


def quantile(section: str, name: str, q: float,
             snap: Optional[dict] = None) -> Optional[float]:
    """q-quantile of the live histogram `section.name` (or pass a cached
    raw_snapshot() via `snap` to price several quantiles on one scrape).
    `name` may be bare ("e2e_us") or already prefixed ("serve.e2e_us").
    None when the histogram doesn't exist or has no observations."""
    full = name if name.startswith(section + ".") else f"{section}.{name}"
    raw = snap if snap is not None else raw_snapshot()
    h = (raw.get("histograms") or {}).get(full)
    if h is None:
        return None
    return quantile_from_hist(h, q)


def summary() -> dict:
    """Compact flat view for embedding in artifacts (bench rows): all
    counters and gauges, histograms reduced to .count/.sum_us."""
    raw = raw_snapshot()
    out = dict(raw.get("counters", {}))
    out.update(raw.get("gauges", {}))
    for name, h in raw.get("histograms", {}).items():
        out[name + ".count"] = h.get("count", 0)
        out[name + ".sum_us"] = round(h.get("sum", 0.0), 3)
    return out


# ------------------------------------------------------------- prometheus
def _prom_name(name: str) -> str:
    return "mxtpu_" + re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_fmt(v) -> str:
    if isinstance(v, float):
        return repr(v)
    return str(v)


def dump_prometheus() -> str:
    """Render the registry (plus device memory) as Prometheus text
    exposition format: a ``# HELP`` + ``# TYPE`` pair precedes every
    metric family and histogram buckets are emitted CUMULATIVE with a
    final le="+Inf", per the exposition spec — valid for a real
    Prometheus scraper, not just our own router sweep."""
    raw = raw_snapshot()
    lines = []
    for name, v in raw.get("counters", {}).items():
        p = _prom_name(name)
        lines.append(f"# HELP {p} mxnet_tpu counter {name}")
        lines.append(f"# TYPE {p} counter")
        lines.append(f"{p} {v}")
    for name, v in raw.get("gauges", {}).items():
        p = _prom_name(name)
        lines.append(f"# HELP {p} mxnet_tpu gauge {name}")
        lines.append(f"# TYPE {p} gauge")
        lines.append(f"{p} {v}")
    for name, h in raw.get("histograms", {}).items():
        p = _prom_name(name)
        lines.append(f"# HELP {p} mxnet_tpu histogram {name} (microseconds)")
        lines.append(f"# TYPE {p} histogram")
        cum = 0
        for le, c in zip(h["le"], h["counts"]):
            cum += c
            le_s = _prom_fmt(le).rstrip("0").rstrip(".") or "0"
            lines.append(f'{p}_bucket{{le="{le_s}"}} {cum}')
        cum += h["counts"][len(h["le"])]
        lines.append(f'{p}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{p}_sum {_prom_fmt(h['sum'])}")
        lines.append(f"{p}_count {h['count']}")
    dm = _device_memory()
    if dm["devices"]:
        lines.append("# HELP mxtpu_device_memory_bytes per-device "
                     "memory accounting")
        lines.append("# TYPE mxtpu_device_memory_bytes gauge")
        for d in dm["devices"]:
            for key in ("bytes_in_use", "peak_bytes_in_use"):
                if key in d:
                    lines.append(
                        'mxtpu_device_memory_bytes{device="%s",kind="%s"} %d'
                        % (d["id"], key, d[key]))
    return "\n".join(lines) + "\n"


# ------------------------------------------------------- diagnostic dumps
# Extra top-level dump() sections contributed by subsystems that this
# module must not import eagerly (the obs recorder embeds its ring state
# under "obs").  A broken provider must never break a diagnostic dump.
_dump_extras: Dict[str, Callable[[], object]] = {}


def register_dump_extra(name: str, fn: Callable[[], object]):
    """Register a zero-arg callable whose return value is embedded under
    `name` in every diagnostic dump() payload."""
    _dump_extras[name] = fn


def _thread_stacks() -> Dict[str, List[str]]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, 'unknown')}-{ident}"
        out[key] = traceback.format_stack(frame)
    return out


def dump(path: Optional[str] = None, reason: str = "manual") -> str:
    """Write the full diagnostic JSON: snapshot + python thread stacks
    + the span ring.  Default path comes from
    MXNET_TELEMETRY_DUMP_PATH, else mxtpu_telemetry_<pid>.json in the
    CWD.  Written atomically (tmp + rename) so a reader never sees a
    torn file."""
    path = path or os.environ.get("MXNET_TELEMETRY_DUMP_PATH") or \
        os.path.join(os.getcwd(), f"mxtpu_telemetry_{os.getpid()}.json")
    data = {
        "version": 1,
        "reason": reason,
        "pid": os.getpid(),
        "time": time.time(),
        "argv": list(sys.argv),
        "snapshot": snapshot(),
        "threads": _thread_stacks(),
        # the span ring rides along: a post-mortem dump carries the
        # flight recorder, not just the aggregate counters
        "trace": {"stats": trace_stats(), "events": trace_events()},
    }
    for name, fn in list(_dump_extras.items()):
        try:
            data[name] = fn()
        except Exception as e:
            data[name] = {"error": str(e)}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, default=str)
    os.replace(tmp, path)
    return path


_prev_usr2: Optional[Callable] = None


def _dump_trace_shard_quiet():
    """Write the chrome-trace shard for this process if MXNET_TRACE_DIR
    is set and anything was recorded; never raises (exit/signal path)."""
    try:
        if os.environ.get("MXNET_TRACE_DIR") and \
                trace_stats()["spans"] > 0:
            return dump_trace()
    except Exception as e:
        sys.stderr.write(f"[mxnet_tpu_torch.telemetry] trace dump failed: {e}\n")
    return None


def _on_usr2(signum, frame):
    try:
        p = dump(reason="SIGUSR2")
        sys.stderr.write(f"[mxnet_tpu_torch.telemetry] diagnostic dump: {p}\n")
    except Exception as e:  # a diagnostics hook must never kill the host
        sys.stderr.write(f"[mxnet_tpu_torch.telemetry] dump failed: {e}\n")
    tp = _dump_trace_shard_quiet()
    if tp:
        sys.stderr.write(f"[mxnet_tpu_torch.telemetry] trace shard: {tp}\n")
    if callable(_prev_usr2):
        _prev_usr2(signum, frame)


def _install_hooks():
    """SIGUSR2 → dump (MXNET_TELEMETRY_SIGNAL=0 opts out), and
    MXNET_TELEMETRY_DUMP_ON_EXIT=1 → dump at interpreter exit.  When
    MXNET_TRACE_DIR is set every process also leaves its chrome-trace
    shard there at exit (the fleet members' mergeable artifacts).
    Signal installation only works on the main thread — skipped
    silently elsewhere (e.g. when the package is imported from a
    worker)."""
    global _prev_usr2
    if os.environ.get("MXNET_TELEMETRY_DUMP_ON_EXIT",
                      "").lower() in ("1", "true", "on"):
        atexit.register(lambda: dump(reason="exit"))
    if os.environ.get("MXNET_TRACE_DIR"):
        atexit.register(_dump_trace_shard_quiet)
    if not hasattr(_signal, "SIGUSR2"):
        return
    if os.environ.get("MXNET_TELEMETRY_SIGNAL", "1").lower() in _FALSY:
        return
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        prev = _signal.getsignal(_signal.SIGUSR2)
        _signal.signal(_signal.SIGUSR2, _on_usr2)
        if prev not in (_signal.SIG_DFL, _signal.SIG_IGN, None):
            _prev_usr2 = prev
    except (ValueError, OSError):
        pass


_install_hooks()


def _main(argv):
    if "--prometheus" in argv:
        sys.stdout.write(dump_prometheus())
        return 0
    print(json.dumps(snapshot(), indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
