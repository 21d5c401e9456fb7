"""Process-wide metrics of the serving paths: a pure-Python, thread-safe
subset of ``mxnet_tpu/telemetry.py`` with the same names and the same
``raw_snapshot()`` shape (``counters``, ``gauges``, ``histograms`` with
``count``/``sum``).  Histograms take microseconds in the reference's
fixed buckets.

What the port emits, under the reference's names:

- decode (``generate``, ``DecodeBatcher``): the ``decode.*`` counters
  and gauges, and the histograms ``decode.prefill_us`` and
  ``decode.decode_step_us``;
- image serving (``InferenceEngine``, ``Batcher``, ``ModelRegistry``):
  counters ``serve.requests``, ``.admitted``, ``.rejected``,
  ``.abandoned``, ``.batches``, ``.coalesced_batches``, ``.padded``,
  ``.errors``, ``.swaps``, ``.evictions``,
  ``serve.precision.{builds,batches}.fp32``; gauges
  ``serve.queue_depth``, ``.models``, ``.programs``,
  ``.param_bytes_per_device``; histograms ``serve.queue_wait_us``,
  ``serve.device_us`` (the forward and the copy of its outputs to the
  host), ``serve.e2e_us``, ``serve.batch_fill`` (items per batch, not
  µs), ``serve.warmup_us``, and the spans ``serve.engine_run_us``,
  ``serve.execute_us``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict

__all__ = ["counter_add", "gauge_set", "observe", "timed", "span", "reset",
           "raw_snapshot", "BUCKET_BOUNDS_US"]

BUCKET_BOUNDS_US = [1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                    1000.0, 2500.0, 5000.0, 10000.0, 25000.0, 50000.0,
                    100000.0, 250000.0, 1000000.0]

_mu = threading.Lock()
_counters: Dict[str, int] = {}
_gauges: Dict[str, int] = {}
_hists: Dict[str, list] = {}        # name -> [bucket counts, count, sum]


def counter_add(name: str, delta: int = 1):
    """Add to a monotonic counter."""
    with _mu:
        _counters[name] = _counters.get(name, 0) + int(delta)


def gauge_set(name: str, value: int):
    """Set a point-in-time gauge."""
    with _mu:
        _gauges[name] = int(value)


def observe(name: str, value_us: float):
    """Record one histogram observation (microseconds)."""
    b = len(BUCKET_BOUNDS_US)
    for i, bound in enumerate(BUCKET_BOUNDS_US):
        if value_us <= bound:
            b = i
            break
    with _mu:
        h = _hists.setdefault(name, [[0] * (len(BUCKET_BOUNDS_US) + 1), 0,
                                     0.0])
        h[0][b] += 1
        h[1] += 1
        h[2] += float(value_us)


class timed:
    """Context manager observing its elapsed microseconds into histogram
    ``name``."""

    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        observe(self.name, (time.perf_counter_ns() - self._t0) / 1000.0)


class span(timed):
    """A named region: observed into histogram ``<name>_us``.  The
    reference's flight recorder and trace context are not ported; the
    attributes are accepted for call-site compatibility."""

    __slots__ = ()

    def __init__(self, name: str, **attrs):
        super().__init__(name + "_us")


def reset():
    """Zero every metric (names stay registered)."""
    with _mu:
        for k in _counters:
            _counters[k] = 0
        for k in _gauges:
            _gauges[k] = 0
        for h in _hists.values():
            h[0] = [0] * (len(BUCKET_BOUNDS_US) + 1)
            h[1] = 0
            h[2] = 0.0


def raw_snapshot() -> dict:
    """The registry: {"counters", "gauges", "histograms"}."""
    with _mu:
        return {
            "counters": dict(sorted(_counters.items())),
            "gauges": dict(sorted(_gauges.items())),
            "histograms": {
                n: {"le": list(BUCKET_BOUNDS_US), "counts": list(h[0]),
                    "count": h[1], "sum": h[2]}
                for n, h in sorted(_hists.items())},
        }

