"""Derived health signals (≙ ``mxnet_tpu/obs/signals.py``): raw
registry metrics → the numbers an operator pages on.

Each signal is computed a recorder frame from the frame's windowed rates
and delta quantiles, returned as floats, and mirrored into the registry
as fixed-point ``obs.*_ppm`` gauges (parts per million: the registry
stores integers) so ``/metrics`` shows them:

* ``input_stall_frac`` — µs the consumer waited on the feed
  (``datafeed.wait_us``) per µs of fused train step (``fused.step_us``)
  in the window; above 1 the card is input-bound.  In a recorder frame
  the wait is accrued (:class:`WaitAccrual`): the elapsed part of a wait
  still open at the frame counts in its window, so a feed that delivers
  in bursts longer than the window shows its stall in every window it
  holds the consumer back, and a window that ended no step but waited
  reads its wait against one step of the run's mean length.
* ``ckpt_pause_frac`` — ``checkpoint.pause_us`` per step µs.
* ``goodput`` — (admitted − rejected − abandoned) / offered request
  rate, clamped to [0, 1]; present only when the window offered load.
* ``mfu`` — ``obs.model_flops_per_step`` (published by the fused step
  through :func:`publish_model_flops`: 3 × the forward's FLOPs) × the
  step rate ÷ ``MXNET_OBS_PEAK_FLOPS``, the card's peak.
* ``retrace_rate`` / ``queue_frac`` / ``steps_per_s`` — watchdog fuel.

``straggler_skew`` (the spread of per-rank step p50s) needs more than
one process, so the fleet aggregator (``obs.fleet report``) computes it.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional

from .. import telemetry as _telemetry

__all__ = ["compute", "publish", "publish_model_flops", "peak_flops",
           "WaitAccrual", "WAIT_SINCE"]

PPM = 1e6
# gauge: the monotonic µs at which the feed's consumer began the wait it
# is in, 0 when it is not waiting (``io.datafeed``)
WAIT_SINCE = "datafeed.wait_since_us"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def peak_flops() -> float:
    """The peak FLOP/s MFU is measured against (0 = unset → no MFU):
    the peak of the card the step runs on, for the step's dtype."""
    return _env_float("MXNET_OBS_PEAK_FLOPS", 0.0)


def _win_sum_us(q: Optional[dict]) -> float:
    """µs accumulated in the window by one delta-quantile entry."""
    if not q:
        return 0.0
    return float(q.get("mean_us", 0.0)) * float(q.get("rate", 0.0))


class WaitAccrual:
    """The feed wait accrued up to each recorder frame: the completed
    waits' sum (``datafeed.wait_us``) plus the elapsed part of the wait in
    progress (:data:`WAIT_SINCE`).  :meth:`update` returns the µs that
    accrued since the previous frame.  The total is held monotone: the
    feed clears its gauge just before it records the wait, and a frame
    taken between the two reads the open part gone before the sum has it
    (the next frame's window gets it).  A registry reset (the sum falls)
    restarts the accrual."""

    def __init__(self):
        self._sum: Optional[float] = None
        self._total = 0.0

    def update(self, raw: dict, mono: float) -> Optional[float]:
        h = raw.get("histograms", {}).get("datafeed.wait_us")
        s = float(h.get("sum", 0.0)) if h else 0.0
        since = raw.get("gauges", {}).get(WAIT_SINCE) or 0
        total = s + (max(mono * 1e6 - since, 0.0) if since > 0 else 0.0)
        prev_sum, prev_total = self._sum, self._total
        self._sum = s
        if prev_sum is None or s < prev_sum:
            self._total = total
            return None
        self._total = max(total, prev_total)
        return self._total - prev_total


def _mean_us(h: Optional[dict]) -> Optional[float]:
    """The mean of a cumulative histogram snapshot, None when empty."""
    if not h or not h.get("count"):
        return None
    return float(h["sum"]) / float(h["count"])


def compute(frame: dict) -> Dict[str, float]:
    """Signals for one recorder frame (see module docstring); keys are
    present only when their inputs are — a report must distinguish
    'no serving tier' from 'goodput 0'."""
    rates = frame.get("rates", {})
    quants = frame.get("quantiles", {})
    gauges = frame.get("gauges", {})
    out: Dict[str, float] = {}

    step_q = quants.get("fused.step_us")
    step_us_per_s = _win_sum_us(step_q)         # µs of step per second
    if step_q:
        out["steps_per_s"] = float(step_q.get("rate", 0.0))
        if step_q.get("p50_us") is not None:
            out["step_p50_us"] = float(step_q["p50_us"])
    wait_us_per_s = _win_sum_us(quants.get("datafeed.wait_us"))
    accrued = frame.get("accrued_us", {}).get("datafeed.wait_us")
    if accrued is not None and frame.get("dt"):
        wait_us_per_s = accrued / frame["dt"]
    if step_us_per_s > 0.0:
        out["input_stall_frac"] = wait_us_per_s / step_us_per_s
        out["ckpt_pause_frac"] = \
            _win_sum_us(quants.get("checkpoint.pause_us")) / step_us_per_s
    elif accrued:
        # no step ended: the wait held back the one in progress
        step_us = _mean_us(frame.get("histograms", {}).get("fused.step_us"))
        if step_us:
            out["input_stall_frac"] = accrued / step_us

    offered = rates.get("serve.requests", 0.0)
    if offered > 0.0:
        good = (rates.get("serve.admitted", 0.0)
                - rates.get("serve.rejected", 0.0)
                - rates.get("serve.abandoned", 0.0))
        out["goodput"] = min(max(good / offered, 0.0), 1.0)

    out["retrace_rate"] = (rates.get("fused.retraces", 0.0)
                           + rates.get("serve.retraces", 0.0))

    depth = gauges.get("serve.queue_depth")
    if depth is not None:
        cap = max(_env_float("MXNET_SERVE_QUEUE_DEPTH", 256.0), 1.0)
        out["queue_frac"] = float(depth) / cap

    flops_step = gauges.get("obs.model_flops_per_step")
    peak = peak_flops()
    if flops_step and peak > 0.0 and step_q:
        out["mfu"] = float(flops_step) * float(step_q["rate"]) / peak

    return {k: v for k, v in out.items() if math.isfinite(v)}


# gauge name ↔ signal key; ppm fixed point (gauges are int64)
_PPM_GAUGES = {
    "input_stall_frac": "obs.input_stall_ppm",
    "ckpt_pause_frac": "obs.ckpt_pause_ppm",
    "goodput": "obs.goodput_ppm",
    "mfu": "obs.mfu_ppm",
    "queue_frac": "obs.queue_frac_ppm",
}


def publish(sig: Dict[str, float]):
    """Mirror one frame's signals into obs.* registry gauges."""
    for key, gname in _PPM_GAUGES.items():
        v = sig.get(key)
        if v is not None:
            _telemetry.gauge_set(gname, int(round(v * PPM)))


def publish_model_flops(net, *example_inputs) -> Optional[int]:
    """Price one training step of ``net`` on ``example_inputs`` and
    publish it as the ``obs.model_flops_per_step`` gauge: 3 × the
    forward's FLOPs from ``Block.flops`` (forward plus a backward of
    about twice its work).  Returns the step's FLOPs, or None when the
    net cannot be priced (never raises: observing must not fail
    training)."""
    try:
        fwd = net.flops(*example_inputs)
    except Exception:
        return None
    if not fwd:
        return None
    per_step = 3 * int(fwd)
    _telemetry.gauge_set("obs.model_flops_per_step", per_step)
    return per_step
