"""Declarative SLO watchdog rules over the recorder stream (≙
``mxnet_tpu/obs/rules.py``).

A :class:`Rule` is (metric, predicate, for-duration, hysteresis):

* ``metric`` — a key of a frame's evaluation view: derived signal names
  (``input_stall_frac``, ``goodput``, ...), counter rates
  (``rate:fused.retraces``), gauges (``gauge:serve.queue_depth``) and
  windowed quantiles (``p99:serve.e2e_us``);
* ``op`` / ``threshold`` — ``">"`` or ``"<"``;
* ``for_s`` — the predicate must hold this long before the rule FIRES;
* ``clear_threshold`` / ``clear_for_s`` — hysteresis: a firing rule
  clears only after the value sits on the good side of the looser clear
  threshold for ``clear_for_s``.

Firing and clearing emit a structured event (with the frame's signals),
count ``obs.alerts.<rule>`` on firing and log one line to stderr.  The
in-process recorder evaluates the engine each frame, and ``obs.fleet
report`` replays it over a merged fleet timeline (where ``straggler``,
which needs several ranks, fires).
"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional

from .. import telemetry as _telemetry

__all__ = ["Rule", "RuleEngine", "seeded_rules", "frame_view"]


def frame_view(frame: dict) -> Dict[str, float]:
    """Flatten one recorder frame into the rule-addressable namespace."""
    view: Dict[str, float] = {}
    for k, v in frame.get("signals", {}).items():
        view[k] = float(v)
    for k, v in frame.get("rates", {}).items():
        view[f"rate:{k}"] = float(v)
    for k, v in frame.get("gauges", {}).items():
        try:
            view[f"gauge:{k}"] = float(v)
        except (TypeError, ValueError):
            continue
    for k, q in frame.get("quantiles", {}).items():
        for tag, key in (("p50_us", "p50"), ("p99_us", "p99"),
                         ("mean_us", "mean"), ("rate", "hrate")):
            if q.get(tag) is not None:
                view[f"{key}:{k}"] = float(q[tag])
    return view


class Rule:
    """One threshold rule; see module docstring for the semantics."""

    __slots__ = ("name", "metric", "op", "threshold", "for_s",
                 "clear_threshold", "clear_for_s",
                 "state", "_since", "_clear_since")

    def __init__(self, name: str, metric: str, op: str, threshold: float,
                 for_s: float = 1.0, clear_threshold: Optional[float] = None,
                 clear_for_s: Optional[float] = None):
        if op not in (">", "<"):
            raise ValueError(f"rule {name}: op must be '>' or '<', got {op}")
        self.name = name
        self.metric = metric
        self.op = op
        self.threshold = float(threshold)
        self.for_s = float(for_s)
        self.clear_threshold = float(
            threshold if clear_threshold is None else clear_threshold)
        self.clear_for_s = float(
            for_s if clear_for_s is None else clear_for_s)
        self.state = "ok"               # ok | pending | firing
        self._since: Optional[float] = None
        self._clear_since: Optional[float] = None

    def _breaches(self, v: float) -> bool:
        return v > self.threshold if self.op == ">" else v < self.threshold

    def _clears(self, v: float) -> bool:
        # the clear threshold is on the GOOD side: strictly inside it
        return (v < self.clear_threshold if self.op == ">"
                else v > self.clear_threshold)

    def update(self, t: float, view: Dict[str, float]) -> Optional[dict]:
        """Advance the state machine; returns a "firing"/"cleared"
        event dict at the transition, else None.  A missing metric is
        'condition false' (it can still clear a firing rule only via
        the explicit clear path — absence of data is not health)."""
        v = view.get(self.metric)
        if self.state in ("ok", "pending"):
            if v is not None and self._breaches(v):
                if self._since is None:
                    self._since = t
                self.state = "pending"
                if t - self._since >= self.for_s:
                    self.state = "firing"
                    self._clear_since = None
                    return {"rule": self.name, "event": "firing", "t": t,
                            "metric": self.metric, "value": v,
                            "threshold": self.threshold}
            else:
                self.state = "ok"
                self._since = None
            return None
        # firing → hysteresis clear
        if v is not None and self._clears(v):
            if self._clear_since is None:
                self._clear_since = t
            if t - self._clear_since >= self.clear_for_s:
                self.state = "ok"
                self._since = None
                self._clear_since = None
                return {"rule": self.name, "event": "cleared", "t": t,
                        "metric": self.metric, "value": v,
                        "threshold": self.clear_threshold}
        else:
            self._clear_since = None
        return None


class RuleEngine:
    """Evaluate a rule set over a stream of frames; keeps the bounded
    event log that the obs check and dumps read back."""

    MAX_EVENTS = 256

    def __init__(self, rules: List[Rule], log=None):
        self.rules = list(rules)
        self.events: List[dict] = []
        self._log = sys.stderr if log is None else log

    def update(self, frame: dict, t: Optional[float] = None) -> List[dict]:
        """One evaluation step; returns the transition events it fired."""
        t = frame.get("mono") if t is None else t
        if t is None:
            t = time.monotonic()
        view = frame_view(frame)
        out: List[dict] = []
        for rule in self.rules:
            ev = rule.update(t, view)
            if ev is None:
                continue
            ev["frame"] = {"t": frame.get("t"),
                           "signals": frame.get("signals", {})}
            out.append(ev)
            if ev["event"] == "firing":
                _telemetry.counter_add(f"obs.alerts.{rule.name}")
            try:
                self._log.write("[mxnet_tpu_torch.obs] alert %s %s: %s\n"
                                % (rule.name, ev["event"],
                                   json.dumps(ev, default=str)))
            except Exception:
                pass
        self.events.extend(out)
        del self.events[:-self.MAX_EVENTS]
        return out

    def firing(self) -> List[str]:
        return [r.name for r in self.rules if r.state == "firing"]

    def summary(self) -> dict:
        return {"rules": {r.name: r.state for r in self.rules},
                "events": list(self.events)}


def seeded_rules() -> List[Rule]:
    """The default watchdog (thresholds are starting points, not
    SLAs)."""
    return [
        # the accelerator is waiting on the input pipeline more than
        # half of every step
        Rule("input_starved", "input_stall_frac", ">", 0.5,
             for_s=1.0, clear_threshold=0.25, clear_for_s=1.0),
        # under offered load, less than half of requests do useful work
        Rule("goodput_collapse", "goodput", "<", 0.5,
             for_s=1.0, clear_threshold=0.8, clear_for_s=1.0),
        # slowest dp rank's step p50 runs >50% above the fleet spread
        # (aggregator-computed signal; inert in a single process)
        Rule("straggler", "straggler_skew", ">", 0.5,
             for_s=1.0, clear_threshold=0.25, clear_for_s=1.0),
        # steady-state recompilation: shapes/dtypes are churning
        Rule("retrace_storm", "retrace_rate", ">", 2.0,
             for_s=1.0, clear_threshold=0.5, clear_for_s=1.0),
        # admission queue persistently near its bound — rejects are next
        Rule("queue_saturation", "queue_frac", ">", 0.8,
             for_s=1.0, clear_threshold=0.5, clear_for_s=1.0),
    ]
