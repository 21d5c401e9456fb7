"""mxnet_tpu_torch.obs — the fleet observability plane (≙
``mxnet_tpu/obs``), on the port's telemetry registry and trace spans:

* :mod:`.recorder` — a per-process time-series sampler: a bounded ring
  of ``(t, snapshot)`` frames with counter → rate and histogram →
  delta-quantile derivations, persisted as newline-JSON shards under
  ``MXNET_OBS_DIR``;
* :mod:`.signals` — derived health signals (input-stall fraction,
  checkpoint pause overhead, serving goodput, MFU), published back as
  ``obs.*`` gauges;
* :mod:`.rules` — the declarative SLO watchdog evaluated on the
  recorder's frames (``obs.alerts.<rule>`` counters);
* :mod:`.fleet` — the cross-process aggregator (``scrape`` the fleet's
  ``/metrics`` and shards, ``report``);
* :mod:`.check` — the mini-fleet gate (``python -m mxnet_tpu_torch.obs
  --check``).

The recorder starts when this package is imported with
``MXNET_OBS_INTERVAL_MS`` > 0; ``mxnet_tpu_torch`` imports it only in
that case, so an unobserved process never pays for it.
"""
from __future__ import annotations

from .recorder import (Recorder, active, get, split_label,  # noqa: F401
                       start, stop)
from .rules import Rule, RuleEngine, seeded_rules           # noqa: F401
from .signals import compute, publish_model_flops           # noqa: F401

__all__ = [
    "Recorder", "start", "stop", "active", "get", "split_label",
    "Rule", "RuleEngine", "seeded_rules", "compute",
    "publish_model_flops", "bench_summary",
]

# importing the package with the knob set is the whole integration a
# trainer process needs
start()


def bench_summary() -> dict:
    """The ``obs`` block of a benchmark row when the recorder is on: the
    last window's derived signals, alert counts and recorder pressure."""
    rec = get()
    if rec is None:
        return {}
    frame = rec.last_frame()
    if frame is None:           # recorder younger than its interval:
        try:                    # take the window now
            frame = rec.sample_once()
        except Exception:
            frame = {}
    sig = dict(frame.get("signals", {}))
    if "steps_per_s" not in sig:
        # the timed loop may have ended mid-interval, leaving the last
        # window without steps: report the last window that saw some
        for past in reversed(rec.frames()):
            if "steps_per_s" in past.get("signals", {}):
                sig = dict(past["signals"])
                break
    alerts = {}
    for name, v in frame.get("counters", {}).items():
        if name.startswith("obs.alerts."):
            alerts[name[len("obs.alerts."):]] = v
    return {
        "input_stall_frac": sig.get("input_stall_frac"),
        "mfu": sig.get("mfu"),
        "goodput": sig.get("goodput"),
        "ckpt_pause_frac": sig.get("ckpt_pause_frac"),
        "steps_per_s": sig.get("steps_per_s"),
        "alerts": alerts,
        "frames": len(rec.frames()),
        "dropped_frames": rec.state()["dropped_frames"],
    }
