"""Shared fault-injection registry (≙ ``mxnet_tpu/faults.py``): one
parser for every fault knob, a copy of the reference's stdlib-only code.

A subsystem declares *where* faults can land (its sites) and *which*
shapes they take (its modes), and gets the shared spec grammar and
counter convention::

    MXNET_<X>_FAULT = [site:]mode[:prob[:ms]]

    site  one of the domain's registered sites (default: the first)
    mode  one of the domain's registered modes
    prob  per-event firing probability in [0, 1] (default 1.0)
    ms    mode-specific duration in milliseconds (default per mode)

Every firing is counted as ``<counter_prefix>.<site>.<mode>`` in
telemetry.  Malformed specs raise ``ValueError``: a typo'd fault knob
silently doing nothing would defeat the point of injecting faults.  The
env is re-read on every ``maybe()`` call (tests flip it live); the
split/validate work is cached on the raw string.

Domains the port registers:

- ``MXNET_CKPT_FAULT``  — site ``commit``; modes ``torn_write`` /
  ``bitflip`` / ``crash_after_tmp`` (checkpoint.py).
- ``MXNET_SERVE_FAULT`` — sites ``server`` / ``batcher``; modes
  ``delay`` / ``error`` / ``black_hole`` (serve/faults.py).

Test/CI knobs — never set in production.
"""
from __future__ import annotations

import os
import random
import time
from typing import Dict, Optional, Tuple

from . import telemetry as _telemetry

__all__ = ["FaultDomain", "register", "domains", "apply_delay",
           "IMPAIR_MODES"]

# the impairment modes shared by the request/response-shaped domains
# (serve + feed): sleep, fail, or strand the caller
IMPAIR_MODES = ("delay", "error", "black_hole")
_IMPAIR_DEFAULT_MS = {"delay": 100.0, "error": 0.0, "black_hole": 30000.0}


class FaultDomain:
    """One fault knob: an env var, its sites, its modes, its counters."""

    def __init__(self, env: str, sites: Tuple[str, ...],
                 modes: Tuple[str, ...], counter_prefix: str,
                 default_ms: Optional[Dict[str, float]] = None):
        if not sites or not modes:
            raise ValueError(f"{env}: sites and modes must be non-empty")
        self.env = env
        self.sites = tuple(sites)
        self.modes = tuple(modes)
        self.counter_prefix = counter_prefix
        self.default_ms = dict(default_ms or {})
        self._cached_raw: Optional[str] = None
        self._cached: Optional[Tuple[str, str, float, float]] = None

    def parse(self, raw: str) -> Tuple[str, str, float, float]:
        """``[site:]mode[:prob[:ms]]`` → (site, mode, prob, seconds)."""
        parts = [p.strip() for p in raw.split(":")]
        site = self.sites[0]
        if parts and parts[0] in self.sites:
            site = parts.pop(0)
        if not parts or parts[0] not in self.modes:
            raise ValueError(
                f"{self.env}={raw!r}: mode must be one of {self.modes} "
                f"(optionally prefixed by {self.sites})")
        mode = parts.pop(0)
        prob = float(parts.pop(0)) if parts else 1.0
        if not 0.0 <= prob <= 1.0:
            raise ValueError(
                f"{self.env}={raw!r}: prob {prob} not in [0,1]")
        ms = float(parts.pop(0)) if parts \
            else self.default_ms.get(mode, 0.0)
        if parts:
            raise ValueError(
                f"{self.env}={raw!r}: trailing fields {parts}")
        return site, mode, prob, ms / 1000.0

    def maybe(self, site: str) -> Optional[Tuple[str, float]]:
        """Roll the dice for `site`; returns (mode, seconds) when a
        fault fires, else None.  Reads the env each call (cached
        parse), counts every firing."""
        raw = os.environ.get(self.env, "")
        if raw != self._cached_raw:
            self._cached = self.parse(raw) if raw.strip() else None
            self._cached_raw = raw
        if self._cached is None:
            return None
        f_site, mode, prob, secs = self._cached
        if f_site != site:
            return None
        if prob < 1.0 and random.random() >= prob:
            return None
        _telemetry.counter_add(f"{self.counter_prefix}.{site}.{mode}")
        return mode, secs


_REGISTRY: Dict[str, FaultDomain] = {}


def register(env: str, sites, modes=IMPAIR_MODES, counter_prefix=None,
             default_ms: Optional[Dict[str, float]] = None) -> FaultDomain:
    """Register (or fetch — idempotent per env) a fault domain.  The
    default modes/durations are the request-impairment set; a domain
    with its own failure shapes (checkpoint commits) passes its own."""
    dom = _REGISTRY.get(env)
    if dom is not None:
        return dom
    if modes is IMPAIR_MODES and default_ms is None:
        default_ms = _IMPAIR_DEFAULT_MS
    dom = FaultDomain(env, tuple(sites), tuple(modes),
                      counter_prefix or env.lower(), default_ms)
    _REGISTRY[env] = dom
    return dom


def domains() -> Dict[str, FaultDomain]:
    """The live registry (env → domain), for introspection/tests."""
    return dict(_REGISTRY)


def apply_delay(secs: float):
    time.sleep(secs)
