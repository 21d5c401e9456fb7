"""MXNET_SERVE_FAULT — serving-tier fault injection (≙
``mxnet_tpu/serve/faults.py``, a thin shim over the shared registry in
``mxnet_tpu_torch.faults``): the ``MXNET_SERVE_FAULT`` env var, sites
``server`` (HTTP front end, before the batcher) and ``batcher`` (around
the device execution), modes::

    MXNET_SERVE_FAULT = [site:]mode:prob[:ms]

    mode  delay       sleep `ms` (default 100) before proceeding
          error       fail the request (HTTP 500 / RequestError)
          black_hole  never answer: the server holds the socket `ms`
                      (default 30000) then drops it without a response;
                      the batcher strands the batch (events never set)
                      so callers hit their timeout → HTTP 504

Examples: ``error:0.2``, ``batcher:delay:1.0:25``,
``server:black_hole:0.1:5000``.  Every firing is counted as
``serve.fault.<site>.<mode>`` in telemetry.  Test/CI knob — never set
in production.

The delay mode doubles as a *synthetic service time*: the chaos harness
(chaos.py) sets ``batcher:delay:1.0:<ms>`` on its replicas so replica
throughput is sleep-bound and the router's 1→2 replica scaling is
measurable even on a single-core host.
"""
from __future__ import annotations

from typing import Optional, Tuple

from .. import faults as _faults
from ..faults import apply_delay  # noqa: F401 — re-exported API

__all__ = ["FAULT_ENV", "MODES", "SITES", "parse", "maybe", "apply_delay"]

FAULT_ENV = "MXNET_SERVE_FAULT"
MODES = _faults.IMPAIR_MODES
SITES = ("server", "batcher")

_DOMAIN = _faults.register(FAULT_ENV, sites=SITES,
                           counter_prefix="serve.fault")


def parse(raw: str) -> Optional[Tuple[str, str, float, float]]:
    """``[site:]mode:prob[:ms]`` → (site, mode, prob, seconds).
    Malformed specs raise ValueError — a typo'd fault knob silently
    doing nothing would defeat the point of injecting faults."""
    return _DOMAIN.parse(raw)


def maybe(site: str) -> Optional[Tuple[str, float]]:
    """Roll the dice for `site`; returns (mode, seconds) when a fault
    fires, else None.  Reads the env each call (cheap: cached parse)."""
    return _DOMAIN.maybe(site)
