"""ModelRegistry — several models served side by side
(≙ ``mxnet_tpu/serve/registry.py``).

Each registered model owns one :class:`InferenceEngine` and one
:class:`Batcher` (its own queue, deadline and admission control), so one
model's full queue sheds its own load without touching another's.  The
registry is an LRU capped at ``MXNET_SERVE_MAX_MODELS`` (4): loading
past the cap evicts the least recently predicted model, whose batcher
drains.

Models load from a ``.params`` file written by ``save_parameters`` (by
this package or by the JAX package: the format is the same).  A
``CheckpointManager`` directory raises until ``checkpoint.py`` is
ported.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional, Sequence

from .. import telemetry as _telemetry
from .batcher import Batcher, _env_int
from .engine import InferenceEngine

__all__ = ["ModelRegistry", "ModelEntry"]


class ModelEntry:
    __slots__ = ("name", "net", "engine", "batcher", "source")

    def __init__(self, name, net, engine, batcher, source=None):
        self.name = name
        self.net = net
        self.engine = engine
        self.batcher = batcher
        self.source = source

    def stats(self) -> dict:
        out = self.engine.stats()
        out["batcher"] = self.batcher.stats()
        out["source"] = self.source
        return out


class ModelRegistry:
    """Named models → (engine, batcher), LRU-capped.  ``device`` is the
    default for every model (the current GPU unless ``"cpu"``)."""

    def __init__(self, max_models: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 precision: Optional[str] = None,
                 mesh=None, sharding_plan=None, device=None):
        self.max_models = _env_int("MXNET_SERVE_MAX_MODELS", 4) \
            if max_models is None else int(max_models)
        self._buckets = buckets
        self._max_wait_ms = max_wait_ms
        self._queue_depth = queue_depth
        self._precision = precision
        self._mesh = mesh
        self._sharding_plan = sharding_plan
        self._device = device
        self._mu = threading.RLock()
        self._models: "OrderedDict[str, ModelEntry]" = OrderedDict()

    # ------------------------------------------------------------ register
    def register(self, name: str, net, item_shape, dtype: str = "float32",
                 buckets: Optional[Sequence[int]] = None,
                 warmup: bool = True, source: Optional[str] = None,
                 precision: Optional[str] = None, calib_data=None,
                 mesh=None, sharding_plan=None,
                 device=None) -> ModelEntry:
        """Wrap an initialized net into an engine + batcher under
        ``name``.  Re-registering a name replaces the old entry (its
        batcher drains); exceeding ``max_models`` evicts the LRU entry.
        ``precision=`` overrides the registry's default (which falls back
        to ``MXNET_SERVE_PRECISION``); ``calib_data`` goes to the engine
        for ``precision="int8"``."""
        engine = InferenceEngine(
            net, item_shape, dtype=dtype,
            buckets=buckets if buckets is not None else self._buckets,
            name=name,
            precision=precision if precision is not None
            else self._precision,
            calib_data=calib_data,
            mesh=mesh if mesh is not None else self._mesh,
            sharding_plan=sharding_plan if sharding_plan is not None
            else self._sharding_plan,
            device=device if device is not None else self._device)
        if warmup:
            engine.warmup()
        batcher = Batcher(engine, max_wait_ms=self._max_wait_ms,
                          queue_depth=self._queue_depth, name=name)
        entry = ModelEntry(name, net, engine, batcher, source=source)
        evicted = []
        with self._mu:
            old = self._models.pop(name, None)
            if old is not None:
                evicted.append(old)
                _telemetry.counter_add("serve.swaps")
            self._models[name] = entry
            while len(self._models) > max(1, self.max_models):
                _, lru = self._models.popitem(last=False)
                evicted.append(lru)
                _telemetry.counter_add("serve.evictions")
            _telemetry.gauge_set("serve.models", len(self._models))
        for e in evicted:
            e.batcher.close()
        return entry

    def load(self, name: str, source: str, net=None,
             arch: Optional[str] = None, item_shape=None,
             dtype: str = "float32",
             buckets: Optional[Sequence[int]] = None,
             warmup: bool = True, precision: Optional[str] = None,
             calib_data=None, mesh=None, sharding_plan=None, device=None,
             **model_kwargs) -> ModelEntry:
        """Load weights from the ``.params`` file ``source`` into ``net``
        (or a fresh ``models.get_model(arch, **model_kwargs)``) and
        register the model."""
        if os.path.isdir(source):
            raise NotImplementedError(
                f"{source!r} is a checkpoint directory: restoring a "
                f"CheckpointManager root needs checkpoint.py, which is not "
                f"ported yet; load a .params file from save_parameters")
        if net is None:
            if arch is None:
                raise ValueError("load() needs net= or arch=")
            from ..models import get_model
            net = get_model(arch, **model_kwargs)
        if item_shape is None:
            raise ValueError("load() needs item_shape= (one item, no batch "
                             "dim)")
        net.load_parameters(source)
        net.hybridize()
        return self.register(name, net, item_shape, dtype=dtype,
                             buckets=buckets, warmup=warmup, source=source,
                             precision=precision, calib_data=calib_data,
                             mesh=mesh, sharding_plan=sharding_plan,
                             device=device)

    # ------------------------------------------------------------ dispatch
    def get(self, name: str) -> ModelEntry:
        with self._mu:
            entry = self._models.get(name)
            if entry is None:
                raise KeyError(f"model {name!r} is not registered (have "
                               f"{list(self._models)})")
            self._models.move_to_end(name)      # LRU touch
            return entry

    def predict(self, name: str, x, timeout: Optional[float] = None):
        """Blocking predict against model ``name`` through its batcher."""
        return self.get(name).batcher.submit(x, timeout=timeout)

    # --------------------------------------------------------------- admin
    def names(self):
        with self._mu:
            return list(self._models)

    def stats(self) -> dict:
        with self._mu:
            entries = list(self._models.values())
        return {"max_models": self.max_models,
                "models": {e.name: e.stats() for e in entries}}

    def close(self):
        with self._mu:
            entries = list(self._models.values())
            self._models.clear()
            _telemetry.gauge_set("serve.models", 0)
        for e in entries:
            e.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
