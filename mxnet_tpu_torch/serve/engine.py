"""InferenceEngine — one model served over a ladder of batch buckets
(≙ ``mxnet_tpu/serve/engine.py`` ``InferenceEngine``, ``bucket_ladder``,
``resolve_precision``).

The reference lifts the net into a pure function and compiles one
donated XLA program per bucket.  The port runs the net eagerly: the
engine puts it in inference mode on its device, runs it under
``torch.inference_mode()``, and :meth:`InferenceEngine.warmup` runs
every bucket once, which builds the CUDA kernel library and lets cuDNN
choose its algorithms before traffic arrives.  Nothing is traced, so
nothing can retrace: ``retraces`` and ``rebuilds`` stay 0 and
``programs`` counts the buckets warmed.

Items are float32 (images) or integer token ids (int32 or int64): the
engine casts every batch to its ``dtype`` and resolves deferred shapes,
warms and runs on batches of that dtype.  ``precision="bf16"`` casts the
net on its device with ``amp.convert_model`` (every floating parameter
and running statistic to bf16) and serves float items as bf16 (integer
items stay integer), as the reference does; on the card the net then
runs the bf16 instances of the softmax and ``conv_affine`` kernels, and
the batcher widens bf16 outputs to fp32 on the host (exact: numpy has no
bf16).  ``precision="int8"`` quantizes the net in place on its device
(``quantization.quantize_net``, naive calibration on ``calib_data``, or
on the reference's two seeded uniform batches), unless it already holds
int8 twins.  ``mesh=`` and ``sharding_plan=`` raise and name the slice
that brings them.
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import context as _context
from .. import quantization as _q
from .. import telemetry as _telemetry
from ..gluon.parameter import dtype_name, is_initialized

__all__ = ["InferenceEngine", "DEFAULT_BUCKETS", "PRECISIONS",
           "bucket_ladder", "resolve_precision"]

DEFAULT_BUCKETS = (1, 2, 4, 8)

PRECISIONS = ("fp32", "bf16", "int8")

# item dtypes the engine serves, as numpy names → torch dtypes
_ITEM_DTYPES = {"float32": torch.float32, "int32": torch.int32,
                "int64": torch.int64}


def resolve_precision(precision: Optional[str] = None) -> str:
    """The serving precision: explicit argument >
    ``MXNET_SERVE_PRECISION`` > fp32, normalised (``float32`` → ``fp32``,
    ``bfloat16`` → ``bf16``)."""
    p = str(precision or os.environ.get("MXNET_SERVE_PRECISION", "")
            or "fp32").lower()
    p = {"float32": "fp32", "bfloat16": "bf16"}.get(p, p)
    if p not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not one of {PRECISIONS}")
    return p


def bucket_ladder(buckets: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """The bucket ladder: explicit argument, else ``MXNET_SERVE_BUCKETS``
    (comma list), else (1, 2, 4, 8).  Sorted, deduplicated, all >= 1."""
    if buckets is None:
        env = os.environ.get("MXNET_SERVE_BUCKETS", "")
        if env.strip():
            buckets = [int(t) for t in env.split(",") if t.strip()]
        else:
            buckets = DEFAULT_BUCKETS
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise ValueError(f"invalid bucket ladder {buckets!r}")
    return out


class InferenceEngine:
    """One model in inference mode over a bucket ladder.

    Parameters
    ----------
    net : gluon Block
        The model, with its parameters loaded or initialized (deferred
        shapes are resolved by one forward at ``buckets[0]``).  It is put
        in ``eval()`` and moved to ``device``.
    item_shape : tuple
        Shape of ONE request item (no batch dim), e.g. ``(224, 224, 3)``.
    dtype : str
        Item dtype: ``float32``, or ``int32`` / ``int64`` for token ids.
    buckets : sequence of int, optional
        Batch-size ladder; default from ``MXNET_SERVE_BUCKETS``.
    precision : str, optional
        ``fp32``, ``bf16`` (also ``bfloat16``) or ``int8`` (explicit,
        else ``MXNET_SERVE_PRECISION``, else fp32).  bf16 casts the net
        in place (``amp.convert_model``) and serves float items as bf16;
        ``stats()`` then reports ``dtype`` ``"bfloat16"``.
    calib_data : iterable, optional
        Calibration batches for ``precision="int8"``; default two batches
        of ``RandomState(0)`` uniform [-1, 1) shaped ``(buckets[0],
        *item_shape)``, as the reference makes them.
    device : optional
        Default: the current CUDA device; raises without a card unless
        ``device="cpu"`` is given.
    """

    def __init__(self, net, item_shape, dtype: str = "float32",
                 buckets: Optional[Sequence[int]] = None,
                 name: str = "default", precision: Optional[str] = None,
                 calib_data=None, mesh=None, sharding_plan=None,
                 device=None):
        self.precision = resolve_precision(precision)
        if mesh is not None or sharding_plan is not None:
            raise NotImplementedError(
                "mesh=/sharding_plan=: tensor-parallel serving comes with "
                "the tensor-parallel slice (NCCL), not ported yet")
        self.dtype = np.dtype(dtype)
        if self.dtype.name not in _ITEM_DTYPES:
            raise TypeError(f"dtype {dtype!r}: the port serves items of "
                            f"{sorted(_ITEM_DTYPES)}")
        self._tdtype = _ITEM_DTYPES[self.dtype.name]
        # the dtype batches reach the net in: bf16 for float items served
        # in bf16, as the reference serves them
        self._run_dtype = torch.bfloat16 if self.precision == "bf16" and \
            self._tdtype.is_floating_point else self._tdtype
        self.device = _context.resolve(device)
        if self.device.type == "cuda":
            _context.exact_fp32()
        self.net = net
        self.name = name
        self.item_shape = tuple(int(d) for d in item_shape)
        self.buckets = bucket_ladder(buckets)
        net.eval()
        params = net.collect_params().values()
        if not all(is_initialized(t) for t in params):
            # deferred shapes resolve where the initialized tensors live
            # (the CPU when none is), then the net moves (not under
            # inference_mode: its tensors could not be moved after)
            where = {t.device for t in params if is_initialized(t)}
            where = where.pop() if len(where) == 1 else "cpu"
            with torch.no_grad():
                net(self._zeros(self.buckets[0], where, self._tdtype))
        net.to(self.device)
        if self.precision == "bf16":
            from .. import amp as _amp
            _amp.convert_model(net, "bfloat16")
        elif self.precision == "int8":
            self._quantize(net, calib_data)
        # parameters and buffers: an int8 net's weights are buffers
        self.param_bytes = sum(t.numel() * t.element_size()
                               for t in itertools.chain(net.parameters(),
                                                        net.buffers()))
        _telemetry.gauge_set("serve.param_bytes_per_device",
                             self.param_bytes)
        self._warmed = set()
        self._warm = False
        self.retraces = 0
        self.rebuilds = 0
        self.forwards = 0           # every forward run, warmups included
        self._mu = threading.Lock()
        _telemetry.counter_add(f"serve.precision.builds.{self.precision}")

    def _quantize(self, net, calib_data):
        """Quantize ``net`` in place for ``precision="int8"``, unless it
        already holds int8 twins (quantized offline), which pass through
        untouched."""
        if any(isinstance(b, _q._Twin) for b in net.modules()):
            return
        if calib_data is None:
            rs = np.random.RandomState(0)
            calib_data = [(rs.rand(self.buckets[0], *self.item_shape) * 2.0
                           - 1.0).astype("float32") for _ in range(2)]
        _q.quantize_net(net, calib_data=calib_data, calib_mode="naive")

    def _zeros(self, b, device, dtype=None):
        return torch.zeros((b,) + self.item_shape,
                           dtype=dtype or self._run_dtype, device=device)

    def _forward(self, x):
        with self._mu:
            self.forwards += 1
        with torch.inference_mode():
            out = self.net(x)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def warmup(self):
        """Run every bucket once on a zero batch and wait for the card.
        The first launch builds the CUDA kernel library."""
        with _telemetry.timed("serve.warmup_us"):
            for b in self.buckets:
                self._forward(self._zeros(b, self.device))
                with self._mu:
                    self._warmed.add(b)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        with self._mu:
            self._warm = True
        _telemetry.gauge_set("serve.programs", len(self._warmed))
        return self

    def warm_thread(self):
        """Run the smallest bucket once on the calling thread, if the
        engine is warm.  PyTorch keeps its cuDNN and cuBLAS handles per
        thread, so a serving thread's first forward would otherwise make
        them while a request waits."""
        if self._warm:
            self._forward(self._zeros(self.buckets[0], self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    @property
    def warm(self) -> bool:
        return self._warm

    @property
    def ready(self) -> bool:
        """Readiness for traffic: every bucket has run once.  The
        readiness-aware ``/healthz`` (server.py) reports the model as
        ``warming`` (503) until this flips, so a router never sends
        traffic to a replica that would build kernels on the serving
        path."""
        return self._warm

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding n items; raises for n > max bucket."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} exceeds max bucket "
                         f"{self.buckets[-1]}")

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def run(self, x) -> Tuple:
        """Forward a batch whose size is exactly a bucket (the batcher
        pads to one).  ``x`` is a numpy array or tensor of
        ``(b,) + item_shape``; returns the tuple of output tensors on the
        engine's device, not synchronized."""
        x = torch.as_tensor(x, dtype=self._run_dtype, device=self.device)
        b = int(x.shape[0])
        if b not in self.buckets:
            raise ValueError(f"batch size {b} is not a bucket of "
                             f"{self.buckets}")
        if tuple(x.shape[1:]) != self.item_shape:
            raise ValueError(f"item shape {tuple(x.shape[1:])} is not "
                             f"{self.item_shape}")
        _telemetry.counter_add(f"serve.precision.batches.{self.precision}")
        with _telemetry.span("serve.engine_run", model=self.name, bucket=b):
            return self._forward(x.contiguous())

    def trace_counts(self):
        """Runs at warmup per bucket (the reference counts traces)."""
        with self._mu:
            return {b: int(b in self._warmed) for b in self.buckets}

    def stats(self) -> dict:
        """The reference's keys (``dtype``: what batches reach the net
        in, ``"bfloat16"`` for float items at bf16).  ``retraces``/
        ``rebuilds`` are always 0:
        the forward runs eagerly and nothing is traced or compiled per
        bucket.  ``programs`` is the number of buckets warmed; ``tp`` is 1
        and ``plan_fingerprint`` None (no tensor parallelism)."""
        return {
            "name": self.name,
            "item_shape": list(self.item_shape),
            "dtype": dtype_name(self._run_dtype),
            "precision": self.precision,
            "buckets": list(self.buckets),
            "warm": self._warm,
            "ready": self.ready,
            "retraces": self.retraces,
            "rebuilds": self.rebuilds,
            "trace_counts": self.trace_counts(),
            "tp": 1,
            "plan_fingerprint": None,
            "param_bytes_per_device": self.param_bytes,
            "programs": len(self._warmed),
            "forwards": self.forwards,
            "device": str(self.device),
        }
