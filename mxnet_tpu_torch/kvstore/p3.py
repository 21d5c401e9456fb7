"""P3 priority store (≙ ``mxnet_tpu/kvstore/p3.py``; reference
``src/kvstore/p3store_dist.h:39-119``, Priority-Based Parameter
Propagation).

The reference slices big tensors into MXNET_KVSTORE_SLICE_THRESHOLD-byte
chunks and pushes each slice tagged with the layer priority so
front-layer gradients overtake back-layer ones on the wire.  Here pending
pushpulls are staged in a priority queue and drained highest-priority
first at each synchronization point, slice by slice, each slice its own
all-reduce, so the order of the collectives is the reference's and the
API (``priority``, the slice threshold env) is drop-in.
"""
from __future__ import annotations

import heapq
import itertools
import os

import torch

from . import DistKVStore, _dense, _listify, _sum_list, _write, register


@register("p3")
class P3StoreDist(DistKVStore):
    """≙ P3StoreDist.  slice_threshold in ELEMENTS here (the reference's is
    bytes, MXNET_KVSTORE_SLICE_THRESHOLD p3store_dist.h:42)."""

    batched_pushpull = False    # priority staging is per-key

    def __init__(self, name="p3", **kwargs):
        super().__init__(name, **kwargs)
        self.slice_threshold = int(os.environ.get(
            "MXNET_KVSTORE_SLICE_THRESHOLD", 40000))
        self._queue = []            # (-priority, seq, work item)
        self._seq = itertools.count()
        self._defer = False

    def batch(self):
        """Deferred-drain window: pushpulls inside stage only; exit drains
        highest-priority first (the Trainer wraps its per-step gradient
        loop in this, ≙ P3 overlapping comm with backward)."""
        import contextlib

        @contextlib.contextmanager
        def _win():
            self._defer = True
            try:
                yield self
            finally:
                self._defer = False
                self.flush()
        return _win()

    def _slices(self, n):
        step = max(1, self.slice_threshold)
        return [(i, min(i + step, n)) for i in range(0, n, step)]

    def pushpull(self, key, value, out=None, priority=0):
        if isinstance(key, (list, tuple)):
            for i, k in enumerate(key):
                self.pushpull(k, value[i],
                              None if out is None else out[i], priority)
            return
        vals = _listify(value)
        agg = _sum_list([_dense(v) for v in vals])
        heapq.heappush(self._queue,
                       (-priority, next(self._seq), key, agg, vals, out))
        # Inside a batch() window pushpulls stage so the queue can really
        # reorder by priority at the drain (≙ P3's wire-level scheduling,
        # p3store_dist.h:39); a bare pushpull keeps the public contract
        # (out is filled on return) by draining immediately.
        if not self._defer:
            self.flush()
        return out

    def flush(self):
        """Drain pending work highest-priority first, slice by slice."""
        while self._queue:
            _, _, key, agg, vals, out = heapq.heappop(self._queue)
            flat = agg.reshape(-1)
            pieces = []
            for lo, hi in self._slices(flat.shape[0]):
                piece = flat[lo:hi]
                if self._compression is not None:
                    piece = self._compression.compress(f"{key}:{lo}", piece)
                pieces.append(self._global_sum(piece))
            full = torch.cat(pieces).reshape(agg.shape) \
                if len(pieces) > 1 else pieces[0].reshape(agg.shape)
            _write(vals if out is None else _listify(out), full)
