"""Host staging pools (≙ ``mxnet_tpu/storage.py`` ``StoragePool`` over
the reference's pooled storage strategies, ``MXNET_CPU_MEM_POOL_TYPE``).

A pool hands out ``torch.uint8`` host buffers, pinned (page-locked, so a
``non_blocking`` copy to the card is a true DMA) when a card is present,
and keeps released ones by size class for reuse:

- ``Naive``: no pooling, a released buffer is dropped;
- ``Round`` (the default): size classes of the next power of two, from
  64 bytes;
- ``RoundMultiple``: size classes of the next multiple of
  ``round_multiple`` bytes.
"""
from __future__ import annotations

import os
import threading

import torch

__all__ = ["StoragePool", "get"]

_STRATEGIES = {"naive": 0, "round": 1, "roundmultiple": 2}
_ALIGN = 64


class StoragePool:
    def __init__(self, strategy=None, round_multiple=4096, pin_memory=None):
        if strategy is None:
            strategy = os.environ.get("MXNET_CPU_MEM_POOL_TYPE", "Round")
        self.strategy = _STRATEGIES.get(str(strategy).lower(), 1)
        self.round_multiple = int(round_multiple) or 4096
        if pin_memory is None:
            pin_memory = torch.cuda.is_available()
        self.pin_memory = bool(pin_memory)
        self._mu = threading.Lock()
        self._pools = {}        # size class -> [buffer]
        self._live = {}         # data_ptr -> (buffer, size class)
        self._n_alloc = 0
        self._n_hit = 0

    def _bucket(self, size):
        size = max(int(size), 1)
        if self.strategy == 1:
            b = _ALIGN
            while b < size:
                b <<= 1
            return b
        if self.strategy == 2:
            m = self.round_multiple
            return (size + m - 1) // m * m
        return size

    def alloc(self, size: int) -> torch.Tensor:
        """A host buffer of at least ``size`` bytes (its first ``size``
        bytes are the caller's), from the pool when one of its size class
        was released."""
        bucket = self._bucket(size)
        with self._mu:
            free = self._pools.get(bucket)
            buf = free.pop() if free else None
            self._n_alloc += 1
            if buf is not None:
                self._n_hit += 1
        if buf is None:
            buf = torch.empty(bucket, dtype=torch.uint8,
                              pin_memory=self.pin_memory)
        with self._mu:
            self._live[buf.data_ptr()] = (buf, bucket)
        return buf

    def buffer(self, size: int) -> torch.Tensor:
        """``alloc(size)`` cut to exactly ``size`` bytes (a view)."""
        return self.alloc(size)[:max(int(size), 1)]

    def _take_live(self, buf):
        with self._mu:
            entry = self._live.pop(buf.data_ptr(), None)
        if entry is None:
            raise KeyError("release of a buffer this pool does not hold")
        return entry

    def release(self, buf: torch.Tensor):
        """Give a buffer back: pooled for reuse, or dropped (``Naive``)."""
        whole, bucket = self._take_live(buf)
        if self.strategy == 0:
            return
        with self._mu:
            self._pools.setdefault(bucket, []).append(whole)

    def direct_free(self, buf: torch.Tensor):
        """Drop a buffer without pooling it."""
        self._take_live(buf)

    def release_all(self):
        """Drop every pooled (not live) buffer."""
        with self._mu:
            self._pools.clear()

    def stats(self):
        with self._mu:
            return {"bytes_live": sum(b for _, b in self._live.values()),
                    "bytes_pooled": sum(b * len(v)
                                        for b, v in self._pools.items()),
                    "n_alloc": self._n_alloc, "n_pool_hit": self._n_hit,
                    "pinned": self.pin_memory}


_default = None
_default_mu = threading.Lock()


def get() -> StoragePool:
    """The process's default pool (≙ ``Storage::Get()``)."""
    global _default
    with _default_mu:
        if _default is None:
            _default = StoragePool()
        return _default
