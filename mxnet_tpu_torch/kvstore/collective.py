"""Cross-process all-reduce for the dist KVStore over ``torch.distributed``
(≙ ``mxnet_tpu/kvstore/collective.py``).

Replaces the ps-lite ZPush/ZPull RPC data path of the reference
(``src/kvstore/kvstore_dist.h:682`` PushPullDefault) with one collective
per batch of keys: :meth:`CollectiveAllReduce.sum_batch` packs the whole
list (the Trainer's per-step gradient set) into one flat buffer per dtype
and all-reduces it once.  Under NCCL the buffer stays on the card; under
gloo a card's buffer is staged through a pinned host buffer (gloo reduces
host memory: the one-card host runs every rank on one card, which NCCL
refuses).  Each all-reduce counts its bytes (``collective.
allreduce_bytes``) and time (``collective.allreduce_us``).

``sum_packed`` is the compressed sync wire: each rank's quantized codes
cross packed (2-bit: 4 a byte; 1-bit: 8 a byte), are all-gathered, and
every rank unpacks and sums them in rank order, so all ranks hold the
same sum (≙ the reference's compressed push and server-side decompress
and sum, ``kvstore_dist_server.h:867``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as _onp
import torch

from .. import telemetry as _telemetry

__all__ = ["CollectiveAllReduce"]


class CollectiveAllReduce:
    """Cross-process sum over the default process group.  One instance
    per store."""

    def __init__(self):
        from ..parallel import dist as _dist
        self._nproc = _dist.size()
        self._backend = _dist.backend()
        self._pinned: Dict[Tuple, torch.Tensor] = {}

    @property
    def num_workers(self) -> int:
        return self._nproc

    def _host_buffer(self, like: torch.Tensor) -> torch.Tensor:
        key = (like.numel(), like.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(
                like.numel(), dtype=like.dtype, pin_memory=True)
        return buf

    def _all_reduce(self, flat: torch.Tensor):
        """Sum ``flat`` (1-D) over the ranks, in place."""
        import torch.distributed as tdist
        with _telemetry.timed("collective.allreduce_us"):
            if flat.is_cuda and self._backend != "nccl":
                host = self._host_buffer(flat)
                host.copy_(flat, non_blocking=True)
                torch.cuda.current_stream(flat.device).synchronize()
                tdist.all_reduce(host)
                flat.copy_(host, non_blocking=True)
            else:
                tdist.all_reduce(flat)
        _telemetry.counter_add("collective.allreduce_bytes",
                               flat.numel() * flat.element_size())

    def sum_batch(self, arrs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """All-reduce (sum over processes) a batch of local tensors: one
        collective a dtype and device over a flat buffer of the whole
        list.  Every process must enter with matching shapes, dtypes and
        order (the Trainer's symmetric pushpull).  → new tensors, views
        of the reduced buffer."""
        arrs = list(arrs)
        if self._nproc == 1 or not arrs:
            return arrs
        out: List[torch.Tensor] = [None] * len(arrs)
        groups: Dict[Tuple, List[int]] = {}
        for i, a in enumerate(arrs):
            groups.setdefault((a.dtype, a.device), []).append(i)
        for idx in groups.values():
            flat = torch.cat([arrs[i].detach().reshape(-1) for i in idx])
            self._all_reduce(flat)
            off = 0
            for i in idx:
                n = arrs[i].numel()
                out[i] = flat[off:off + n].view(arrs[i].shape)
                off += n
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum_batch([x])[0]

    def sum_host(self, a: _onp.ndarray) -> _onp.ndarray:
        """The element-wise sum of a small host array over the ranks."""
        if self._nproc == 1:
            return _onp.asarray(a)
        t = torch.from_numpy(_onp.ascontiguousarray(a)).clone()
        self._all_reduce(t.reshape(-1))
        return t.numpy()

    # -------------------------------------------- packed (2/1-bit) wire
    @staticmethod
    def _pack(q: torch.Tensor, bits: int) -> torch.Tensor:
        flat = q.reshape(-1)
        if bits == 2:
            codes = (flat > 0).to(torch.uint8) + 2 * (flat < 0).to(torch.uint8)
            pad = (-flat.numel()) % 4
            codes = torch.nn.functional.pad(codes, (0, pad)).view(-1, 4)
            return (codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4)
                    | (codes[:, 3] << 6))
        bit = (flat >= 0).to(torch.uint8)
        pad = (-flat.numel()) % 8
        b = torch.nn.functional.pad(bit, (0, pad)).view(-1, 8)
        acc = b[:, 0].clone()
        for i in range(1, 8):
            acc |= b[:, i] << i
        return acc

    @staticmethod
    def _unpack(g: torch.Tensor, n: int, bits: int) -> torch.Tensor:
        """(P, nbytes) uint8 → (P, n) float32 in {-1, 0, 1}."""
        if bits == 2:
            codes = torch.stack([(g >> s) & 3 for s in (0, 2, 4, 6)], -1) \
                .reshape(g.shape[0], -1)[:, :n]
            return (codes == 1).to(torch.float32) - \
                (codes == 2).to(torch.float32)
        b = torch.stack([(g >> s) & 1 for s in range(8)], -1) \
            .reshape(g.shape[0], -1)[:, :n]
        return b.to(torch.float32) * 2.0 - 1.0

    def sum_packed(self, qs: Sequence[torch.Tensor], thresholds,
                   bits: int = 2) -> List[torch.Tensor]:
        """Sum quantized {−t, 0, +t} gradients across processes with a
        PACKED uint8 wire: codes pack 4 a byte (2-bit) or 8 (1-bit), the
        packed bytes are all-gathered — (P−1)·n/16 wire bytes a process
        against ≈ 8·n/P for an fp32 ring all-reduce — and every process
        unpacks and sums them in rank order, then scales by t."""
        import torch.distributed as tdist
        qs = list(qs)
        if self._nproc == 1 or not qs:
            return qs
        out = []
        for q, thr in zip(qs, thresholds):
            packed = self._pack(q, bits)
            if packed.is_cuda and self._backend != "nccl":
                packed = packed.cpu()
            parts = [torch.empty_like(packed) for _ in range(self._nproc)]
            with _telemetry.timed("collective.allgather_us"):
                tdist.all_gather(parts, packed)
            _telemetry.counter_add("collective.allgather_bytes",
                                   packed.numel() * self._nproc)
            vals = self._unpack(torch.stack(parts).to(q.device), q.numel(),
                                bits)
            s = vals[0].clone()
            for r in range(1, self._nproc):
                s += vals[r]
            out.append((s * float(thr)).reshape(q.shape))
        return out
