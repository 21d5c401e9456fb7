"""Batching for the port's serving (≙ ``mxnet_tpu/serve/batcher.py``).

``Batcher`` is request-level continuous batching over one
:class:`~mxnet_tpu_torch.serve.engine.InferenceEngine`: queued requests
coalesce into the engine's bucket ladder under a max-wait deadline,
partial batches are padded with zeros (the pad rows are computed and
discarded), and each caller gets its own slice of the one forward.
Admission control is a bounded queue counted in items (``QueueFull``);
a ``submit`` that times out tombstones its request, which the coalescer
then skips (``serve.abandoned``).  ``MXNET_SERVE_FAULT=batcher:...``
(faults.py) injects a delay, an error or a black hole around the
device execution, as the reference's does.  The reference's trace links
(a batch span naming the request spans it served) are not ported.

``DecodeBatcher`` is token-level continuous batching over one decode
engine: a persistent B-row decode batch where each row (slot) hosts one
in-flight generation, and requests join and leave at iteration
boundaries.  A joining request is prefilled into a free row of the
batch's ctl block (``DecodeEngine.join``) while every other row keeps
decoding, and a finished row frees its slot without stalling the rest.
"""
from __future__ import annotations

import os
import queue
import random
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Optional, Tuple

import numpy as np
import torch

from .. import telemetry as _telemetry
from . import faults as _faults

__all__ = ["Batcher", "DecodeBatcher", "QueueFull", "RequestError",
           "BatcherClosed"]

_US = 1e6


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def _host(t):
    """A forward's output as a numpy array on the host: bf16 copied as
    bf16 and widened to fp32 there (exact; numpy has no bf16)."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class QueueFull(Exception):
    """Admission control: the bounded request queue is at capacity."""


class BatcherClosed(RuntimeError):
    """The batcher was closed (drained by a warm swap or an eviction)
    before this request was queued."""


class RequestError(Exception):
    """The device execution for this request's batch failed."""


def _on_device(dev):
    """The loop thread's device context (its kernels launch on that
    device's current stream)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


class _Request:
    __slots__ = ("x", "n", "event", "result", "error", "t_submit",
                 "abandoned")

    def __init__(self, x, n):
        self.x = x
        self.n = n
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_submit = time.perf_counter()
        self.abandoned = False


class Batcher:
    """Request-level continuous batching over one
    :class:`~mxnet_tpu_torch.serve.engine.InferenceEngine`.

    A daemon thread (``serve-batcher-<name>``) waits for queued requests,
    coalesces up to ``max_bucket`` items — flushing early when the
    oldest request has waited ``max_wait_ms`` (default 5,
    ``MXNET_SERVE_MAX_WAIT_MS``) — and runs one padded bucket per flush.
    ``submit(x)`` blocks the caller until its slice of the response is
    ready; ``submit_async(x)`` returns a handle with ``.event`` /
    ``.result`` / ``.error``.  Queue depth in items:
    ``MXNET_SERVE_QUEUE_DEPTH`` (256); default wait:
    ``MXNET_SERVE_TIMEOUT_MS`` (30 s).  The loop thread first runs the
    engine's ``warm_thread`` (one forward of the smallest bucket, making
    the thread's cuDNN and cuBLAS handles) and the constructor returns
    after it, so no request waits for that.
    """

    def __init__(self, engine, max_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 name: Optional[str] = None):
        self.engine = engine
        self.name = name or engine.name
        self.max_wait_s = (_env_float("MXNET_SERVE_MAX_WAIT_MS", 5.0)
                           if max_wait_ms is None else float(max_wait_ms)) \
            / 1000.0
        self.queue_depth = _env_int("MXNET_SERVE_QUEUE_DEPTH", 256) \
            if queue_depth is None else int(queue_depth)
        self.timeout_s = _env_float("MXNET_SERVE_TIMEOUT_MS", 30000.0) / 1e3
        self._cv = threading.Condition()
        self._q: "deque[_Request]" = deque()
        self._qn = 0            # queued items (rows), not requests
        self._closed = False
        # EWMA of per-item service time, for retry_after_s()
        self._ewma_item_s = 0.0
        self._started = threading.Event()
        self._start_error = None
        self._thread = threading.Thread(
            target=self._loop, name=f"serve-batcher-{self.name}",
            daemon=True)
        self._thread.start()
        self._started.wait()
        if self._start_error is not None:
            raise self._start_error

    # ------------------------------------------------------------- ingress
    def _normalize(self, x) -> Tuple[np.ndarray, int]:
        item = self.engine.item_shape
        a = np.asarray(x, dtype=self.engine.dtype)
        if a.shape == item:
            return a.reshape((1,) + item), 1
        if a.ndim == len(item) + 1 and a.shape[1:] == item:
            n = int(a.shape[0])
            if n < 1:
                raise ValueError("empty request batch")
            if n > self.engine.max_bucket:
                raise ValueError(f"request batch {n} exceeds max bucket "
                                 f"{self.engine.max_bucket}")
            return a, n
        raise ValueError(f"request shape {a.shape} matches neither item "
                         f"{item} nor (n,)+{item}")

    def submit_async(self, x) -> _Request:
        """Enqueue one request (an item or a small batch of items);
        returns its handle without waiting.  Raises :class:`QueueFull`
        when admission control rejects it."""
        a, n = self._normalize(x)
        req = _Request(a, n)
        _telemetry.counter_add("serve.requests")
        with self._cv:
            if self._closed:
                raise BatcherClosed(f"batcher {self.name!r} is closed")
            if self._qn + n > self.queue_depth:
                _telemetry.counter_add("serve.rejected")
                raise QueueFull(f"queue at {self._qn}/{self.queue_depth} "
                                f"items")
            self._q.append(req)
            self._qn += n
            _telemetry.gauge_set("serve.queue_depth", self._qn)
            self._cv.notify()
        _telemetry.counter_add("serve.admitted")
        return req

    def submit(self, x, timeout: Optional[float] = None):
        """Blocking predict: the tuple of numpy outputs for this request's
        rows.  On timeout the request is tombstoned: if still queued it
        is never run, and the coalescer counts it ``serve.abandoned``."""
        req = self.submit_async(x)
        if not req.event.wait(self.timeout_s if timeout is None
                              else timeout):
            with self._cv:
                if not req.event.is_set():
                    req.abandoned = True
                    raise TimeoutError(
                        f"request not served within timeout (batcher "
                        f"{self.name!r}, queued={self._qn})")
            # served in the window between wait() and the lock
        if req.error is not None:
            raise RequestError(str(req.error)) from req.error
        return req.result

    def retry_after_s(self) -> float:
        """Retry-After estimate: queued items × the EWMA per-item service
        time, jittered ±25%; ~1 s before any batch has been measured."""
        with self._cv:
            qn, per_item = self._qn, self._ewma_item_s
        est = qn * per_item if per_item > 0.0 else 1.0
        return max(0.05, est) * random.uniform(0.75, 1.25)

    # ---------------------------------------------------------------- loop
    def _sweep_abandoned_locked(self):
        swept = 0
        while self._q and self._q[0].abandoned:
            r = self._q.popleft()
            self._qn -= r.n
            swept += 1
        if swept:
            _telemetry.counter_add("serve.abandoned", swept)
            _telemetry.gauge_set("serve.queue_depth", self._qn)

    def _loop(self):
        maxb = self.engine.max_bucket
        with _on_device(self.engine.device):
            warm = getattr(self.engine, "warm_thread", None)
            try:
                if warm is not None:
                    warm()      # this thread's library handles, up front
            except Exception as e:      # re-raised by the constructor
                self._start_error = e
                return
            finally:
                self._started.set()
            while True:
                batch, taken = [], 0
                with self._cv:
                    self._sweep_abandoned_locked()
                    while not self._q and not self._closed:
                        self._cv.wait()
                        self._sweep_abandoned_locked()
                    if not self._q and self._closed:
                        return
                    # fill-or-deadline: wait for more items until the
                    # oldest request's max-wait expires (closed: at once)
                    deadline = self._q[0].t_submit + self.max_wait_s
                    while self._qn < maxb and not self._closed:
                        left = deadline - time.perf_counter()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                        self._sweep_abandoned_locked()
                        if not self._q:
                            break
                    while self._q:
                        head = self._q[0]
                        if head.abandoned:
                            self._q.popleft()
                            self._qn -= head.n
                            _telemetry.counter_add("serve.abandoned")
                            continue
                        if taken + head.n > maxb:
                            break
                        self._q.popleft()
                        taken += head.n
                        batch.append(head)
                    self._qn -= taken
                    _telemetry.gauge_set("serve.queue_depth", self._qn)
                if batch:
                    self._execute(batch, taken)

    def _execute(self, batch, n_items):
        now = time.perf_counter()
        for r in batch:
            _telemetry.observe("serve.queue_wait_us",
                               (now - r.t_submit) * _US)
        bucket = self.engine.bucket_for(n_items)
        x = np.concatenate(
            [r.x for r in batch] +
            ([np.zeros((bucket - n_items,) + self.engine.item_shape,
                       dtype=self.engine.dtype)]
             if bucket > n_items else []))
        fault = _faults.maybe("batcher")
        if fault is not None:
            mode, secs = fault
            if mode == "delay":
                _faults.apply_delay(secs)
            elif mode == "black_hole":
                # strand the batch: events never set, callers hit their
                # submit() timeout (→ HTTP 504)
                return
            else:   # error
                e = RequestError("injected fault (MXNET_SERVE_FAULT)")
                _telemetry.counter_add("serve.errors")
                for r in batch:
                    r.error = e
                    r.event.set()
                return
        try:
            t0 = time.perf_counter()
            with _telemetry.span("serve.execute", fill=n_items,
                                 requests=len(batch), bucket=bucket):
                outs = self.engine.run(x)
                outs = tuple(_host(o) for o in outs)    # waits
            _telemetry.observe("serve.device_us",
                               (time.perf_counter() - t0) * _US)
        except Exception as e:      # deliver, don't kill the loop
            _telemetry.counter_add("serve.errors")
            for r in batch:
                r.error = e
                r.event.set()
            return
        _telemetry.counter_add("serve.batches")
        if len(batch) > 1:
            _telemetry.counter_add("serve.coalesced_batches")
        if bucket > n_items:
            _telemetry.counter_add("serve.padded", bucket - n_items)
        _telemetry.observe("serve.batch_fill", float(n_items))
        done = time.perf_counter()
        per_item = (done - now) / max(1, n_items)
        with self._cv:
            self._ewma_item_s = per_item if self._ewma_item_s <= 0.0 \
                else 0.3 * per_item + 0.7 * self._ewma_item_s
        off = 0
        for r in batch:
            r.result = tuple(o[off:off + r.n] for o in outs)
            off += r.n
            _telemetry.observe("serve.e2e_us", (done - r.t_submit) * _US)
            r.event.set()

    # --------------------------------------------------------------- admin
    def stats(self) -> dict:
        with self._cv:
            return {"name": self.name, "queued_items": self._qn,
                    "queued_requests": len(self._q),
                    "queue_depth": self.queue_depth,
                    "max_wait_ms": self.max_wait_s * 1e3,
                    "ewma_item_ms": round(self._ewma_item_s * 1e3, 3),
                    "closed": self._closed}

    def close(self, timeout: float = 30.0):
        """Drain the queue (queued requests are still served), stop the
        loop thread and join it."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ===================================================================== decode
class _DecodeRequest:
    __slots__ = ("tokens", "max_new", "q", "emitted", "t_submit")

    def __init__(self, tokens, max_new):
        self.tokens = tokens
        self.max_new = max_new
        self.q = queue.Queue()      # streamed token ids; None terminates
        self.emitted = 0
        self.t_submit = time.perf_counter()


class DecodeBatcher:
    """Token-level continuous batching over one
    :class:`~mxnet_tpu_torch.generate.DecodeEngine`.

    The loop thread (``serve-decode-<name>``) performs, per iteration:
    joins (free slots × pending queue, ``decode.joins``), one decode step
    for the whole batch (``decode.decode_step_us``), per-row token
    delivery onto each request's stream queue, then leaves
    (``decode.leaves``) for rows that hit ``max_new`` and evictions
    (``decode.evictions``) for rows whose next position would pass the
    model's ``max_len``.  Idle rows decode garbage that nothing reads —
    the ring validity mask keeps them from polluting a later occupant.
    The thread runs on the engine's device; its kernels launch on that
    device's current stream for the thread.

    ``submit_stream`` yields token ids as the loop emits them; ``submit``
    collects the full list.  Admission control is a bounded pending
    queue (``MXNET_SERVE_STREAM_QUEUE_DEPTH``) raising
    :class:`QueueFull`; per-request length is capped by
    ``MXNET_SERVE_STREAM_MAX_TOKENS``; ``MXNET_SERVE_STREAM_SLOTS`` sets
    the batch rows and ``MXNET_SERVE_TIMEOUT_MS`` the wait per token.
    """

    def __init__(self, engine, slots: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 name: Optional[str] = None):
        self.engine = engine
        self.name = name or engine.name
        slots = int(slots) if slots is not None \
            else (_env_int("MXNET_SERVE_STREAM_SLOTS", 0)
                  or engine.buckets[-1])
        if engine.bucket_for(slots) != slots:
            raise ValueError(
                f"slots {slots} is not a bucket of {engine.buckets}")
        self.slots = slots
        self.queue_depth = _env_int("MXNET_SERVE_STREAM_QUEUE_DEPTH", 64) \
            if queue_depth is None else int(queue_depth)
        self.max_tokens = _env_int("MXNET_SERVE_STREAM_MAX_TOKENS", 64)
        self.timeout_s = _env_float("MXNET_SERVE_TIMEOUT_MS", 30000.0) / 1e3
        self._cv = threading.Condition()
        self._pending: "deque[_DecodeRequest]" = deque()
        self._active = [None] * slots
        self._active_n = 0
        self._joins = self._leaves = self._evictions = 0
        self._max_concurrent = 0
        self._closed = False
        self._ctl = engine.empty_ctl(slots)
        self._thread = threading.Thread(
            target=self._loop, name=f"serve-decode-{self.name}",
            daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- ingress
    def submit_stream(self, tokens, max_new: Optional[int] = None,
                      timeout: Optional[float] = None):
        """Enqueue one generation; yields token ids as they decode.
        Raises :class:`QueueFull` when admission control rejects it,
        :class:`RequestError` if the decode loop failed the request."""
        toks = [int(t) for t in tokens]
        if not toks:
            raise ValueError("empty prompt")
        self.engine.prompt_bucket_for(len(toks))   # validates length
        n = self.max_tokens if max_new is None \
            else min(int(max_new), self.max_tokens)
        if n < 1:
            raise ValueError(f"max_new {max_new!r} < 1")
        req = _DecodeRequest(toks, n)
        _telemetry.counter_add("decode.requests")
        with self._cv:
            if self._closed:
                raise RuntimeError(f"decode batcher {self.name!r} closed")
            if len(self._pending) >= self.queue_depth:
                _telemetry.counter_add("decode.rejected")
                raise QueueFull(
                    f"pending at {len(self._pending)}/{self.queue_depth}")
            self._pending.append(req)
            self._cv.notify()
        return self._drain(req, self.timeout_s if timeout is None
                           else timeout)

    def _drain(self, req, timeout):
        while True:
            try:
                item = req.q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no token within {timeout}s (decode batcher "
                    f"{self.name!r})") from None
            if item is None:
                return
            if isinstance(item, Exception):
                raise RequestError(str(item)) from item
            yield item

    def submit(self, tokens, max_new: Optional[int] = None,
               timeout: Optional[float] = None):
        """Blocking generate: the full token list for one prompt."""
        return list(self.submit_stream(tokens, max_new, timeout))

    # ---------------------------------------------------------------- loop
    def _loop(self):
        with _on_device(self.engine.device):
            while True:
                joins = []
                with self._cv:
                    while not self._pending and self._active_n == 0 \
                            and not self._closed:
                        self._cv.wait()
                    if self._closed and not self._pending \
                            and self._active_n == 0:
                        return
                    for slot in range(self.slots):
                        if self._active[slot] is None and self._pending:
                            joins.append((self._pending.popleft(), slot))
                # iteration boundary: joins first, then one step for all
                for req, slot in joins:
                    self._join(req, slot)
                if self._active_n:
                    self._step()

    def _join(self, req, slot):
        try:
            t0 = time.perf_counter()
            self.engine.join(self._ctl, req.tokens, slot)
            first = int(self._ctl["tok"][slot])
            _telemetry.observe("decode.prefill_us",
                               (time.perf_counter() - t0) * _US)
        except Exception as e:    # deliver, don't kill the loop
            _telemetry.counter_add("decode.errors")
            req.q.put(e)
            req.q.put(None)
            return
        with self._cv:
            self._active[slot] = req
            self._active_n += 1
            self._joins += 1
            self._max_concurrent = max(self._max_concurrent,
                                       self._active_n)
        _telemetry.counter_add("decode.joins")
        _telemetry.counter_add("decode.prefills")
        _telemetry.gauge_set("decode.active_slots", self._active_n)
        req.emitted = 1
        req.q.put(first)
        _telemetry.counter_add("decode.tokens")
        if req.emitted >= req.max_new:
            self._leave(slot, evicted=False)

    def _step(self):
        eng = self.engine
        try:
            t0 = time.perf_counter()
            eng.step(self._ctl)
            toks = self._ctl["tok"].tolist()
            pos = self._ctl["pos"].tolist()
            _telemetry.observe("decode.decode_step_us",
                               (time.perf_counter() - t0) * _US)
            _telemetry.counter_add("decode.steps")
        except Exception as e:
            _telemetry.counter_add("decode.errors")
            for slot in range(self.slots):
                if self._active[slot] is not None:
                    self._active[slot].q.put(e)
                    self._leave(slot, evicted=False)
            return
        for slot in range(self.slots):
            req = self._active[slot]
            if req is None:
                continue
            req.q.put(toks[slot])
            req.emitted += 1
            _telemetry.counter_add("decode.tokens")
            if req.emitted >= req.max_new:
                self._leave(slot, evicted=False)
            elif pos[slot] >= eng.cfg.max_len - 1:
                # next position would run off the embedding table
                self._leave(slot, evicted=True)

    def _leave(self, slot, evicted):
        req = self._active[slot]
        with self._cv:
            self._active[slot] = None
            self._active_n -= 1
            self._leaves += 1
            if evicted:
                self._evictions += 1
        _telemetry.counter_add("decode.leaves")
        if evicted:
            _telemetry.counter_add("decode.evictions")
        _telemetry.gauge_set("decode.active_slots", self._active_n)
        req.q.put(None)

    # --------------------------------------------------------------- admin
    def stats(self) -> dict:
        with self._cv:
            return {"name": self.name, "slots": self.slots,
                    "pending": len(self._pending),
                    "active": self._active_n,
                    "queue_depth": self.queue_depth,
                    "max_tokens": self.max_tokens,
                    "joins": self._joins, "leaves": self._leaves,
                    "evictions": self._evictions,
                    "max_concurrent": self._max_concurrent,
                    "closed": self._closed}

    def close(self, timeout: float = 30.0):
        """Stop admitting, finish pending + active generations, stop the
        loop thread, and join it — no leaked ``serve-`` threads."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
