"""Token-level continuous batching over one decode engine
(≙ ``mxnet_tpu/serve/batcher.py`` ``DecodeBatcher``).

A persistent B-row decode batch: each row (slot) hosts one in-flight
generation, and requests join and leave at iteration boundaries.  A
joining request is prefilled into a free row of the batch's ctl block
(``DecodeEngine.join``) while every other row keeps decoding, and a
finished row frees its slot without stalling the rest.

The request-level ``Batcher`` of the reference waits for the image
serving slice.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Optional

import torch

from .. import telemetry as _telemetry

__all__ = ["DecodeBatcher", "QueueFull", "RequestError"]

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


class QueueFull(Exception):
    """Admission control: the bounded request queue is at capacity."""


class RequestError(Exception):
    """The device execution for this request's batch failed."""


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
        dev = self.engine.device
        with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
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
