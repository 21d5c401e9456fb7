"""DataFeed — the pipelined host-to-device input ring (≙
``mxnet_tpu/io/datafeed.py``).

A background staging thread moves batch N+1 to the card and runs the
deferred uint8 → float32 cast and normalize there while the card
computes on batch N:

- the wire carries uint8 (a quarter of float32's bytes) when the source
  is a ``NativeImageRecordIter(dtype="uint8")``; the loader writes each
  batch straight into a pinned buffer of the port's ``StoragePool``;
- the copy is ``non_blocking`` on a copy stream of the ring's own, the
  finalize (cast, ``scale``, ``mean``, ``std``, NCHW → NHWC) runs as
  torch ops on that stream, and the consumer's stream waits on an event
  recorded after them (``record_stream`` keeps the caching allocator
  from reusing the batch's memory early);
- counters (staged batches, h2d bytes, producer backpressure, consumer
  waits, sync fallbacks) come out of ``stats()``; the staged count and
  the ring's depth are also gauges, each both a ``telemetry`` gauge
  (``datafeed.staged``, ``datafeed.ring_depth``) and a
  ``profiler.Counter`` (``datafeed/staged``, ``datafeed/ring_depth``:
  chrome traces keep the ``/`` form), as the reference's ``_gauge``;
  while the consumer waits, the ``datafeed.wait_since_us`` gauge holds
  the wait's start (monotonic µs), so the obs recorder counts a wait
  still open in its window (``obs.signals.WaitAccrual``).

Ring semantics: a bounded queue of ``depth`` staged batches.  The
producer blocks (counted as backpressure) when the ring is full; the
consumer blocks (counted as a sync fallback) when it is empty; ``depth=0``
stages synchronously.  ``close()`` and ``reset()`` are safe at any point,
mid-epoch with a full ring and a blocked producer included.
"""
from __future__ import annotations

import contextlib
import os
import queue as _q
import threading
import time

import numpy as np
import torch

from .. import telemetry as _telemetry
from . import _adopt

__all__ = ["DataFeed"]

_SENTINEL = object()


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


@contextlib.contextmanager
def _waiting():
    """Publish the consumer's wait in progress: its start in the
    ``datafeed.wait_since_us`` gauge, cleared before the wait is
    recorded."""
    _telemetry.gauge_set("datafeed.wait_since_us",
                         int(time.monotonic() * 1e6))
    try:
        yield
    finally:
        _telemetry.gauge_set("datafeed.wait_since_us", 0)


class _Staged:
    """A staged batch, its copy's event and the pinned buffers to give
    back once the copy is done."""
    __slots__ = ("item", "event", "pinned")

    def __init__(self, item, event, pinned):
        self.item, self.event, self.pinned = item, event, pinned


class DataFeed:
    """Double-buffered device staging ring over any batch source.

    Parameters
    ----------
    source : DataIter | iterable
        Yields ``DataBatch``es, ``(data, label, pad)`` numpy tuples
        (``NativeImageRecordIter.next_raw``), or tuples / lists of arrays
        (gluon ``DataLoader`` batches).
    depth : int
        Ring capacity.  ``0`` stages synchronously.  Default
        ``MXNET_DATAFEED_DEPTH``, else 2.
    device : torch.device or str, optional
        Staging target; default the current card (raises without one).
    mean, std, scale : array-like / float, optional
        Normalize of image data on the device,
        ``(x.float() * scale - mean) / std``, per channel (see
        :meth:`finalize` for its roundings).  Without them a
        uint8 wire is still cast to float32 on the device.
    layout : {"NCHW", "NHWC"}, optional
        ``"NHWC"`` transposes 4-D NCHW data on the device.
    """

    def __init__(self, source, depth=None, device=None, mean=None,
                 std=None, scale=None, layout=None, name="datafeed"):
        from ..context import resolve
        from ..storage import StoragePool
        if depth is None:
            depth = _env_int("MXNET_DATAFEED_DEPTH", 2)
        self._source = source
        self._depth = max(0, int(depth))
        self._device = resolve(device)
        self._cuda = self._device.type == "cuda"
        self._stream = (torch.cuda.Stream(self._device) if self._cuda
                        else None)
        self._pool = StoragePool(pin_memory=self._cuda)
        self._name = name
        self._layout = layout
        self._norm = self._build_norm_spec(mean, std, scale)
        self._lock = threading.Lock()
        self._stats = {
            "staged_batches": 0, "h2d_bytes": 0,
            "backpressure_waits": 0, "consumer_waits": 0,
            "consumer_wait_s": 0.0, "sync_fallbacks": 0,
            "restarts": 0, "consumed": 0,
            "depth": self._depth, "sync_mode": False,
        }
        self._queue = None
        self._thread = None
        self._abandoned = None
        self._err = None
        self._closed = False
        self._gauges = {}
        self._start()

    # -------------------------------------------------------- lifecycle --
    def _start(self):
        if self._depth == 0:
            self._stats["sync_mode"] = True
            self._sync_it = iter(self._iter_source())
            return
        self._queue = _q.Queue(maxsize=self._depth)
        self._abandoned = threading.Event()
        self._err = None
        self._thread = threading.Thread(
            target=self._stage_loop, daemon=True, name=f"{self._name}-stager")
        self._thread.start()

    def reset(self):
        """Stop the ring, reset the source, restart: a fresh epoch."""
        self._shutdown_ring()
        if hasattr(self._source, "reset"):
            self._source.reset()
        with self._lock:
            self._stats["restarts"] += 1
            self._stats["consumed"] = 0
        self._closed = False
        self._start()

    def close(self):
        """Release the staging thread and the staged batches."""
        self._shutdown_ring()
        self._closed = True

    def _shutdown_ring(self):
        if self._abandoned is not None:
            self._abandoned.set()
        if self._queue is not None:
            self._drain()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._queue is not None:
            self._drain()
        self._queue = None
        self._abandoned = None

    def _drain(self):
        try:
            while True:
                got = self._queue.get_nowait()
                if isinstance(got, _Staged):
                    self._give_back(got)
        except _q.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except (AttributeError, RuntimeError):
            pass

    # ------------------------------------------------------------ source --
    def _iter_source(self):
        next_raw = getattr(self._source, "next_raw", None)
        if next_raw is not None:
            # the native loader writes each batch into a pinned buffer
            b, c, h, w = self._source.provide_data[0].shape
            item = 1 if self._source.dtype == "uint8" else 4
            nbytes = b * c * h * w * item
            while True:
                buf = self._pool.alloc(nbytes)
                try:
                    data, label, pad = next_raw(out=buf)
                except StopIteration:
                    self._pool.release(buf)
                    return
                except BaseException:
                    self._pool.release(buf)
                    raise
                yield (torch.from_numpy(data), label, pad, buf)
        else:
            yield from self._source

    # ----------------------------------------------------------- staging --
    @staticmethod
    def _build_norm_spec(mean, std, scale):
        if mean is None and std is None and scale is None:
            return None

        def to_t(v):
            return None if v is None else torch.as_tensor(
                np.asarray(v, np.float32))
        return {"mean": to_t(mean), "std": to_t(std),
                "scale": None if scale is None else float(scale)}

    def finalize(self, x):
        """The device-side cast / normalize / transpose of image data (≙
        the reference's jitted ``finalize``), as torch ops: ``x * scale -
        mean`` rounded to fp32 once (as XLA fuses it into one
        multiply-add), then times the fp32 reciprocal of ``std`` (as XLA
        divides by a constant)."""
        y = x.to(torch.float32)
        norm = self._norm
        if norm is not None:
            def chan(v):
                v = v.to(y.device)
                if v.ndim == 0 or y.ndim != 4:
                    return v
                return v.reshape(v.shape[0], 1, 1)
            if norm["scale"] is not None or norm["mean"] is not None:
                yd = y.double()
                if norm["scale"] is not None:
                    yd = yd * float(np.float32(norm["scale"]))
                if norm["mean"] is not None:
                    yd = yd - chan(norm["mean"]).double()
                y = yd.float()
            if norm["std"] is not None:
                y = y * torch.reciprocal(chan(norm["std"]))
        if self._layout == "NHWC" and y.ndim == 4:
            y = y.permute(0, 2, 3, 1).contiguous()
        return y

    def _needs_finalize(self, t):
        return (self._norm is not None or self._layout == "NHWC" or
                t.dtype == torch.uint8)

    def _stage_array(self, arr, is_data, pinned):
        """One host array to the device (finalized when it is image
        data); pinned buffers it borrows go to ``pinned``."""
        t = arr if isinstance(arr, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(arr))
        with self._lock:
            self._stats["h2d_bytes"] += t.numel() * t.element_size()
        if self._cuda:
            if not t.is_pinned():
                buf = self._pool.alloc(t.numel() * t.element_size())
                view = buf[:t.numel() * t.element_size()].view(
                    t.dtype).view(t.shape)
                view.copy_(t)
                pinned.append(buf)
                t = view
            dev = t.to(self._device, non_blocking=True)
        else:
            dev = t.to(self._device, copy=True)
        if is_data and self._needs_finalize(dev):
            dev = self.finalize(dev)
        return dev

    def _stage(self, item):
        """Host batch → device batch, on the copy stream; → _Staged."""
        from . import DataBatch
        pinned = []
        with (torch.cuda.stream(self._stream) if self._cuda
              else contextlib.nullcontext()):
            if isinstance(item, DataBatch):
                item.data = [self._stage_array(a, True, pinned)
                             for a in item.data]
                if item.label is not None:
                    item.label = [self._stage_array(a, False, pinned)
                                  for a in item.label]
                out = item
            elif (isinstance(item, tuple) and len(item) in (3, 4) and
                  isinstance(item[2], int)):
                # (data, label, pad), as ``next_raw`` gives it; from the
                # native loader with the pinned buffer that holds it
                data, label, pad = item[:3]
                pinned.extend(item[3:])
                out = DataBatch(
                    data=[self._stage_array(data, True, pinned)],
                    label=[self._stage_array(label, False, pinned)],
                    pad=pad)
            elif isinstance(item, (tuple, list)):
                # a loader's batch: the first entry is the data; dtypes
                # pass unchanged unless a normalize or layout was set
                explicit = self._norm is not None or \
                    self._layout is not None
                out = type(item)(
                    self._stage_array(a, explicit and i == 0, pinned)
                    if hasattr(a, "dtype") else a
                    for i, a in enumerate(item))
            else:
                out = self._stage_array(item, True, pinned)
            event = None
            if self._cuda:
                event = torch.cuda.Event()
                event.record(self._stream)
        return _Staged(out, event, pinned)

    def _gauge(self, name, value):
        """One gauge, twice: the registry's (``datafeed/ring_depth`` →
        ``datafeed.ring_depth``) and a profiler Counter's."""
        from .. import profiler
        _telemetry.gauge_set(name.replace("/", "."), value)
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = profiler.Counter(name)
        g.set_value(value)

    def _give_back(self, staged):
        """Return a staged batch's pinned buffers once its copy is done."""
        if staged.pinned:
            if staged.event is not None:
                staged.event.synchronize()
            for buf in staged.pinned:
                self._pool.release(buf)
            staged.pinned = []

    def _stage_loop(self):
        queue, abandoned = self._queue, self._abandoned
        try:
            for item in self._iter_source():
                staged = self._stage(item)
                self._give_back(staged)
                with self._lock:
                    self._stats["staged_batches"] += 1
                    n = self._stats["staged_batches"]
                self._gauge("datafeed/staged", n)
                try:
                    queue.put_nowait(staged)
                except _q.Full:
                    with self._lock:
                        self._stats["backpressure_waits"] += 1
                    while not abandoned.is_set():
                        try:
                            queue.put(staged, timeout=0.1)
                            break
                        except _q.Full:
                            continue
                if abandoned.is_set():
                    return
                self._gauge("datafeed/ring_depth", queue.qsize())
        except BaseException as e:          # raised at the consumer
            self._err = e
        finally:
            while not abandoned.is_set():
                try:
                    queue.put(_SENTINEL, timeout=0.1)
                    break
                except _q.Full:
                    continue

    # ---------------------------------------------------------- consume --
    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise RuntimeError("DataFeed is closed; call reset()")
        if self._queue is None:                      # synchronous mode
            t0 = time.perf_counter()
            with _telemetry.span("datafeed.wait", mode="sync"), \
                    _waiting():
                staged = self._stage(next(self._sync_it))
                self._give_back(staged)
            _telemetry.observe("datafeed.wait_us",
                               (time.perf_counter() - t0) * 1e6)
            with self._lock:
                self._stats["consumed"] += 1
            return _adopt(self._device, staged.event, staged.item)
        try:
            staged = self._queue.get_nowait()
        except _q.Empty:
            with self._lock:
                self._stats["consumer_waits"] += 1
                self._stats["sync_fallbacks"] += 1
            t0 = time.perf_counter()
            with _telemetry.span("datafeed.wait", mode="stall"), \
                    _waiting():
                staged = self._wait_for_batch()
            waited = time.perf_counter() - t0
            _telemetry.observe("datafeed.wait_us", waited * 1e6)
            with self._lock:
                self._stats["consumer_wait_s"] += waited
        if staged is _SENTINEL:
            err, self._err = self._err, None
            if err is not None:
                raise err
            raise StopIteration
        with self._lock:
            self._stats["consumed"] += 1
        return _adopt(self._device, staged.event, staged.item)

    next = __next__

    def _wait_for_batch(self):
        """A blocking get that ends (never deadlocks) when the stager dies
        without its sentinel or a concurrent ``close()`` ran."""
        queue, abandoned, thread = self._queue, self._abandoned, \
            self._thread
        while True:
            try:
                return queue.get(timeout=0.5)
            except _q.Empty:
                if abandoned is None or abandoned.is_set():
                    raise StopIteration
                if thread is not None and not thread.is_alive():
                    err, self._err = self._err, None
                    if err is not None:
                        raise err
                    raise StopIteration

    # -------------------------------------------------------- checkpoint --
    def position(self):
        """``{"epoch", "batch"}`` consumed so far."""
        with self._lock:
            return {"epoch": self._stats["restarts"],
                    "batch": self._stats["consumed"]}

    def seek(self, batch, epoch=None):
        """Fast-forward to ``batch`` consumed batches, rolling through an
        epoch's end (reset, keep counting); with ``epoch`` first roll to
        that epoch.  A source with its own ``position`` / ``seek`` jumps
        there; any other is drawn and discarded.  → :meth:`position`."""
        batch = int(batch)
        if batch < 0:
            raise ValueError(f"negative batch {batch}")
        src = self._source
        if (callable(getattr(src, "seek", None))
                and callable(getattr(src, "position", None))):
            self._shutdown_ring()
            pos = (src.seek(batch) if epoch is None
                   else src.seek(batch, epoch=epoch))
            with self._lock:
                self._stats["restarts"] = int(pos.get("epoch", 0))
                self._stats["consumed"] = int(pos.get("batch", 0))
            self._closed = False
            self._start()
            return self.position()
        empty_streak = 0
        if epoch is not None:
            while self.position()["epoch"] < int(epoch):
                drew = False
                try:
                    while True:
                        next(self)
                        drew = True
                except StopIteration:
                    pass
                empty_streak = 0 if drew else empty_streak + 1
                if empty_streak >= 2:
                    return self.position()
                self.reset()
        with self._lock:
            remaining = max(0, batch - self._stats["consumed"])
        while remaining > 0:
            try:
                next(self)
                remaining -= 1
                empty_streak = 0
            except StopIteration:
                empty_streak += 1
                if empty_streak >= 2:
                    break
                self.reset()
        return self.position()

    # ------------------------------------------------------------- stats --
    @property
    def batch_size(self):
        return getattr(self._source, "batch_size", 0)

    @property
    def provide_data(self):
        return getattr(self._source, "provide_data", None)

    @property
    def provide_label(self):
        return getattr(self._source, "provide_label", None)

    def stats(self):
        """Ring and source counters as one dict."""
        with self._lock:
            out = dict(self._stats)
        src_stats = getattr(self._source, "stats", None)
        if callable(src_stats):
            out["source"] = src_stats()
        return out

