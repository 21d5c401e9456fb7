"""Async dependency engine: the Python face of the native engine
(``csrc_host/engine.cc``; ≙ ``mxnet_tpu/engine.py``).

Reference equivalence: ``include/mxnet/engine.h:253`` (NewVariable /
PushAsync / WaitForVar / WaitForAll), ``python/mxnet/engine.py`` (the
``bulk`` context manager), ``MXNET_ENGINE_TYPE=NaiveEngine``
(``src/engine/engine.cc:48``).

Role in the port: CUDA streams order the card's work; this engine
schedules host-side async work with the reference's read/write-variable
ordering contract: the WorkersMerge leader's per-key sums
(``kvstore/workers_merge.py``), writers, custom python ops.  An op that
fails propagates its exception to the next ``wait_for_var()`` on a
variable it wrote, or to ``wait_for_all()``, as the reference's
capture/rethrow-at-wait does (``src/engine/threaded_engine.cc:440``).

``Engine()`` is the native engine (built at its first use, see
``base.py``); ``MXNET_TPU_NO_NATIVE=1`` selects :class:`_PythonEngine`,
the plain version with the same semantics that the tests hold the native
one against.  The engine's counters (``engine.ops_dispatched``,
``engine.ops_executed``, ``engine.exceptions``, ``engine.pending_ops``,
``engine.run_us``, ``engine.queue_wait_us``) and every live engine's
queue state reach ``telemetry.snapshot()["engine"]``.  The native
engine survives ``fork``: its ``pthread_atfork`` handlers give the child
a fresh pool over empty queues.
"""
from __future__ import annotations

import ctypes
import json
import os
import threading
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence

from . import base as _base
from . import telemetry as _telemetry
from .base import MXTpuError, check_call

__all__ = ["Engine", "Var", "engine", "bulk", "set_bulk_size",
           "current_bulk_size"]

# NB: the err-buffer parameter must be c_void_p, NOT c_char_p — ctypes
# materialises c_char_p callback args as immutable bytes copies, so writing
# the error message through one corrupts the interpreter.
_OP_FUNC = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_size_t)


class Var:
    """Engine variable handle (≙ engine VarHandle)."""

    __slots__ = ("handle", "_engine")

    def __init__(self, handle, eng):
        self.handle = handle
        self._engine = eng

    def wait_to_read(self):
        self._engine.wait_for_var(self)


class _NativeEngine:
    """ctypes binding over ``csrc_host/engine.cc``."""

    def __init__(self, naive: bool = False, num_workers: int = 0):
        L = _base.lib()
        L.MXTEnginePushAsync.argtypes = [
            ctypes.c_void_p, _OP_FUNC, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int]
        L.MXTEnginePushAsync.restype = ctypes.c_int
        _watch_native_stats(L)
        h = ctypes.c_void_p()
        check_call(L.MXTEngineCreate(1 if naive else 0, num_workers,
                                     ctypes.byref(h)))
        self._L = L
        self._h = h
        self._lock = threading.Lock()
        self._payloads = {}       # payload id → callable
        self._next_payload = 1
        self._cb = _OP_FUNC(self._trampoline)
        self.naive = naive

    def _trampoline(self, payload, err_buf, err_len):
        with self._lock:
            fn = self._payloads.pop(payload, None)
        if fn is None:
            return 0
        try:
            fn()
            return 0
        except BaseException as e:  # propagate across the C boundary
            msg = f"{type(e).__name__}: {e}".encode()[: err_len - 1]
            ctypes.memmove(err_buf, msg, len(msg))
            return -1

    def new_variable(self) -> Var:
        v = ctypes.c_int64()
        check_call(self._L.MXTEngineNewVariable(self._h, ctypes.byref(v)))
        return Var(v.value, self)

    def delete_variable(self, var: Var):
        check_call(self._L.MXTEngineDeleteVariable(self._h, var.handle))

    def push(self, fn: Callable[[], None],
             const_vars: Sequence[Var] = (),
             mutable_vars: Sequence[Var] = (), priority: int = 0):
        with self._lock:
            pid = self._next_payload
            self._next_payload += 1
            self._payloads[pid] = fn
        cv = (ctypes.c_int64 * len(const_vars))(
            *[v.handle for v in const_vars])
        mv = (ctypes.c_int64 * len(mutable_vars))(
            *[v.handle for v in mutable_vars])
        check_call(self._L.MXTEnginePushAsync(
            self._h, self._cb, ctypes.c_void_p(pid), None,
            cv, len(const_vars), mv, len(mutable_vars), priority))

    def wait_for_var(self, var: Var):
        check_call(self._L.MXTEngineWaitForVar(self._h, var.handle))

    def wait_for_all(self):
        check_call(self._L.MXTEngineWaitForAll(self._h))

    @property
    def num_executed(self) -> int:
        n = ctypes.c_int64()
        check_call(self._L.MXTEngineNumExecuted(self._h, ctypes.byref(n)))
        return n.value

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._L.MXTEngineFree(self._h)
                self._h = None
        except Exception:
            pass


class _PyVar:
    __slots__ = ("queue", "active_readers", "writer_active", "exception")

    def __init__(self):
        self.queue = []
        self.active_readers = 0
        self.writer_active = False
        self.exception = None


class _PythonEngine:
    """Pure-python engine with identical semantics (threading-based): the
    plain version of the native one."""

    def __init__(self, naive: bool = False, num_workers: int = 0):
        self.naive = naive
        self._mu = threading.Condition()
        self._vars = {}
        self._next_var = 1
        self._pending = 0
        self._executed = 0
        self._ready_list: List = []
        self._global_exc: Optional[BaseException] = None
        if not naive:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=num_workers if num_workers > 0 else 4)

    def new_variable(self) -> Var:
        with self._mu:
            vid = self._next_var
            self._next_var += 1
            self._vars[vid] = _PyVar()
        return Var(vid, self)

    def delete_variable(self, var: Var):
        def _del():
            with self._mu:
                self._vars.pop(var.handle, None)
        self.push(_del, mutable_vars=[var])

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        if self.naive:
            try:
                fn()
            except BaseException as e:
                with self._mu:
                    self._global_exc = e
                    for v in mutable_vars:
                        pv = self._vars.get(v.handle)
                        if pv is not None:
                            pv.exception = e
            with self._mu:
                self._executed += 1
            return
        op = {"fn": fn, "const": [v.handle for v in const_vars],
              "mut": [v.handle for v in mutable_vars],
              "wait": len(const_vars) + len(mutable_vars) + 1}
        with self._mu:
            self._pending += 1
            self._ready_list = []
            for vid in op["const"]:
                self._append(vid, op, False)
            for vid in op["mut"]:
                self._append(vid, op, True)
            op["wait"] -= 1
            if op["wait"] == 0:
                self._ready_list.append(op)
            ready = list(self._ready_list)
        for o in ready:
            self._dispatch(o)

    def _append(self, vid, op, is_write):
        v = self._vars.setdefault(vid, _PyVar())
        v.queue.append((op, is_write))
        self._grant(v)

    def _grant(self, v):
        while v.queue:
            op, is_write = v.queue[0]
            if is_write:
                if v.active_readers or v.writer_active:
                    break
                v.writer_active = True
                v.queue.pop(0)
                op["wait"] -= 1
                if op["wait"] == 0:
                    self._ready_list.append(op)
                break
            else:
                if v.writer_active:
                    break
                v.active_readers += 1
                v.queue.pop(0)
                op["wait"] -= 1
                if op["wait"] == 0:
                    self._ready_list.append(op)

    def _dispatch(self, op):
        self._pool.submit(self._execute, op)

    def _execute(self, op):
        exc = None
        try:
            op["fn"]()
        except BaseException as e:
            exc = e
        ready = []
        with self._mu:
            self._executed += 1
            if exc is not None:
                self._global_exc = exc
            self._ready_list = []
            for vid in op["const"]:
                v = self._vars.get(vid)
                if v is None:
                    continue
                v.active_readers -= 1
                self._grant(v)
            for vid in op["mut"]:
                v = self._vars.get(vid)
                if v is None:
                    continue
                v.writer_active = False
                if exc is not None:
                    v.exception = exc
                self._grant(v)
            self._pending -= 1
            ready = list(self._ready_list)
            self._mu.notify_all()
        for o in ready:
            self._dispatch(o)

    def wait_for_var(self, var: Var):
        with self._mu:
            self._mu.wait_for(lambda: self._var_idle(var.handle))
            v = self._vars.get(var.handle)
            if v is not None and v.exception is not None:
                e = v.exception
                v.exception = None
                raise MXTpuError(f"{type(e).__name__}: {e}") from e

    def _var_idle(self, vid):
        v = self._vars.get(vid)
        return v is None or (not v.queue and not v.active_readers and
                             not v.writer_active)

    def wait_for_all(self):
        with self._mu:
            self._mu.wait_for(lambda: self._pending == 0)
            if self._global_exc is not None:
                e = self._global_exc
                self._global_exc = None
                raise MXTpuError(f"{type(e).__name__}: {e}") from e

    @property
    def num_executed(self):
        with self._mu:
            return self._executed


def Engine(naive: Optional[bool] = None, num_workers: int = 0):
    """Create an engine.  naive=None reads MXNET_ENGINE_TYPE
    (≙ src/engine/engine.cc:32-56 factory); num_workers=0 reads
    MXNET_CPU_WORKER_NTHREADS (the reference's engine worker-count knob).
    The native engine unless ``MXNET_TPU_NO_NATIVE`` is set."""
    if naive is None:
        naive = os.environ.get("MXNET_ENGINE_TYPE", "") == "NaiveEngine"
    if num_workers <= 0:
        num_workers = int(os.environ.get("MXNET_CPU_WORKER_NTHREADS",
                                         "0") or 0)
    if _base.native_disabled():
        return _PythonEngine(naive=naive, num_workers=num_workers)
    return _NativeEngine(naive=naive, num_workers=num_workers)


_default = None
_default_mu = threading.Lock()


def engine():
    """The process-wide default engine (≙ Engine::Get())."""
    global _default
    with _default_mu:
        if _default is None:
            _default = Engine()
        return _default


# -------------------------------------------------------- the counters --
# The native engine counts into its library's block; each telemetry
# snapshot folds what was added since the last one into the registry
# under the same names, and lists every live engine's queue state.
_stats_mu = threading.Lock()
_stats_seen = {"counters": {}, "histograms": {}}
_stats_lib = None


def _native_stats(L) -> dict:
    need = ctypes.c_size_t()
    check_call(L.MXTEngineStatsJson(None, 0, ctypes.byref(need)))
    while True:
        buf = ctypes.create_string_buffer(need.value)
        check_call(L.MXTEngineStatsJson(buf, need.value, ctypes.byref(need)))
        if need.value <= len(buf):
            return json.loads(buf.value.decode())


def _publish_native_stats():
    L = _stats_lib
    if L is None:
        return
    prev = ctypes.c_int()
    check_call(L.MXTEngineStatsEnable(1 if _telemetry.enabled() else 0,
                                      ctypes.byref(prev)))
    with _stats_mu:
        d = _native_stats(L)
        seen_c = _stats_seen["counters"]
        for name, v in d["counters"].items():
            delta = v - seen_c.get(name, 0)
            seen_c[name] = v
            if delta:
                _telemetry.counter_add(name, delta)
        for name, v in d["gauges"].items():
            _telemetry.gauge_set(name, v)
        seen_h = _stats_seen["histograms"]
        for name, h in d["histograms"].items():
            old = seen_h.get(name)
            seen_h[name] = h
            if old is None:
                counts, n, total = h["counts"], h["count"], h["sum"]
            else:
                counts = [a - b for a, b in zip(h["counts"], old["counts"])]
                n, total = h["count"] - old["count"], h["sum"] - old["sum"]
            if n:
                _telemetry._merge_hist(name, counts, n, total)
        _telemetry._set_engine_states(d["engines"])


def _watch_native_stats(L):
    """Fold the native engine's counters into every telemetry snapshot
    (registered once, by the first native engine)."""
    global _stats_lib
    with _stats_mu:
        if _stats_lib is not None:
            return
        _stats_lib = L
    check_call(L.MXTEngineStatsEnable(1 if _telemetry.enabled() else 0,
                                      ctypes.byref(ctypes.c_int())))
    _telemetry.register_publisher(_publish_native_stats)


# ---------------------------------------------------------------- bulking --
# Reference python/mxnet/engine.py `bulk(size)`: batches engine ops to cut
# dispatch overhead.  The port batches the card's work as CUDA graphs
# (the fused step); the knob is kept for API parity as a per-thread hint.
_bulk_size = threading.local()


def set_bulk_size(size: int) -> int:
    prev = getattr(_bulk_size, "v", 0)
    _bulk_size.v = int(size)
    return prev


def current_bulk_size() -> int:
    return getattr(_bulk_size, "v", 0)


@contextmanager
def bulk(size: int):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
