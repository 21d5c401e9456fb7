"""Native-library loader and ctypes surface (≙ ``mxnet_tpu/base.py``,
itself ≙ the reference's ``python/mxnet/base.py`` ``_load_lib``).

The port's native runtime is the async dependency engine and its thread
pool: ``csrc_host/engine.cc``, the port's copy of the JAX package's
``src/engine.cc``, with its own API header (``engine_api.h``) and counter
block (``engine_stats.h``).  It is compiled by ``g++`` at first use into
``build/mxnet_tpu_torch/libmxnet_tpu_torch_engine.so`` at the root of the
checkout, as ``_host_build`` builds the decode stage: a stamp of the
sources and the command, a file lock, an atomic rename.  A failed build
raises, naming the compiler and its output; there is no silent fallback.
``import mxnet_tpu_torch`` builds nothing: :data:`LIB` is loaded on its
first access.  ``MXNET_TPU_NO_NATIVE=1`` selects the pure-Python engine
(``engine._PythonEngine``), as in the reference, and :data:`LIB` is then
None.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

from ._build import BUILD_DIR
from ._host_build import CSRC_HOST, _cxx, stamped_build

__all__ = ["LIB", "check_call", "MXTpuError", "lib_path", "lib",
           "native_disabled"]

SOURCES = (CSRC_HOST / "engine.cc",)
HEADERS = (CSRC_HOST / "engine_api.h", CSRC_HOST / "engine_stats.h")
LIB_PATH = BUILD_DIR / "libmxnet_tpu_torch_engine.so"

_mu = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class MXTpuError(RuntimeError):
    """Error raised from the native runtime (≙ ``mxnet.base.MXNetError``)."""


def native_disabled() -> bool:
    """``MXNET_TPU_NO_NATIVE`` set (to anything non-empty): the Python
    engine is used and the library is neither built nor loaded."""
    return bool(os.environ.get("MXNET_TPU_NO_NATIVE"))


def _command(cxx, out):
    return [cxx, "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
            "-Wall", f"-I{CSRC_HOST}", *[str(s) for s in SOURCES],
            "-o", str(out)]


def _bind(handle: ctypes.CDLL):
    i64p = ctypes.POINTER(ctypes.c_int64)
    vp = ctypes.c_void_p
    sigs = {
        "MXTEngineCreate": [ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(vp)],
        "MXTEngineFree": [vp],
        "MXTEngineNewVariable": [vp, i64p],
        "MXTEngineDeleteVariable": [vp, ctypes.c_int64],
        "MXTEngineWaitForVar": [vp, ctypes.c_int64],
        "MXTEngineWaitForAll": [vp],
        "MXTEngineNumExecuted": [vp, i64p],
        "MXTThreadPoolCreate": [ctypes.c_int, ctypes.POINTER(vp)],
        "MXTThreadPoolFree": [vp],
        "MXTThreadPoolWaitAll": [vp],
        "MXTEngineStatsEnable": [ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)],
        "MXTEngineStatsJson": [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_size_t)],
    }
    for name, argtypes in sigs.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.MXTGetLastError.argtypes = []
    handle.MXTGetLastError.restype = ctypes.c_char_p


def lib() -> Optional[ctypes.CDLL]:
    """The native library, built and loaded on the first call; None when
    :func:`native_disabled`."""
    global _lib
    if native_disabled():
        return None
    with _mu:
        if _lib is None:
            cxx = _cxx("the native engine (csrc_host/engine.cc)")
            path = stamped_build(LIB_PATH, "engine", "the native engine",
                                 lambda out: _command(cxx, out),
                                 SOURCES + HEADERS)
            handle = ctypes.CDLL(str(path))
            _bind(handle)
            _lib = handle
        return _lib


def __getattr__(name):
    # LIB is the reference's module-level handle; here it is loaded (and
    # built) on first access, so importing the package builds nothing
    if name == "LIB":
        return lib()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def lib_path() -> Optional[str]:
    """The loaded library's path, or None without one."""
    return str(LIB_PATH) if lib() is not None else None


def check_call(ret: int):
    """Raise on a non-zero return, carrying the native error message
    (≙ ``mxnet.base.check_call`` → ``MXGetLastError``)."""
    if ret != 0:
        msg = _lib.MXTGetLastError().decode("utf-8", "replace") \
            if _lib is not None else "?"
        raise MXTpuError(msg)
