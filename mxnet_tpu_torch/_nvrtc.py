"""ctypes binding to NVRTC and the CUDA driver API: compile CUDA C++
source at run time, load it, launch it on PyTorch's stream.

≙ the reference's ``src/common/rtc.cc`` (the NVRTC program and the
per-device module cache behind ``mx.rtc.CudaModule``).  Two libraries:

- NVRTC compiles a source string for ``sm_90a`` to a **CUBIN** (machine
  code), never to PTX: a PTX from a newer NVRTC than the card's driver
  fails to load with ``CUDA_ERROR_UNSUPPORTED_PTX_VERSION``, a CUBIN
  does not.  No ``--use_fast_math``: the kernels keep IEEE division and
  the accurate ``expf``.  Each CUBIN is cached under
  ``build/mxnet_tpu_torch/rtc/`` at the root of the checkout, keyed by a
  hash of the source, the options, the name expressions, the arch and
  NVRTC's version, so a second process loads it without compiling.
- The driver API loads a CUBIN into the primary context of a device
  (``cuModuleLoadData``), finds its functions and launches them
  (``cuLaunchKernel``).  The driver needs a current context on the
  calling thread; batcher and client threads have none, so every load
  and launch first makes the device's primary context current — the
  context PyTorch's runtime calls use.

Nothing here runs at import: the libraries are found and loaded at the
first compile or launch.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

__all__ = ["ARCH", "CACHE_DIR", "NvrtcError", "Cubin", "compile_program",
           "load_function", "launch", "info"]

ARCH = "sm_90a"
_PROGRAM = "mxt_rtc.cu"          # the name NVRTC's log gives the source
CACHE_DIR = (Path(__file__).resolve().parent.parent / "build" /
             "mxnet_tpu_torch" / "rtc")

_mu = threading.Lock()
_nvrtc: Optional[ctypes.CDLL] = None
_nvrtc_path: Optional[str] = None
_cuda: Optional[ctypes.CDLL] = None
_ctxs: Dict[int, ctypes.c_void_p] = {}
# (cubin digest, device) -> CUmodule; (cubin digest, device, symbol) -> CUfunction
_modules: Dict[Tuple[str, int], ctypes.c_void_p] = {}
_functions: Dict[Tuple[str, int, str], ctypes.c_void_p] = {}

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_CP = ctypes.c_char_p
_CPP = ctypes.POINTER(ctypes.c_char_p)
_SZ = ctypes.POINTER(ctypes.c_size_t)
_INT = ctypes.c_int
_UINT = ctypes.c_uint

_NVRTC_SIGNATURES = {
    "nvrtcVersion": [ctypes.POINTER(_INT), ctypes.POINTER(_INT)],
    "nvrtcCreateProgram": [_PP, _CP, _CP, _INT, _CPP, _CPP],
    "nvrtcAddNameExpression": [_P, _CP],
    "nvrtcCompileProgram": [_P, _INT, _CPP],
    "nvrtcGetProgramLogSize": [_P, _SZ],
    "nvrtcGetProgramLog": [_P, _CP],
    "nvrtcGetLoweredName": [_P, _CP, _CPP],
    "nvrtcGetCUBINSize": [_P, _SZ],
    "nvrtcGetCUBIN": [_P, _CP],
    "nvrtcDestroyProgram": [_PP],
}
_CUDA_SIGNATURES = {
    "cuInit": [_UINT],
    "cuDeviceGet": [ctypes.POINTER(_INT), _INT],
    "cuDevicePrimaryCtxRetain": [_PP, _INT],
    "cuCtxGetCurrent": [_PP],
    "cuCtxSetCurrent": [_P],
    "cuModuleLoadData": [_PP, _P],
    "cuModuleGetFunction": [_PP, _P, _CP],
    "cuLaunchKernel": [_P, _UINT, _UINT, _UINT, _UINT, _UINT, _UINT, _UINT,
                       _P, _PP, _PP],
    "cuGetErrorName": [_INT, _CPP],
}


class NvrtcError(RuntimeError):
    """NVRTC refused a program; the message holds its log."""


def _candidates():
    """Where libnvrtc may be, in the order tried: ``$CUDA_HOME/lib64``
    (``/usr/local/cuda`` when unset), the ``nvidia/cuda_nvrtc/lib``
    directory of the wheel PyTorch's CUDA build depends on, then the
    soname for the loader's own search."""
    out = []
    homes = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in dict.fromkeys(h for h in homes if h):
        out += sorted(glob.glob(os.path.join(home, "lib64", "libnvrtc.so*")))
        out.append(os.path.join(home, "lib64", "libnvrtc.so"))
    for entry in sys.path:
        d = os.path.join(entry or ".", "nvidia", "cuda_nvrtc", "lib")
        out += sorted(glob.glob(os.path.join(d, "libnvrtc.so*")))
    out += ["libnvrtc.so.12", "libnvrtc.so"]
    return list(dict.fromkeys(out))


def _bind(lib, table):
    for name, argtypes in table.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT


def _load_nvrtc() -> ctypes.CDLL:
    global _nvrtc, _nvrtc_path
    with _mu:
        if _nvrtc is not None:
            return _nvrtc
        tried = []
        for cand in _candidates():
            if os.sep in cand and not os.path.exists(cand):
                tried.append(f"{cand} (missing)")
                continue
            try:
                lib = ctypes.CDLL(cand)
            except OSError as e:
                tried.append(f"{cand} ({e})")
                continue
            lib.nvrtcGetErrorString.argtypes = [_INT]
            lib.nvrtcGetErrorString.restype = _CP
            _bind(lib, _NVRTC_SIGNATURES)
            _nvrtc, _nvrtc_path = lib, cand
            return lib
        raise RuntimeError("libnvrtc not found; tried:\n  " +
                           "\n  ".join(tried))


def _load_cuda() -> ctypes.CDLL:
    global _cuda
    if _cuda is not None:
        return _cuda
    with _mu:
        if _cuda is None:
            lib = ctypes.CDLL("libcuda.so.1")
            _bind(lib, _CUDA_SIGNATURES)
            _check(lib.cuInit(0), "cuInit", lib)
            _cuda = lib
        return _cuda


def _check(res: int, what: str, lib=None):
    if res != 0:
        lib = lib or _cuda
        name = ctypes.c_char_p()
        if lib is not None and lib.cuGetErrorName(res, ctypes.byref(name)) \
                == 0 and name.value:
            label = name.value.decode()
        else:
            label = "unknown"
        raise RuntimeError(f"{what}: CUDA driver error {res} ({label})")


def _nvrtc_check(res: int, what: str, log: str = ""):
    if res != 0:
        msg = _nvrtc.nvrtcGetErrorString(res).decode()
        raise NvrtcError(f"{what}: {msg}" + (f"\n{log}" if log else ""))


def version() -> Tuple[int, int]:
    lib = _load_nvrtc()
    major, minor = _INT(), _INT()
    _nvrtc_check(lib.nvrtcVersion(ctypes.byref(major), ctypes.byref(minor)),
                 "nvrtcVersion")
    return major.value, minor.value


def info() -> dict:
    """The NVRTC library in use: its path and version (loads it)."""
    major, minor = version()
    return {"path": _nvrtc_path, "version": f"{major}.{minor}"}


class Cubin(NamedTuple):
    """A compiled program: its machine code, the lowered (mangled) name
    of each name expression, NVRTC's log, whether it came from the disk
    cache, and the seconds the compile or the cache read took."""
    image: bytes
    digest: str
    lowered: Dict[str, str]
    log: str
    cached: bool
    seconds: float


def _digest(source, options, name_exprs, arch):
    major, minor = version()
    blob = json.dumps([source, list(options), list(name_exprs), arch,
                       major, minor])
    return hashlib.sha256(blob.encode()).hexdigest()


def compile_program(source: str, options: Sequence[str] = (),
                    name_exprs: Sequence[str] = (),
                    use_cache: bool = True) -> Cubin:
    """Compile ``source`` for :data:`ARCH` to a CUBIN.  ``name_exprs`` are
    kernels that are not ``extern "C"`` (templates, C++ names): each is
    registered with ``nvrtcAddNameExpression`` and its lowered name read
    back.  With ``use_cache`` a CUBIN cached for the same key is read
    instead of compiling; a compile always writes the cache.  Raises
    :class:`NvrtcError` with the program log when NVRTC refuses it."""
    t0 = time.perf_counter()
    digest = _digest(source, options, name_exprs, ARCH)
    path = CACHE_DIR / f"{digest}.cubin"
    meta = CACHE_DIR / f"{digest}.json"
    if use_cache and path.exists() and meta.exists():
        lowered = json.loads(meta.read_text())
        return Cubin(path.read_bytes(), digest, lowered, "", True,
                     time.perf_counter() - t0)
    lib = _load_nvrtc()
    prog = ctypes.c_void_p()
    _nvrtc_check(lib.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                        _PROGRAM.encode(), 0, None, None),
                 "nvrtcCreateProgram")
    try:
        for expr in name_exprs:
            _nvrtc_check(lib.nvrtcAddNameExpression(prog, expr.encode()),
                         f"nvrtcAddNameExpression({expr!r})")
        opts = [f"--gpu-architecture={ARCH}", *options]
        argv = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = lib.nvrtcCompileProgram(prog, len(opts), argv)
        size = ctypes.c_size_t()
        _nvrtc_check(lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                     "nvrtcGetProgramLogSize")
        buf = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib.nvrtcGetProgramLog(prog, buf), "nvrtcGetProgramLog")
        log = buf.value.decode(errors="replace")
        _nvrtc_check(res, f"NVRTC failed to compile {_PROGRAM} for {ARCH}",
                     log)
        lowered = {}
        for expr in name_exprs:
            name = ctypes.c_char_p()
            _nvrtc_check(lib.nvrtcGetLoweredName(prog, expr.encode(),
                                                 ctypes.byref(name)),
                         f"nvrtcGetLoweredName({expr!r})")
            lowered[expr] = name.value.decode()
        _nvrtc_check(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        image = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib.nvrtcGetCUBIN(prog, image), "nvrtcGetCUBIN")
        image = image.raw
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    for dst, data in ((path, image), (meta, json.dumps(lowered).encode())):
        tmp = dst.with_name(f".{dst.name}.{os.getpid()}."
                            f"{threading.get_ident()}")
        tmp.write_bytes(data)
        os.replace(tmp, dst)
    return Cubin(image, digest, lowered, log, False,
                 time.perf_counter() - t0)


def _make_current(device: int):
    """Make ``device``'s primary context current on this thread."""
    lib = _load_cuda()
    ctx = _ctxs.get(device)
    if ctx is None:
        with _mu:
            dev = _INT()
            _check(lib.cuDeviceGet(ctypes.byref(dev), device), "cuDeviceGet")
            ctx = ctypes.c_void_p()
            _check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                   "cuDevicePrimaryCtxRetain")
            _ctxs[device] = ctx
    cur = ctypes.c_void_p()
    _check(lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    if cur.value != ctx.value:
        _check(lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    return lib


def load_function(cubin: Cubin, symbol: str, device: int) -> ctypes.c_void_p:
    """The function ``symbol`` (a lowered name, or an ``extern "C"``
    one) of ``cubin`` on ``device``; the module is loaded once per
    device and each function looked up once."""
    key = (cubin.digest, device, symbol)
    fn = _functions.get(key)
    if fn is not None:
        return fn
    lib = _make_current(device)
    with _mu:
        mod = _modules.get((cubin.digest, device))
        if mod is None:
            mod = ctypes.c_void_p()
            _check(lib.cuModuleLoadData(ctypes.byref(mod), cubin.image),
                   "cuModuleLoadData")
            _modules[(cubin.digest, device)] = mod
        fn = ctypes.c_void_p()
        res = lib.cuModuleGetFunction(ctypes.byref(fn), mod, symbol.encode())
        if res != 0:
            _check(res, f"cuModuleGetFunction({symbol!r}): a kernel that "
                        "is not extern \"C\" must be listed in exports")
        _functions[key] = fn
    return fn


def launch(fn: ctypes.c_void_p, grid: Sequence[int], block: Sequence[int],
           shared_mem: int, stream: int, args: Sequence, device: int):
    """``cuLaunchKernel`` of ``fn`` on ``stream`` of ``device``.  ``args``
    are ctypes values (``c_void_p`` for a pointer, ``c_int``,
    ``c_longlong``, ``c_float`` ... for scalars, or a ctypes structure
    or array passed by value), one per kernel parameter.  Dynamic shared
    memory above the 48 KB default is not raised: the driver refuses
    such a launch."""
    lib = _make_current(device)
    params = (ctypes.c_void_p * max(1, len(args)))(
        *[ctypes.addressof(a) for a in args])
    _check(lib.cuLaunchKernel(fn, *grid, *block, int(shared_mem),
                              ctypes.c_void_p(stream), params, None),
           "cuLaunchKernel")
