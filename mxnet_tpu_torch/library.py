"""mx.library — external extension-library loader.

≙ ``mxnet_tpu/library.py:28-193`` (upstream ``mx.library.load`` →
``MXLoadLib``).  Loads a ``.so`` built against ``include/mxtpu/
lib_api.h``, checks its version (``MXTLibVersion() == 1``), reads its op
descriptors and registers each op on ``nd``, differentiable through
``autograd.Function`` when the library exports a backward.

The library's hooks are host C code by their ABI (raw float32 buffers
and int64 shapes), as in the JAX package.  So an op's route is the
host, whatever the device: a CUDA tensor is copied to the host, handed
to the library, and the result is copied back to the tensor's device.
That round trip is the op's own route, not a fallback.  ``infer_shape``
works as in the JAX module (absent: the output is shaped like input 0).
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess

import numpy as _np
import torch

from . import autograd

__all__ = ["load", "loaded_libs", "compile_example", "ExternalOp"]

_MAX_DIM = 8
_VERSION = 1
_LOADED = {}


class _CTensor(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_float)),
                ("shape", ctypes.POINTER(ctypes.c_int64)),
                ("ndim", ctypes.c_int)]


_FWD = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(_CTensor), ctypes.c_int,
                        ctypes.POINTER(_CTensor), ctypes.c_int,
                        ctypes.c_char_p)
_BWD = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(_CTensor), ctypes.c_int,
                        ctypes.POINTER(_CTensor), ctypes.c_int,
                        ctypes.POINTER(_CTensor), ctypes.c_char_p)
_INFER = ctypes.CFUNCTYPE(ctypes.c_int,
                          ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                          ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int64),
                          ctypes.POINTER(ctypes.c_int), ctypes.c_char_p)


class _COpDesc(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char_p),
                ("num_inputs", ctypes.c_int),
                ("num_outputs", ctypes.c_int),
                ("forward", _FWD),
                ("backward", _BWD),
                ("infer_shape", _INFER)]


def _host(t: torch.Tensor) -> _np.ndarray:
    """A contiguous float32 host copy of ``t``."""
    return _np.ascontiguousarray(
        t.detach().to("cpu", torch.float32).numpy())


def _as_ct(arrs):
    """float32 host arrays -> (array of _CTensor, keepalive list)."""
    keep = []
    ct = (_CTensor * len(arrs))()
    for i, a in enumerate(arrs):
        shp = (ctypes.c_int64 * max(1, a.ndim))(*a.shape)
        keep.extend([a, shp])
        ct[i] = _CTensor(a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         shp, a.ndim)
    return ct, keep


class ExternalOp:
    """One op of a loaded library, exposed as a Python callable."""

    def __init__(self, lib_name, desc):
        self.lib_name = lib_name
        self.name = desc.name.decode()
        self.n_in = desc.num_inputs
        self.n_out = desc.num_outputs
        self._fwd = desc.forward
        self._bwd = desc.backward if ctypes.cast(
            desc.backward, ctypes.c_void_p).value else None
        self._infer = desc.infer_shape if ctypes.cast(
            desc.infer_shape, ctypes.c_void_p).value else None

    def __repr__(self):
        return f"<library.ExternalOp {self.name} of {self.lib_name}>"

    def _out_shape(self, in_np, attrs):
        if self._infer is None:
            return in_np[0].shape
        shapes = [(ctypes.c_int64 * max(1, a.ndim))(*a.shape) for a in in_np]
        arr = (ctypes.POINTER(ctypes.c_int64) * len(in_np))(
            *[ctypes.cast(s, ctypes.POINTER(ctypes.c_int64))
              for s in shapes])
        ndims = (ctypes.c_int * len(in_np))(*[a.ndim for a in in_np])
        out_shape = (ctypes.c_int64 * _MAX_DIM)()
        out_ndim = ctypes.c_int(0)
        rc = self._infer(arr, ndims, len(in_np), out_shape,
                         ctypes.byref(out_ndim), attrs)
        if rc != 0:
            raise RuntimeError(f"{self.name}: infer_shape failed")
        return tuple(out_shape[i] for i in range(out_ndim.value))

    def __call__(self, *inputs, **kwargs):
        attrs = json.dumps({k: str(v) for k, v in kwargs.items()}).encode()
        op = self

        class _Fn(autograd.Function):
            def forward(self, *ins):
                dev = ins[0].device
                in_np = [_host(a) for a in ins]
                out_np = [_np.zeros(op._out_shape(in_np, attrs), _np.float32)
                          for _ in range(op.n_out)]
                cin, k1 = _as_ct(in_np)
                cout, k2 = _as_ct(out_np)
                rc = op._fwd(cin, len(in_np), cout, len(out_np), attrs)
                if rc != 0:
                    raise RuntimeError(f"{op.name}: forward failed")
                outs = [torch.from_numpy(o).to(dev) for o in out_np]
                self.save_for_backward(*ins)
                return outs[0] if len(outs) == 1 else tuple(outs)

            def backward(self, *ograds):
                if op._bwd is None:
                    raise RuntimeError(
                        f"{op.name}: library exports no backward")
                ins = self._saved
                in_np = [_host(a) for a in ins]
                og_np = [_host(g) for g in ograds]
                ig_np = [_np.zeros_like(a) for a in in_np]
                cog, k1 = _as_ct(og_np)
                cin, k2 = _as_ct(in_np)
                cig, k3 = _as_ct(ig_np)
                rc = op._bwd(cog, len(og_np), cin, len(in_np), cig, attrs)
                if rc != 0:
                    raise RuntimeError(f"{op.name}: backward failed")
                grads = [torch.from_numpy(g).to(a.device)
                         for g, a in zip(ig_np, ins)]
                return grads[0] if len(grads) == 1 else tuple(grads)

        if len(inputs) != self.n_in:
            raise ValueError(f"{self.name} expects {self.n_in} inputs, "
                             f"got {len(inputs)}")
        ins = [a if isinstance(a, torch.Tensor) else
               torch.as_tensor(_np.asarray(a)) for a in inputs]
        return _Fn()(*ins)


def load(path, verbose=True):
    """≙ ``mx.library.load(path)`` → ``MXLoadLib``: dlopen, the version
    handshake, and every op registered on ``nd``."""
    lib = ctypes.CDLL(path)
    lib.MXTLibVersion.argtypes = []
    lib.MXTLibVersion.restype = ctypes.c_int
    version = lib.MXTLibVersion()
    if version != _VERSION:
        raise RuntimeError(
            f"{path}: lib API version {version} != supported {_VERSION} "
            "(the reference makes the same versioned handshake)")
    lib.MXTLibNumOps.argtypes = []
    lib.MXTLibNumOps.restype = ctypes.c_int
    lib.MXTLibOpGet.restype = _COpDesc
    lib.MXTLibOpGet.argtypes = [ctypes.c_int]
    ops = {}
    from . import nd as _nd
    for i in range(lib.MXTLibNumOps()):
        op = ExternalOp(path, lib.MXTLibOpGet(i))
        ops[op.name] = op
        setattr(_nd, op.name, op)
        if verbose:
            print(f"[mx.library] registered external op nd.{op.name} "
                  f"({op.n_in}→{op.n_out}"
                  f"{', differentiable' if op._bwd else ''})")
    _LOADED[path] = {"handle": lib, "ops": ops}
    return ops


def loaded_libs():
    return dict(_LOADED)


def compile_example(out_dir):
    """Build the repo's example extension
    (``example/extensions/lib_custom_op/custom_ops.cc``) with ``g++``
    into ``out_dir``; return the ``.so`` path."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(repo, "example", "extensions", "lib_custom_op",
                       "custom_ops.cc")
    out = os.path.join(out_dir, "libcustom_ops.so")
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                    f"-I{os.path.join(repo, 'include')}", src, "-o", out],
                   check=True)
    return out
