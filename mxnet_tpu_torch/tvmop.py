"""mx.tvmop — the generated-op registry: elementwise operators whose
CUDA kernels are generated from a registered body at run time.

≙ ``mxnet_tpu/tvmop.py`` (the reference's TVM-op integration: kernels
generated by a compiler and registered beside the hand-written ops).
The JAX package generates a Pallas kernel from a Python body; here a
registered op has two parts:

- a CUDA statement ``body`` over the inputs ``x0 .. x{n-1}`` and the
  output ``o`` (all of the element type ``T``), which is spliced into
  the hand-written kernel template ``csrc/tvmop_elementwise.cuh`` and
  compiled by NVRTC (``rtc.CudaModule``, the same route as a user's rtc
  kernel);
- the decorated plain PyTorch function, which is the op on CPU tensors
  and the oracle the kernel is held against::

    @tvmop.register("tvm_vadd", body="o = x0 + x1;")
    def _vadd(x, y):
        return x + y

    nd.tvm_vadd(a, b)        # CUDA tensors: the kernel; CPU: _vadd

A CUDA call launches the kernel or raises; it never runs the plain
function.  The op lands in this registry and on ``nd`` (the namespace
``library.load`` also joins).  As in the JAX module:

- ``out_like`` picks the input whose shape and dtype the output takes;
  the inputs must share both (the template does not broadcast);
- the element types are float32, float64, int32 and int64; any other
  raises (``TypeError``);
- ``vjp=(fwd, bwd)`` makes the op differentiable through a
  ``torch.autograd.Function``: ``fwd(*xs) -> (y, residuals)``,
  ``bwd(residuals, g) -> grads``; an op without one refuses a tensor
  that requires grad while grad mode is on (``RuntimeError``), rather
  than returning zero gradients;
- ``interpret_fallback`` is accepted for the JAX signature and unused:
  the plain function is the CPU route.

A kernel is compiled once per element type (a tensor's shape is a
launch argument, not a compile-time one, so the JAX module's key by
shape and dtype reduces to dtype here); ``compiles`` counts NVRTC
programs and ``launches`` kernel launches.  The stock ``tvm_vadd``,
``tvm_vmul`` and ``tvm_sigmoid`` register at import, building nothing.
"""
from __future__ import annotations

import ctypes
import inspect
import threading
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as _np
import torch

from . import _nvrtc, rtc

__all__ = ["register", "get", "list_ops", "GeneratedOp", "TEMPLATE",
           "launch_config"]

TEMPLATE = Path(__file__).resolve().parent / "csrc" / "tvmop_elementwise.cuh"
_CTYPES = {torch.float32: ("float", "f32"), torch.float64: ("double", "f64"),
           torch.int32: ("int", "i32"), torch.int64: ("long long", "i64")}
_THREADS = 256
_UNROLL = 4             # MXT_U of the template
_MAX_BLOCKS = 2 ** 31 - 1
_MAX_INPUTS = 8

_REGISTRY: Dict[str, "GeneratedOp"] = {}
_count_mu = threading.Lock()


def launch_config(n: int, itemsize: int, ptrs):
    """(blocks, vec) of a template launch over ``n`` elements: the
    16-byte path when every pointer is 16-byte aligned and ``n`` holds
    one vector; one 256-thread block per ``_UNROLL`` items a thread (the
    kernel loops over what 2^31 - 1 blocks do not cover)."""
    w = 16 // itemsize
    vec = int(n >= w and all(p % 16 == 0 for p in ptrs))
    work = -(-n // w) if vec else n
    return max(1, min(-(-work // (_THREADS * _UNROLL)), _MAX_BLOCKS)), vec


def _as_tensor(a):
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(_np.asarray(a))


class GeneratedOp:
    """A generated elementwise kernel exposed as a framework operator."""

    def __init__(self, name: str, plain: Callable, body: str,
                 out_like: int = 0, vjp=None,
                 interpret_fallback: bool = True):
        if not name.isidentifier():
            raise ValueError(f"op name {name!r} is not an identifier")
        num_inputs = sum(
            p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            for p in inspect.signature(plain).parameters.values())
        if not 1 <= num_inputs <= _MAX_INPUTS:
            raise ValueError(f"{name}: {num_inputs} inputs; the template "
                             f"takes 1..{_MAX_INPUTS}")
        if not 0 <= out_like < num_inputs:
            raise ValueError(f"{name}: out_like={out_like} with "
                             f"{num_inputs} inputs")
        self.name = name
        self.plain = plain
        self.body = body
        self.num_inputs = num_inputs
        self._out_like = out_like
        self._vjp = vjp
        self._modules: Dict[torch.dtype, rtc.CudaModule] = {}
        self._mu = threading.Lock()
        self.launches = 0
        self._fn = _make_function(self) if vjp is not None else None

    def __repr__(self):
        return f"<tvmop.GeneratedOp {self.name}>"

    @property
    def compiles(self) -> int:
        return sum(m.compiles for m in self._modules.values())

    def kernel_name(self, dtype: torch.dtype) -> str:
        return f"mxt_tvmop_{self.name}_{_CTYPES[dtype][1]}"

    def source(self, dtype: torch.dtype) -> str:
        """The CUDA source NVRTC compiles for ``dtype``: the template
        with ``T``, the arity, the kernel's name and the body in front."""
        if dtype not in _CTYPES:
            raise TypeError(f"{self.name}: dtype {dtype} is not one of "
                            f"{list(_CTYPES)}")
        head = (f"// generated op {self.name}, element type "
                f"{_CTYPES[dtype][0]}\n"
                f"typedef {_CTYPES[dtype][0]} T;\n"
                f"#define MXT_NIN {self.num_inputs}\n"
                f"#define MXT_KERNEL {self.kernel_name(dtype)}\n"
                f"#define MXT_BODY {' '.join(self.body.split())}\n")
        return head + TEMPLATE.read_text()

    def module(self, dtype: torch.dtype) -> rtc.CudaModule:
        """The NVRTC module of ``dtype`` (built at its first launch)."""
        mod = self._modules.get(dtype)
        if mod is None:
            with self._mu:
                mod = self._modules.get(dtype)
                if mod is None:
                    mod = rtc.CudaModule(self.source(dtype))
                    self._modules[dtype] = mod
        return mod

    def _check(self, ts):
        if len(ts) != self.num_inputs:
            raise ValueError(f"{self.name} takes {self.num_inputs} inputs, "
                             f"got {len(ts)}")
        ref = ts[self._out_like]
        for t in ts:
            if t.dtype not in _CTYPES:
                raise TypeError(f"{self.name}: dtype {t.dtype} is not one "
                                f"of {list(_CTYPES)}")
            if t.device != ref.device or t.dtype != ref.dtype or \
                    t.shape != ref.shape:
                raise ValueError(
                    f"{self.name}: inputs must share one device, dtype and "
                    f"shape; got {[(str(a.device), a.dtype, tuple(a.shape)) for a in ts]}")
        return ref

    def _launch(self, *ts):
        """The kernel on CUDA tensors: one launch, a new output."""
        ref = self._check(ts)
        if ref.device.type != "cuda":
            raise ValueError(f"{self.name}: no kernel for {ref.device}")
        xs = [t.contiguous() for t in ts]
        out = torch.empty_like(ref, memory_format=torch.contiguous_format)
        n = out.numel()
        if n == 0:
            return out
        dev = ref.device.index
        fn = self.module(ref.dtype).function(self.kernel_name(ref.dtype),
                                             dev)
        blocks, vec = launch_config(n, ref.element_size(),
                                    [t.data_ptr() for t in xs + [out]])
        ins = (ctypes.c_void_p * self.num_inputs)(
            *[t.data_ptr() for t in xs])
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        _nvrtc.launch(fn, (blocks, 1, 1), (_THREADS, 1, 1), 0, stream,
                      [ins, ctypes.c_void_p(out.data_ptr()),
                       ctypes.c_longlong(n), ctypes.c_int(vec)], dev)
        with _count_mu:
            self.launches += 1
        return out

    def forward(self, *ts):
        """The op without autograd: the kernel for CUDA tensors, the
        plain function for CPU tensors."""
        ref = self._check(ts)
        if ref.device.type == "cpu":
            return self.plain(*ts)
        return self._launch(*ts)

    def __call__(self, *args):
        ts = [_as_tensor(a) for a in args]
        if self._fn is not None:
            return self._fn.apply(*ts)
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            raise RuntimeError(
                f"generated op {self.name!r} has no registered vjp; it "
                "cannot take part in autograd (register with "
                "vjp=(fwd, bwd), or call under autograd.pause())")
        return self.forward(*ts)


def _make_function(op: GeneratedOp):
    """The ``torch.autograd.Function`` of an op with a VJP (≙ the JAX
    module's ``jax.custom_vjp``), built once per op."""
    fwd, bwd = op._vjp

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *xs):
            y, res = fwd(*xs)
            single = isinstance(res, torch.Tensor)
            seq = (res,) if single else tuple(res) \
                if isinstance(res, (tuple, list)) else None
            if seq is not None and all(isinstance(r, torch.Tensor)
                                       for r in seq):
                ctx.save_for_backward(*seq)
                ctx.res = None
            else:
                ctx.res = res
            ctx.single = single
            return y

        @staticmethod
        def backward(ctx, g):
            res = ctx.res
            if res is None:
                saved = ctx.saved_tensors
                res = saved[0] if ctx.single else saved
            grads = bwd(res, g)
            return tuple(grads) if isinstance(grads, (tuple, list)) \
                else (grads,)

    _Fn.__name__ = f"{op.name}_fn"
    return _Fn


def register(name: str, body: Optional[str] = None, out_like: int = 0,
             vjp=None, interpret_fallback: bool = True):
    """Register the decorated plain function as operator ``name`` with
    the CUDA statement ``body``; the op takes as many inputs as the
    plain function has positional parameters.  The op lands in this
    registry and on ``nd``."""
    if body is None:
        raise TypeError(f"register({name!r}) needs body=, the CUDA statement "
                        "over x0.. and o")

    def deco(plain):
        op = GeneratedOp(name, plain, body, out_like=out_like, vjp=vjp,
                         interpret_fallback=interpret_fallback)
        _REGISTRY[name] = op
        from . import nd as _nd
        setattr(_nd, name, op)
        return op
    return deco


def get(name: str) -> GeneratedOp:
    return _REGISTRY[name]


def list_ops():
    return sorted(_REGISTRY)


# ----------------------------------------------------- stock generated ops
# ≙ mxnet_tpu/tvmop.py:118-139 (contrib/tvmop/basic/ufunc.py upstream)

@register("tvm_vadd", body="o = x0 + x1;")
def _vadd(x, y):
    return x + y


@register("tvm_vmul", body="o = x0 * x1;")
def _vmul(x, y):
    return x * y


def _sigmoid_fwd(x):
    y = get("tvm_sigmoid").forward(x)
    return y, y


def _sigmoid_bwd(y, g):
    return (g * y * (1.0 - y),)


@register("tvm_sigmoid", body="o = T(1) / (T(1) + mxt_exp(-x0));",
          vjp=(_sigmoid_fwd, _sigmoid_bwd))
def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))
