"""Legacy custom-operator API — ≙ ``mxnet_tpu/operator.py:33-161``
(upstream ``python/mxnet/operator.py``: ``CustomOp``, ``CustomOpProp``,
``register``; its runner ``src/operator/custom/custom.cc``).

A custom op is Python: ``CustomOpProp`` gives its names, shapes, types
and operator factory; ``CustomOp.forward`` / ``backward`` fill output
buffers through ``assign`` with the write/add/null requests.  The body
runs on the calling host thread, on the tensors' device (its torch ops
launch on the card for CUDA tensors), inside an ``autograd.Function``,
so ``backward()`` reaches the user's ``CustomOp.backward``::

    @operator.register("mysigmoid")
    class MySigmoidProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return MySigmoid()

    y = nd.Custom(x, op_type="mysigmoid")

``create_operator`` gets the inputs' ``torch.device`` as ``ctx`` (the
JAX package passes None).  Output, gradient and auxiliary buffers are
zero tensors on that device.
"""
from __future__ import annotations

import numpy as _np
import torch

from . import autograd

__all__ = ["CustomOp", "CustomOpProp", "register", "Custom", "get_registry"]

_REGISTRY = {}


class CustomOp:
    """User op body: implement forward/backward over tensors."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError(
            "backward not implemented for this CustomOp")

    @staticmethod
    def assign(dst, req, src):
        """≙ ``CustomOp.assign``: honour the write/add/null request, in
        place on ``dst``."""
        if req == "null":
            return
        src = src if isinstance(src, torch.Tensor) else \
            torch.as_tensor(_np.asarray(src), device=dst.device)
        with torch.no_grad():
            if req in ("write", "inplace"):
                dst.copy_(src)
            elif req == "add":
                dst.add_(src.to(dst.dtype))
            else:
                raise ValueError(f"unknown req {req!r}")


class CustomOpProp:
    """Op metadata: names, shapes, dtypes, and the operator factory."""

    def __init__(self, need_top_grad=True, **kwargs):
        self.need_top_grad_ = need_top_grad
        # the reference passes user kwargs as strings; keep them verbatim
        self._kwargs = kwargs

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        n_out = len(self.list_outputs())
        n_aux = len(self.list_auxiliary_states())
        return in_type, [in_type[0]] * n_out, [in_type[0]] * n_aux

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """≙ ``mx.operator.register``: a decorator storing the prop class."""
    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise TypeError("register() expects a CustomOpProp subclass")
        _REGISTRY[reg_name] = prop_cls
        return prop_cls
    return deco


def get_registry():
    return dict(_REGISTRY)


class _CustomFunction(autograd.Function):
    def __init__(self, op, prop, n_in, aux):
        self._op = op
        self._prop = prop
        self._n_in = n_in
        self._aux = aux

    def forward(self, *inputs):
        dev = inputs[0].device
        in_shapes = [list(a.shape) for a in inputs]
        _, out_shapes, _ = self._prop.infer_shape(in_shapes)
        _, out_types, _ = self._prop.infer_type([a.dtype for a in inputs])
        outs = [torch.zeros(tuple(s), dtype=t, device=dev)
                for s, t in zip(out_shapes, out_types)]
        self._op.forward(autograd.is_training(), ["write"] * len(outs),
                         list(inputs), outs, self._aux)
        self.save_for_backward(*inputs, *outs)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def backward(self, *ograds):
        saved = self._saved
        in_data = list(saved[:self._n_in])
        out_data = list(saved[self._n_in:])
        in_grad = [torch.zeros_like(a) for a in in_data]
        self._op.backward(["write"] * len(in_grad), list(ograds), in_data,
                          out_data, in_grad, self._aux)
        return in_grad[0] if len(in_grad) == 1 else tuple(in_grad)


def Custom(*inputs, op_type=None, **kwargs):
    """≙ ``mx.nd.Custom``: invoke a registered custom op."""
    if op_type is None:
        raise ValueError("Custom requires op_type=")
    if op_type not in _REGISTRY:
        raise KeyError(f"custom op {op_type!r} is not registered "
                       f"(known: {sorted(_REGISTRY)})")
    prop = _REGISTRY[op_type](**{k: str(v) for k, v in kwargs.items()})
    ins = [a if isinstance(a, torch.Tensor) else
           torch.as_tensor(_np.asarray(a)) for a in inputs]
    n_args = len(prop.list_arguments())
    if len(ins) != n_args:
        raise ValueError(f"{op_type} expects {n_args} inputs "
                         f"({prop.list_arguments()}), got {len(ins)}")
    dev = ins[0].device
    in_shapes = [list(a.shape) for a in ins]
    _, _, aux_shapes = prop.infer_shape(in_shapes)
    aux = [torch.zeros(tuple(s), device=dev) for s in aux_shapes]
    op = prop.create_operator(dev, in_shapes, [a.dtype for a in ins])
    return _CustomFunction(op, prop, len(ins), aux)(*ins)
