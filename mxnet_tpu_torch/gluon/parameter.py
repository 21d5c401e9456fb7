"""Parameters of the port's Gluon blocks
(≙ ``mxnet_tpu/gluon/parameter.py``).

A block's parameters are ``torch.nn.Parameter``s and its running
statistics are buffers, registered under the reference's names
(``weight``, ``bias``, ``gamma``, ``beta``, ``running_mean``,
``running_var``).  A parameter whose shape is not known at construction
(``in_channels=0``, ``in_units=0``) starts as an uninitialized tensor and
takes its shape at the first forward, as the reference's deferred init
does, or from the array that is loaded into it.

The file format is the reference's: an ``.npz`` of ``{dotted name:
array}`` written to the exact path given, so a ``.params`` file saved by
the JAX package loads into the port unchanged and back.  numpy has no
bf16: a bf16 tensor is saved widened to fp32 (exact), and a bf16 array
the JAX package saved (two-byte void records, ``ml_dtypes`` being absent
here) is read back by its bits.

``ParameterDict.cast`` (``Block.cast``, ``amp.convert_model``) casts the
floating tensors in place: each keeps its object (``.data`` is
replaced), so an optimizer or Trainer that holds it keeps working; a
deferred one takes the dtype when it materializes.  Integer tensors (the
int8 twins' weights) keep theirs.  Replacing ``.data`` (``cast``,
``reset_ctx``) gives a tensor new storage, which a captured CUDA graph
does not follow: each such call advances :func:`storage_epoch`, and a
fused training step that sees it advance checks its tensors' storage
and, where it moved, drops its graphs and captures anew.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
from torch.nn.parameter import UninitializedTensorMixin

__all__ = ["DeferredInitializationError", "ParamSpec", "ParameterDict",
           "is_initialized", "load_numpy", "as_dtype", "dtype_name",
           "storage_epoch"]

_epoch = 0


def storage_epoch() -> int:
    """How many ``cast`` / ``reset_ctx`` calls gave some tensor new
    storage in this process."""
    return _epoch


def _storage_moved():
    global _epoch
    _epoch += 1


class DeferredInitializationError(Exception):
    pass


def as_dtype(dtype) -> torch.dtype:
    """``dtype`` as the reference gives it (``"bfloat16"``, ``"float16"``,
    a numpy dtype or type, a torch dtype) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) \
        or str(dtype)
    t = getattr(torch, str(name), None)
    if not isinstance(t, torch.dtype):
        raise TypeError(f"dtype {dtype!r} is not a dtype the port knows")
    return t


def dtype_name(dtype) -> str:
    """The numpy-style name of a torch dtype: ``float32``, ``bfloat16``."""
    return str(dtype).rpartition(".")[2]


class ParamSpec:
    """What a block registered under one name: the (possibly partial,
    0 = unknown) shape, its initializer and the dtype it materializes
    in."""

    __slots__ = ("shape", "init", "dtype")

    def __init__(self, shape, init, dtype=torch.float32):
        self.shape = tuple(int(d) for d in shape)
        self.init = init
        self.dtype = dtype

    def known(self) -> bool:
        return all(d > 0 for d in self.shape)

    def fits(self, shape) -> bool:
        return len(shape) == len(self.shape) and all(
            s in (0, d) for s, d in zip(self.shape, shape))


def is_initialized(t) -> bool:
    return not isinstance(t, UninitializedTensorMixin)


def _numpy(t):
    """``t`` as a numpy array on the host; bf16 widened to fp32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class ParameterDict(OrderedDict):
    """``{dotted name: tensor}`` in the reference's order (a block's own
    parameters, then its children's).  ``Block.collect_params`` stamps
    ``_block_ref``, a weak reference to the block it collected from (None
    on a dict built by hand), as the reference does."""

    _block_ref = None

    def save(self, fname):
        # write to the exact path given (np.savez would append ".npz")
        with open(fname, "wb") as f:
            np.savez(f, **{k: _numpy(t)
                           for k, t in self.items() if is_initialized(t)})

    def _owner(self):
        return self._block_ref() if self._block_ref is not None else None

    def cast(self, dtype):
        """≙ ``ParameterDict``/``Parameter.cast``: every floating tensor to
        ``dtype`` in place (the same objects, their gradients too); a
        deferred one of the collected block materializes in ``dtype``;
        integer tensors stay as they are."""
        dt = as_dtype(dtype)
        net = self._owner()
        moved = False
        with torch.no_grad():
            for k, t in self.items():
                if not is_initialized(t):
                    spec = _spec(net, k) if net is not None else None
                    if spec is not None and spec.dtype.is_floating_point:
                        spec.dtype = dt
                elif t.is_floating_point() and t.dtype != dt:
                    t.data = t.data.to(dt)
                    moved = True
                    if t.grad is not None:
                        t.grad = t.grad.to(dt)
        if moved:
            _storage_moved()

    def zero_grad(self):
        """≙ ``zero_grad``: every gradient that exists set to 0 in
        place."""
        for t in self.values():
            if is_initialized(t) and t.grad is not None:
                t.grad.zero_()

    def reset_ctx(self, ctx):
        """≙ ``reset_ctx``: every initialized tensor (and its gradient)
        moved to device ``ctx`` in place, keeping its object."""
        dev = torch.device(ctx)
        moved = False
        with torch.no_grad():
            for t in self.values():
                if is_initialized(t) and t.device != dev:
                    t.data = t.data.to(dev)
                    moved = True
                    if t.grad is not None:
                        t.grad = t.grad.to(dev)
        if moved:
            _storage_moved()


def _owner(net, name):
    owner, _, leaf = name.rpartition(".")
    return (net.get_submodule(owner) if owner else net), leaf


def _spec(net, name):
    mod, leaf = _owner(net, name)
    return getattr(mod, "_specs", {}).get(leaf)


def _pending_device(net, name):
    """The device ``initialize(ctx=...)`` gave a still-deferred tensor."""
    return getattr(_owner(net, name)[0], "_pending_device", None)


def _tensor(a):
    """A numpy array as a CPU tensor: two-byte void records (a bf16 array
    ``ml_dtypes`` wrote) by their bits as bf16."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def assign(t, a, spec: Optional[ParamSpec] = None, name: str = "",
           device=None):
    """Copy the host array or tensor ``a`` into the parameter or buffer
    ``t`` in place (cast to ``t``'s dtype, moved to its device); an
    uninitialized (deferred) ``t`` first takes ``a``'s shape, ``spec``'s
    dtype (fp32 without one) and ``device`` (its own without one)."""
    src = a if isinstance(a, torch.Tensor) else _tensor(np.asarray(a))
    shape = tuple(src.shape)
    with torch.no_grad():
        if is_initialized(t):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: shape {shape} does not match "
                                 f"the parameter's {tuple(t.shape)}")
        else:
            if spec is not None and not spec.fits(shape):
                raise ValueError(f"{name}: shape {shape} does not fit "
                                 f"{spec.shape}")
            t.materialize(shape, device=device or t.device,
                          dtype=spec.dtype if spec is not None
                          else torch.float32)
        t.copy_(src)


def load_numpy(net, arrays, allow_missing: bool = False,
               ignore_extra: bool = False):
    """Copy ``{dotted name: ndarray}`` into ``net``'s parameters and
    buffers, e.g. the JAX package's ``{k: p.data().asnumpy() for k, p in
    net.collect_params().items()}`` (a value may also be a tensor, as a
    checkpoint restores a bf16 leaf).  Each tensor keeps its dtype (the
    values are cast to it); uninitialized (deferred) entries take the
    array's shape and their block's dtype.  Raises ``KeyError`` on a
    missing name (unless ``allow_missing``) or an extra one (unless
    ``ignore_extra``) and ``ValueError`` on a shape that does not fit."""
    params = net.collect_params()
    missing = [k for k in params if k not in arrays]
    extra = [k for k in arrays if k not in params]
    if missing and not allow_missing:
        raise KeyError(f"missing parameters {missing[:5]} "
                       f"({len(missing)} in all)")
    if extra and not ignore_extra:
        raise KeyError(f"extra parameters {sorted(extra)[:5]} "
                       f"({len(extra)} in all)")
    for k, t in params.items():
        if k in arrays:
            assign(t, arrays[k], _spec(net, k), k, _pending_device(net, k))
