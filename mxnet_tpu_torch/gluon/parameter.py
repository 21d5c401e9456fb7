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
the JAX package loads into the port unchanged and back.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch.nn.parameter import UninitializedTensorMixin

__all__ = ["DeferredInitializationError", "ParamSpec", "ParameterDict",
           "is_initialized", "load_numpy"]


class DeferredInitializationError(Exception):
    pass


class ParamSpec:
    """What a block registered under one name: the (possibly partial,
    0 = unknown) shape and its initializer."""

    __slots__ = ("shape", "init")

    def __init__(self, shape, init):
        self.shape = tuple(int(d) for d in shape)
        self.init = init

    def known(self) -> bool:
        return all(d > 0 for d in self.shape)

    def fits(self, shape) -> bool:
        return len(shape) == len(self.shape) and all(
            s in (0, d) for s, d in zip(self.shape, shape))


def is_initialized(t) -> bool:
    return not isinstance(t, UninitializedTensorMixin)


class ParameterDict(OrderedDict):
    """``{dotted name: tensor}`` in the reference's order (a block's own
    parameters, then its children's).  ``Block.collect_params`` stamps
    ``_block_ref``, a weak reference to the block it collected from (None
    on a dict built by hand), as the reference does."""

    _block_ref = None

    def save(self, fname):
        # write to the exact path given (np.savez would append ".npz")
        with open(fname, "wb") as f:
            np.savez(f, **{k: t.detach().cpu().numpy()
                           for k, t in self.items() if is_initialized(t)})


def _spec(net, name):
    owner, _, leaf = name.rpartition(".")
    mod = net.get_submodule(owner) if owner else net
    return getattr(mod, "_specs", {}).get(leaf)


def load_numpy(net, arrays, allow_missing: bool = False,
               ignore_extra: bool = False):
    """Copy ``{dotted name: ndarray}`` into ``net``'s parameters and
    buffers, e.g. the JAX package's ``{k: p.data().asnumpy() for k, p in
    net.collect_params().items()}``.  Uninitialized (deferred) entries
    take the array's shape.  Raises ``KeyError`` on a missing name
    (unless ``allow_missing``) or an extra one (unless ``ignore_extra``)
    and ``ValueError`` on a shape that does not fit."""
    params = net.collect_params()
    missing = [k for k in params if k not in arrays]
    extra = [k for k in arrays if k not in params]
    if missing and not allow_missing:
        raise KeyError(f"missing parameters {missing[:5]} "
                       f"({len(missing)} in all)")
    if extra and not ignore_extra:
        raise KeyError(f"extra parameters {sorted(extra)[:5]} "
                       f"({len(extra)} in all)")
    with torch.no_grad():
        for k, t in params.items():
            if k not in arrays:
                continue
            a = np.asarray(arrays[k])
            if is_initialized(t):
                if tuple(t.shape) != a.shape:
                    raise ValueError(f"{k}: shape {a.shape} does not match "
                                     f"the parameter's {tuple(t.shape)}")
            else:
                spec = _spec(net, k)
                if spec is not None and not spec.fits(a.shape):
                    raise ValueError(f"{k}: shape {a.shape} does not fit "
                                     f"{spec.shape}")
                t.materialize(a.shape, device=t.device, dtype=torch.float32)
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
