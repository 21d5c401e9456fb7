"""Gluon blocks as ``torch.nn.Module``s (≙ ``mxnet_tpu/gluon/block.py``
``Block``, ``HybridBlock``, ``Sequential``, ``HybridSequential``).

The module tree keeps the reference's child names, so
:meth:`Block.collect_params` returns the reference's dotted names
(``features.4.0.body.1.running_var``, ``output.weight``) and a
``.params`` file moves between the two packages.  A block starts in
inference mode (``training`` False), as the reference runs outside
``autograd.record``; ``.train()`` turns training on (BatchNorm on batch
statistics, see ``gluon/nn``).
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedBuffer, UninitializedParameter

from .. import context as _context
from .. import initializer as _init
from .parameter import (DeferredInitializationError, ParameterDict,
                        ParamSpec, is_initialized, load_numpy)

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential"]


class Block(nn.Module):
    """Base building block ≙ ``gluon.Block``."""

    def __init__(self):
        super().__init__()
        self._specs = {}            # name -> ParamSpec
        self._pending = None        # (given init, generator) for deferred
        self._active = False
        self.training = False

    # -- registration ----------------------------------------------------
    def _param(self, name, shape, init=None, differentiable=True):
        """Register a parameter; an unknown (0) dim defers its shape."""
        self._specs[name] = ParamSpec(shape, init)
        self.register_parameter(
            name, UninitializedParameter(requires_grad=differentiable))

    def _aux(self, name, shape, init=None):
        """Register a running statistic (a buffer, never differentiated)."""
        self._specs[name] = ParamSpec(shape, init)
        self.register_buffer(name, UninitializedBuffer())

    def _fill(self, name, shape, init, gen, device):
        t = getattr(self, name)
        if not is_initialized(t):
            t.materialize(shape, device=device, dtype=torch.float32)
        with torch.no_grad():
            t.copy_(init(shape, gen))

    def _finish(self, name, shape, device):
        """Give deferred ``name`` its shape at the first forward and
        initialize it with what :meth:`initialize` left pending."""
        if is_initialized(getattr(self, name)):
            return
        if self._pending is None:
            raise DeferredInitializationError(
                f"parameter {name!r} of {type(self).__name__} is not "
                f"initialized; call net.initialize() or load parameters")
        given, gen = self._pending
        self._fill(name, tuple(shape), self._initializer(name, given), gen,
                   device)

    # -- parameters ------------------------------------------------------
    def collect_params(self, select=None) -> ParameterDict:
        """``{dotted name: tensor}``: parameters and running statistics,
        under the reference's names; ``select`` is a regex on them."""
        out = ParameterDict(self.state_dict(keep_vars=True))
        if select is not None:
            pat = re.compile(select)
            out = ParameterDict((k, v) for k, v in out.items()
                                if pat.match(k))
        return out

    def initialize(self, init=None, ctx=None, force_reinit=False,
                   seed: int = 0, generator=None):
        """Fill every parameter from ``init`` when one is given (it
        overrides each parameter's own, as in the JAX package's
        ``Parameter.initialize``), else from its own initializer
        (``Xavier`` where it has none), drawing from ``generator``
        (default: a CPU generator seeded with ``seed``).
        Parameters of unknown shape are filled at their first forward, on
        the device of its input.  ``ctx`` is the device to allocate on:
        by default the card (``context.resolve``), as the reference
        allocates on JAX's default device; with no card and no ``ctx``
        this raises.  Pass ``ctx="cpu"`` to work on the CPU."""
        device = _context.resolve(ctx)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(int(seed))
        given = _init.create(init) if init is not None else None
        for mod in self.modules():
            if not isinstance(mod, Block):
                continue
            for name, spec in mod._specs.items():
                t = getattr(mod, name)
                if is_initialized(t) and not force_reinit:
                    continue
                shape = tuple(t.shape) if is_initialized(t) else \
                    spec.shape if spec.known() else None
                if shape is None:
                    mod._pending = (given, gen)
                else:
                    mod._fill(name, shape, mod._initializer(name, given),
                              gen, device)

    def _initializer(self, name, given):
        return given or _init.create(self._specs[name].init or
                                     _init.Xavier())

    # -- persistence -----------------------------------------------------
    def save_parameters(self, filename):
        """≙ ``Block.save_parameters``: the reference's ``.npz``."""
        self.collect_params().save(filename)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """≙ ``Block.load_parameters``: :func:`load_numpy` on the
        ``.npz`` (deferred parameters take the stored shapes), then the
        net moves to ``ctx`` when one is given."""
        with np.load(filename, allow_pickle=False) as z:
            load_numpy(self, {k: z[k] for k in z.files},
                       allow_missing=allow_missing,
                       ignore_extra=ignore_extra)
        if ctx is not None:
            self.to(torch.device(ctx))

    def hybridize(self, active=True, **kwargs):
        """Accepted for the reference's API; it records the flag and does
        nothing else.  The port runs the forward eagerly: no
        ``torch.compile`` and no CUDA graph capture, so inference and
        training mode behave the same either way."""
        for mod in self.modules():
            if isinstance(mod, Block):
                mod._active = bool(active)


class HybridBlock(Block):
    """≙ ``gluon.HybridBlock``; :meth:`Block.hybridize` is a no-op here."""


class _Sequence:
    """Container behaviour shared by the two sequential blocks."""

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._layers)), b)
            self._layers.append(b)
        return self

    def forward(self, x, *args):
        for b in self._layers:
            x = b(x)
        return x

    def __len__(self):
        return len(self._layers)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return type(self)().add(*self._layers[i])
        return self._layers[i]

    def __iter__(self):
        return iter(self._layers)


class Sequential(_Sequence, Block):
    """≙ ``gluon.nn.Sequential``: children named "0", "1", ..."""

    def __init__(self):
        super().__init__()
        self._layers = []


class HybridSequential(_Sequence, HybridBlock):
    """≙ ``gluon.nn.HybridSequential``."""

    def __init__(self):
        super().__init__()
        self._layers = []
