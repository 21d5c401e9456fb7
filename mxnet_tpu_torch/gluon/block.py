"""Gluon blocks as ``torch.nn.Module``s (≙ ``mxnet_tpu/gluon/block.py``
``Block``, ``HybridBlock``, ``Sequential``, ``HybridSequential``).

The module tree keeps the reference's child names, so
:meth:`Block.collect_params` returns the reference's dotted names
(``features.4.0.body.1.running_var``, ``output.weight``) and a
``.params`` file moves between the two packages.  A block starts in
inference mode (``training`` False), as the reference runs outside
``autograd.record``; ``.train()`` turns training on (BatchNorm on batch
statistics, see ``gluon/nn``) wherever no ``autograd`` scope sets the
mode: inside ``autograd.record()`` / ``train_mode()`` /
``predict_mode()`` the scope decides, as in the reference.

The reference's Block surface around that: ``cast`` (a cast made before
the first forward holds for the deferred parameters), ``zero_grad``,
``reset_ctx``, ``params``, ``summary`` (the reference's text) and
``flops`` (its count of the inference forward's matrix work, taken on
shapes alone).  ``export``, ``optimize_for`` and ``SymbolBlock`` need
the symbol graph and the subgraph registry (``symbol/``), which are not
ported: they raise.
"""
from __future__ import annotations

import re
import weakref

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedBuffer, UninitializedParameter

from .. import context as _context
from .. import initializer as _init
from .. import random as _random
from .parameter import (DeferredInitializationError, ParameterDict,
                        ParamSpec, _spec, dtype_name, is_initialized,
                        load_numpy)

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "SymbolBlock"]

_SYMBOL = ("needs the symbol graph and the subgraph registry (symbol/), "
           "Queue 1 item 8 of the port, not ported yet")


class Block(nn.Module):
    """Base building block ≙ ``gluon.Block``.  ``prefix`` and ``params``
    are accepted and ignored, as the reference does."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._specs = {}            # name -> ParamSpec
        self._pending = None        # (given init, generator) for deferred
        self._active = False
        self.training = False

    # -- registration ----------------------------------------------------
    def _param(self, name, shape, init=None, differentiable=True,
               dtype=torch.float32):
        """Register a parameter; an unknown (0) dim defers its shape."""
        self._specs[name] = ParamSpec(shape, init, dtype)
        self.register_parameter(
            name, UninitializedParameter(requires_grad=differentiable))

    def _aux(self, name, shape, init=None):
        """Register a running statistic (a buffer, never differentiated)."""
        self._specs[name] = ParamSpec(shape, init)
        self.register_buffer(name, UninitializedBuffer())

    def _fill(self, name, shape, init, gen, device):
        t = getattr(self, name)
        if not is_initialized(t):
            t.materialize(shape, device=device,
                          dtype=self._specs[name].dtype)
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
        under the reference's names; ``select`` is a regex on them.  The
        dict holds a weak reference to this block (``_block_ref``), by
        which ``Trainer.fuse_step`` finds the net it trains."""
        out = ParameterDict(self.state_dict(keep_vars=True))
        if select is not None:
            pat = re.compile(select)
            out = ParameterDict((k, v) for k, v in out.items()
                                if pat.match(k))
        out._block_ref = weakref.ref(self)
        return out

    @property
    def params(self) -> ParameterDict:
        """≙ ``Block.params``: this block's own parameters and running
        statistics (not its children's), by their short names."""
        return ParameterDict(
            (k, v) for k, v in self.state_dict(keep_vars=True).items()
            if "." not in k)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, seed=None, generator=None):
        """Fill every parameter from ``init`` when one is given (it
        overrides each parameter's own, as in the JAX package's
        ``Parameter.initialize``), else from its own initializer
        (``Xavier`` where it has none), drawing from ``generator``, else
        from a CPU generator seeded with ``seed``, else from the CPU
        generator of ``mx.random``, which ``mx.seed`` seeds (as the
        reference draws from its seeded key chain).  Weights are drawn
        on the CPU and then moved.
        Parameters of unknown shape are filled at their first forward, on
        the device of its input.  ``ctx`` is the device to allocate on:
        by default the card (``context.resolve``), as the reference
        allocates on JAX's default device; with no card and no ``ctx``
        this raises.  Pass ``ctx="cpu"`` to work on the CPU.  ``verbose``
        is accepted, as the reference accepts it.  Each tensor is drawn in
        fp32 and takes its parameter's dtype (``cast``)."""
        device = _context.resolve(ctx)
        if generator is not None:
            gen = generator
        elif seed is not None:
            gen = torch.Generator().manual_seed(int(seed))
        else:
            gen = _random._gen(torch.device("cpu"))
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

    def cast(self, dtype):
        """≙ ``Block.cast``: every floating parameter and running
        statistic to ``dtype`` (``"bfloat16"``, ``"float16"``, ...), in
        place (``ParameterDict.cast``); deferred ones materialize in it;
        integer tensors stay as they are."""
        self.collect_params().cast(dtype)

    def zero_grad(self):
        """≙ ``Block.zero_grad``: every gradient set to 0 in place."""
        self.collect_params().zero_grad()

    def reset_ctx(self, ctx):
        """≙ ``Block.reset_ctx``: every initialized tensor moved to
        ``ctx``, keeping its object."""
        self.collect_params().reset_ctx(ctx)

    # -- introspection ---------------------------------------------------
    def summary(self, *inputs):
        """≙ ``Block.summary``: the reference's text, one line a
        parameter (name, shape as a tuple, dtype by its numpy name; a
        deferred one with its 0 dims), returned.  ``inputs`` are
        accepted and not used, as in the reference."""
        lines = [f"{self.__class__.__name__}:"]
        for k, t in self.collect_params().items():
            spec = _spec(self, k)
            if is_initialized(t) or spec is None:
                shape, dt = tuple(t.shape), t.dtype
            else:
                shape, dt = spec.shape, spec.dtype
            lines.append(f"  {k:<40} {str(shape):<20} {dtype_name(dt)}")
        return "\n".join(lines)

    def flops(self, *example_args) -> int:
        """≙ ``HybridBlock.flops``: 2 × the multiply-adds of every matrix
        product and convolution of one inference forward on inputs of
        ``example_args``' shapes and dtypes; element-wise, normalization
        and pooling work is not counted.  The forward runs on fake CPU
        tensors (``FakeTensorMode``) under ``FlopCounterMode``: no kernel
        is launched and nothing is computed, wherever the net lives, so
        the count is the same on the card and on the CPU.  A stride-2
        stem of at most 4 channels (odd kernel of 5 or more, ``ops/nn.py
        convolution``'s space-to-depth case in the reference) is priced
        as the reference's rewritten conv, (⌈kh/2⌉·⌈kw/2⌉·4C) a pixel.
        The parameters must be initialized (one forward resolves
        deferred shapes); the reference's no-argument form, which reuses
        the last call's shapes, is not kept: the port records no
        signature per call."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.func import functional_call
        from torch.utils.flop_counter import FlopCounterMode

        from .. import autograd
        if not example_args:
            raise ValueError("flops() needs example inputs")
        state = dict(self.named_parameters())
        state.update(self.named_buffers())
        if not all(is_initialized(t) for t in state.values()):
            raise DeferredInitializationError(
                "flops() needs initialized parameters: run one forward "
                "(deferred shapes) or load them first")
        with FakeTensorMode():
            fake = {k: torch.empty(tuple(t.shape), dtype=t.dtype)
                    for k, t in state.items()}
            args = tuple(torch.empty(tuple(a.shape), dtype=a.dtype)
                         if isinstance(a, torch.Tensor) else a
                         for a in example_args)
            with FlopCounterMode(display=False, custom_mapping={
                    torch.ops.aten.convolution: _conv_flop}) as counter, \
                    torch.no_grad(), autograd.predict_mode():
                functional_call(self, fake, args)
        return int(counter.get_total_flops())

    def export(self, path, epoch=0, remove_amp_cast=True, input_shape=None):
        """≙ ``HybridBlock.export``: raises (the symbol graph)."""
        raise NotImplementedError(f"export {_SYMBOL}")

    def optimize_for(self, x, backend=None, clear=True, **kwargs):
        """≙ ``HybridBlock.optimize_for``: raises (the subgraph
        registry)."""
        raise NotImplementedError(f"optimize_for {_SYMBOL}")

    # -- persistence -----------------------------------------------------
    def save_parameters(self, filename, deduplicate=False):
        """≙ ``Block.save_parameters``: the reference's ``.npz`` (bf16
        tensors widened to fp32); ``deduplicate`` is accepted and
        ignored, as in the reference."""
        self.collect_params().save(filename)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """≙ ``Block.load_parameters``: :func:`load_numpy` on the
        ``.npz`` (deferred parameters take the stored shapes; every
        tensor keeps its dtype), then the net moves to ``ctx`` when one
        is given.  ``cast_dtype`` is accepted and ignored, as in the
        reference."""
        with np.load(filename, allow_pickle=False) as z:
            load_numpy(self, {k: z[k] for k in z.files},
                       allow_missing=allow_missing,
                       ignore_extra=ignore_extra)
        if ctx is not None:
            self.to(torch.device(ctx))

    def hybridize(self, active=True, **kwargs):
        """Accepted for the reference's API; it records the flag.  The
        forward itself runs eagerly either way (no ``torch.compile``), so
        inference and training mode behave the same; the flag lets
        ``Trainer.fuse_step`` capture the whole training step as one CUDA
        graph, as the reference fuses only hybridized blocks."""
        for mod in self.modules():
            if isinstance(mod, Block):
                mod._active = bool(active)


def _conv_flop(x_shape, w_shape, _bias, stride, _padding, dilation,
               transposed, _output_padding, groups, out_shape=None,
               **kwargs) -> int:
    """``aten.convolution``'s count as the reference prices it (see
    :meth:`Block.flops`): 2 × out pixels × (kh·kw·C/groups), or for the
    space-to-depth stems the rewritten conv's (⌈kh/2⌉·⌈kw/2⌉·4C)."""
    from torch.utils.flop_counter import conv_flop_count
    if (not transposed and len(x_shape) == 4 and tuple(stride) == (2, 2)
            and tuple(dilation) == (1, 1) and groups == 1
            and x_shape[1] <= 4):
        kh, kw = w_shape[2], w_shape[3]
        if kh % 2 and kw % 2 and max(kh, kw) >= 5 and \
                min(x_shape[2], x_shape[3]) >= max(kh, kw):
            pixels = 1
            for d in out_shape:
                pixels *= d
            return 2 * pixels * ((kh + 1) // 2) * ((kw + 1) // 2) * 4 * \
                x_shape[1]
    return conv_flop_count(x_shape, w_shape, out_shape,
                           transposed=transposed)


class HybridBlock(Block):
    """≙ ``gluon.HybridBlock``; :meth:`Block.hybridize` only records the
    flag that ``Trainer.fuse_step`` reads."""


class SymbolBlock(HybridBlock):
    """≙ ``gluon.SymbolBlock``: raises (the symbol graph)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"SymbolBlock {_SYMBOL}")

    @staticmethod
    def imports(symbol_file, input_names=None, param_file=None, ctx=None):
        raise NotImplementedError(f"SymbolBlock.imports {_SYMBOL}")


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

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._layers = []


class HybridSequential(_Sequence, HybridBlock):
    """≙ ``gluon.nn.HybridSequential``."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._layers = []
