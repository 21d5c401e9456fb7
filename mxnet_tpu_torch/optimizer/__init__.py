"""Optimizers (≙ the parts of ``mxnet_tpu/optimizer/__init__.py`` that
BERT pretraining and ResNet training use): the registry, the
``Optimizer`` base with its step counts (one global count for
``update_multi``, per-key counts for ``update``), ``SGD`` (momentum,
Nesterov), ``NAG``, ``Adam`` and ``AdamW``.

Each rule is the reference's arithmetic, applied to the weights IN PLACE
under ``torch.no_grad`` (the reference returns new arrays) with
``torch._foreach_*`` over a list of tensors.  Weight decay applies to
every parameter, biases and LayerNorm affines included, as in the
reference.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = ["Optimizer", "create", "register", "SGD", "NAG", "Adam",
           "AdamW"]

_REGISTRY: Dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    """An optimizer by registered name (case-insensitive); an unknown name
    raises ``KeyError``."""
    if isinstance(name, Optimizer):
        return name
    return _REGISTRY[str(name).lower()](**kwargs)


class Optimizer:
    """Base optimizer ≙ python/mxnet/optimizer/optimizer.py.

    Subclasses implement ``create_state(index, w)`` and ``_update(ws,
    gs, states, ts)``, one step of the rule over lists of weights,
    gradients, states and step counts.  ``rescale_grad`` and
    ``clip_gradient`` are applied here first."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.num_update = 0
        # per-key update counts ≙ Optimizer._index_update_count: the t of
        # a single-key ``update`` (Adam's bias correction), advanced once
        # per update of that key
        self._index_update_count: Dict[str, int] = {}

    @property
    def learning_rate(self):
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def create_state(self, index, weight) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, ws, gs, states, ts):
        raise NotImplementedError

    def _update_count(self, index) -> int:
        """Advance this key's step count; num_update = max over keys."""
        idx = str(index)
        c = self._index_update_count.get(idx, 0) + 1
        self._index_update_count[idx] = c
        self.num_update = max(c, self.num_update)
        return c

    def _preprocess(self, gs: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.rescale_grad != 1.0:
            gs = torch._foreach_mul(gs, self.rescale_grad)
        if self.clip_gradient is not None:
            gs = [g.clamp(-self.clip_gradient, self.clip_gradient)
                  for g in gs]
        return gs

    def _apply(self, weights, grads, states, ts):
        gs = [g.to(w.dtype) for w, g in zip(weights, grads)]
        with torch.no_grad():
            self._update(list(weights), self._preprocess(gs), list(states),
                         ts)

    def update_multi(self, indices: Sequence, weights: Sequence,
                     grads: Sequence, states: Sequence):
        """One step of every key in ``indices`` (≙ the reference's
        ``update_multi``, which ``Trainer`` calls): ``num_update``
        advances once and is every key's step count, whether or not a key
        took the steps before.  Each weight is updated in place from its
        gradient and state (both updated in place too)."""
        self.num_update += 1
        self._apply(weights, grads, states, [self.num_update] * len(weights))

    def update(self, index, weight, grad, state):
        """Single-tensor update (≙ the reference's ``Optimizer.update``)
        with the key's own step count; updates ``weight`` and ``state`` in
        place and returns the state."""
        self._apply([weight], [grad], [state], [self._update_count(index)])
        return state


@register
class SGD(Optimizer):
    """≙ optimizer/sgd.py: ``g += wd·w``; without momentum ``w −= lr·g``;
    with it ``mom = μ·mom − lr·g`` and ``w += mom`` (Nesterov: ``w +=
    μ·mom − lr·g``)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, nesterov=False,
                 **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum
        self.nesterov = nesterov

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return {"mom": torch.zeros_like(weight)}
        return {}

    def _update(self, ws, gs, states, ts):
        lr = self.learning_rate
        if self.wd:
            gs = torch._foreach_add(gs, ws, alpha=self.wd)
        if self.momentum == 0.0:
            torch._foreach_add_(ws, gs, alpha=-lr)
            return
        moms = [s["mom"] for s in states]
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_add_(moms, gs, alpha=-lr)
        if self.nesterov:
            torch._foreach_add_(ws, moms, alpha=self.momentum)
            torch._foreach_add_(ws, gs, alpha=-lr)
        else:
            torch._foreach_add_(ws, moms)


@register
class NAG(SGD):
    """Nesterov accelerated gradient ≙ optimizer/nag.py."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kw):
        super().__init__(learning_rate=learning_rate, momentum=momentum,
                         nesterov=True, **kw)


def _moments(opt, gs, states, ts):
    """Adam's moment updates in place → (m̂, v̂) lists."""
    ms = [s["mean"] for s in states]
    vs = [s["var"] for s in states]
    torch._foreach_mul_(ms, opt.beta1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - opt.beta1))
    torch._foreach_mul_(vs, opt.beta2)
    torch._foreach_add_(vs, torch._foreach_mul(
        torch._foreach_mul(gs, 1 - opt.beta2), gs))
    mhat = torch._foreach_div(ms, _bias_correction(opt.beta1, ts))
    vhat = torch._foreach_div(vs, _bias_correction(opt.beta2, ts))
    return mhat, vhat


def _bias_correction(beta, ts):
    # 1 - beta**t in fp32, as the reference computes it
    b = np.float32(beta)
    return [float(np.float32(1) - b ** np.float32(t)) for t in ts]


@register
class Adam(Optimizer):
    """≙ optimizer/adam.py: g += wd·w; w -= lr·m̂/(√v̂ + ε)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return {"mean": torch.zeros_like(weight),
                "var": torch.zeros_like(weight)}

    def _den(self, vhat):
        den = torch._foreach_sqrt(vhat)
        torch._foreach_add_(den, self.epsilon)
        return den

    def _update(self, ws, gs, states, ts):
        if self.wd:
            gs = torch._foreach_add(gs, torch._foreach_mul(ws, self.wd))
        mhat, vhat = _moments(self, gs, states, ts)
        torch._foreach_sub_(ws, torch._foreach_div(
            torch._foreach_mul(mhat, self.lr), self._den(vhat)))


@register
class AdamW(Adam):
    """Decoupled weight decay ≙ optimizer/adamW.py:
    w -= lr·(m̂/(√v̂ + ε) + wd·w)."""

    def _update(self, ws, gs, states, ts):
        mhat, vhat = _moments(self, gs, states, ts)
        step = torch._foreach_div(mhat, self._den(vhat))
        torch._foreach_add_(step, torch._foreach_mul(ws, self.wd))
        torch._foreach_sub_(ws, torch._foreach_mul(step, self.lr))
