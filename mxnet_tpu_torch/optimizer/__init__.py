"""Optimizers (≙ the parts of ``mxnet_tpu/optimizer/__init__.py`` that
BERT pretraining uses): the registry, the ``Optimizer`` base with its
per-key update counts, ``Adam`` and ``AdamW``.

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

__all__ = ["Optimizer", "create", "register", "Adam", "AdamW"]

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
    gradients, states and per-key step counts.  ``rescale_grad`` and
    ``clip_gradient`` are applied here first."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.num_update = 0
        # per-key update counts ≙ Optimizer._index_update_count: the
        # per-key t drives Adam's bias correction and advances once per
        # update of that key
        self._index_update_count: Dict[str, int] = {}

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

    def update_multi(self, indices: Sequence, weights: Sequence,
                     grads: Sequence, states: Sequence):
        """One step for each key in ``indices``: each weight is updated in
        place from its gradient and state (both updated in place too),
        with that key's own step count."""
        ts = [self._update_count(i) for i in indices]
        gs = [g.to(w.dtype) for w, g in zip(weights, grads)]
        with torch.no_grad():
            self._update(list(weights), self._preprocess(gs), list(states),
                         ts)

    def update(self, index, weight, grad, state):
        """Single-tensor update (≙ the reference's ``Optimizer.update``);
        updates ``weight`` and ``state`` in place and returns the state."""
        self.update_multi([index], [weight], [grad], [state])
        return state


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
