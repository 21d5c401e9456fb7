"""Optimizers (≙ ``mxnet_tpu/optimizer/__init__.py``): the registry, the
``Optimizer`` base with its step counts (one global count for
``update_multi``, per-key counts for ``update``), its arguments
(``lr_scheduler``, ``rescale_grad``, ``clip_gradient``, ``wd``, ...),
and the reference's eighteen rules under its names: SGD (momentum,
Nesterov), NAG, Adam, AdamW, Adamax, Nadam, AdaGrad, AdaDelta,
AdaBelief, RMSProp (plain and centered), Ftrl, FTML, LAMB, LARS, LANS,
Signum, SGLD and DCASGD.

Each rule is the reference's arithmetic in the reference's order,
applied to the weights IN PLACE under ``torch.no_grad`` (the reference
returns new arrays) with ``torch._foreach_*`` over a list of tensors.
Weight decay applies to every parameter, biases and LayerNorm affines
included, as in the reference.

**The control tensor.**  A rule reads every number that changes from
step to step (the learning rate, ``1 − β₁ᵗ``, ``1 − β₂ᵗ`` and the other
terms of the step count ``t``) from one small fp32 tensor on the
weights' device, never from a Python float.  The host computes those
numbers in numpy fp32, as the reference computes them in fp32 on its
device, and writes them with one ``copy_`` from a pinned buffer before
the rule runs (:class:`_Control`).  So a rule captured once into a CUDA
graph (``parallel.train``) reads each replay's own learning rate and
bias corrections, and an eager step and a replayed step read the same
numbers.  What stays a Python constant of the rule is what the
reference bakes into its traced update: ``rescale_grad``,
``clip_gradient`` and ``wd`` (:meth:`Optimizer._fused_sig`), and each
rule's own hyper-parameters.  No rule syncs with the host: no
``.item()``, no branch on a tensor's value.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

__all__ = ["Optimizer", "create", "register", "SGD", "NAG", "Adam",
           "AdamW", "Adamax", "Nadam", "AdaGrad", "AdaDelta", "AdaBelief",
           "RMSProp", "Ftrl", "FTML", "LAMB", "LARS", "LANS", "Signum",
           "SGLD", "DCASGD"]

_REGISTRY: Dict[str, type] = {}

CONTROL_SLOTS = 4       # fp32 numbers a step hands its rule
_RING = 16              # pinned buffers a device's control cycles through


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    """An optimizer by registered name (case-insensitive); an unknown name
    raises ``KeyError``."""
    if isinstance(name, Optimizer):
        return name
    return _REGISTRY[str(name).lower()](**kwargs)


def _bias_correction(beta, t):
    """``1 − βᵗ`` in fp32, as the reference computes it."""
    return np.float32(1) - np.float32(beta) ** np.float32(t)


class _Control:
    """One device's control tensor: ``CONTROL_SLOTS`` fp32 numbers that a
    rule reads.  On the card it is filled by a non-blocking ``copy_``
    from one of ``_RING`` pinned host buffers, taken in turn; a buffer
    is written again only after the event recorded behind its last copy
    has passed, so a host running ahead of the card never overwrites a
    copy that has not been made yet.  On the CPU it is filled in
    place."""

    def __init__(self, device):
        self.tensor = torch.zeros(CONTROL_SLOTS, dtype=torch.float32,
                                  device=device)
        self._cuda = self.tensor.device.type == "cuda"
        if self._cuda:
            self._host = [torch.zeros(CONTROL_SLOTS, dtype=torch.float32,
                                      pin_memory=True)
                          for _ in range(_RING)]
            self._events = [None] * _RING
            self._next = 0

    def fill(self, values):
        vals = np.zeros(CONTROL_SLOTS, np.float32)
        vals[:len(values)] = values
        if not self._cuda:
            self.tensor.copy_(torch.from_numpy(vals))
            return self.tensor
        i = self._next
        self._next = (i + 1) % _RING
        if self._events[i] is not None:
            self._events[i].synchronize()
        else:
            self._events[i] = torch.cuda.Event()
        self._host[i].numpy()[:] = vals
        with torch.cuda.device(self.tensor.device):
            self.tensor.copy_(self._host[i], non_blocking=True)
            self._events[i].record()
        return self.tensor


class Optimizer:
    """Base optimizer ≙ python/mxnet/optimizer/optimizer.py.

    Subclasses implement ``create_state(index, w)`` and ``_update(ws,
    gs, states, c)``, one step of the rule over lists of weights,
    gradients and states, reading the step's numbers from the control
    tensor ``c`` (``c[0]`` is the learning rate; :meth:`_scalars` says
    what the other slots hold).  ``rescale_grad`` and ``clip_gradient``
    are applied here first.

    ``lr_scheduler`` (a ``lr_scheduler.LRScheduler``) sets the learning
    rate from ``num_update``; ``begin_num_update`` is the count a key's
    first ``update`` continues from.  ``aggregate_num``,
    ``multi_precision`` and ``lazy_update`` are taken and stored as the
    reference stores them (it keeps no ``aggregate_num``; every update
    here is one multi-tensor update, and the port trains fp32 weights
    only)."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, lr_scheduler=None, aggregate_num=None,
                 multi_precision=False, **kwargs):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        self.multi_precision = multi_precision
        self.lazy_update = bool(kwargs.get("lazy_update", True))
        self.num_update = 0
        self.begin_num_update = 0
        # per-key update counts ≙ Optimizer._index_update_count: the t of
        # a single-key ``update`` (Adam's bias correction), advanced once
        # per update of that key
        self._index_update_count: Dict[str, int] = {}
        self._controls: Dict[torch.device, _Control] = {}

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def create_state(self, index, weight) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, ws, gs, states, c):
        raise NotImplementedError

    def _scalars(self, lr, t) -> List[np.float32]:
        """The control tensor's numbers for learning rate ``lr`` (fp32)
        at step ``t``; the base rule reads only ``lr``."""
        return [lr]

    def _fused_sig(self):
        """The Python constants a captured rule bakes in: a captured step
        is valid only while this tuple is unchanged (≙ the reference's
        ``_fused_sig``)."""
        return (self.rescale_grad, self.clip_gradient, self.wd)

    def control(self, device, t) -> torch.Tensor:
        """Fill ``device``'s control tensor for step ``t`` at the current
        ``learning_rate`` and return it.  The tensor is the same one on
        every call, so a rule captured reading it reads each fill."""
        dev = torch.device(device)
        ctl = self._controls.get(dev)
        if ctl is None:
            ctl = self._controls[dev] = _Control(dev)
        return ctl.fill(self._scalars(np.float32(self.learning_rate), t))

    def _update_count(self, index) -> int:
        """Advance this key's step count; num_update = max over keys."""
        idx = str(index)
        c = self._index_update_count.get(idx, self.begin_num_update) + 1
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

    def rule(self, weights, grads, states, c):
        """One step of the rule over ``weights`` (in place) from ``grads``
        and ``states`` (in place), reading the control tensor ``c`` that
        :meth:`control` filled: no host sync, so it may be captured."""
        gs = [g.to(w.dtype) for w, g in zip(weights, grads)]
        with torch.no_grad():
            self._update(list(weights), self._preprocess(gs), list(states),
                         c)

    def _apply(self, weights, grads, states, t):
        self.rule(weights, grads, states, self.control(weights[0].device,
                                                       t))

    def update_multi(self, indices: Sequence, weights: Sequence,
                     grads: Sequence, states: Sequence):
        """One step of every key in ``indices`` (≙ the reference's
        ``update_multi``, which ``Trainer`` calls): ``num_update``
        advances once and is every key's step count, whether or not a key
        took the steps before.  Each weight is updated in place from its
        gradient and state (both updated in place too)."""
        self.num_update += 1
        self._apply(weights, grads, states, self.num_update)

    def update(self, index, weight, grad, state):
        """Single-tensor update (≙ the reference's ``Optimizer.update``)
        with the key's own step count; updates ``weight`` and ``state`` in
        place and returns the state."""
        t = self._update_count(index)
        self._apply([weight], [grad], [state], t)
        return state


def _decay(opt, gs, ws):
    """``g + wd·w`` (the reference adds it whatever wd is; a zero wd
    is left out here)."""
    if opt.wd:
        return torch._foreach_add(gs, torch._foreach_mul(ws, opt.wd))
    return gs


def _ema(states, key, beta, xs):
    """``s = β·s + (1 − β)·x`` in place over ``states[·][key]``."""
    ss = [s[key] for s in states]
    torch._foreach_mul_(ss, beta)
    torch._foreach_add_(ss, torch._foreach_mul(xs, 1 - beta))
    return ss


def _ema_sq(states, key, beta, xs):
    """``s = β·s + (1 − β)·x·x`` in place (``((1 − β)·x)·x``)."""
    ss = [s[key] for s in states]
    torch._foreach_mul_(ss, beta)
    torch._foreach_add_(ss, torch._foreach_mul(
        torch._foreach_mul(xs, 1 - beta), xs))
    return ss


def _norms(xs):
    """Per-tensor 2-norms in fp32, as one (n,) tensor."""
    return torch.stack(torch._foreach_norm(xs))


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

    def _update(self, ws, gs, states, c):
        self._sgd(ws, _decay(self, gs, ws), states, c[0])

    def _sgd(self, ws, gs, states, lr):
        """The step with ``lr`` a 0-d tensor or one per weight."""
        lrg = torch._foreach_mul(gs, lr)
        if self.momentum == 0.0:
            torch._foreach_sub_(ws, lrg)
            return
        moms = [s["mom"] for s in states]
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_sub_(moms, lrg)
        if self.nesterov:
            torch._foreach_add_(ws, torch._foreach_mul(moms, self.momentum))
            torch._foreach_sub_(ws, lrg)
        else:
            torch._foreach_add_(ws, moms)


@register
class NAG(SGD):
    """Nesterov accelerated gradient ≙ optimizer/nag.py."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kw):
        super().__init__(learning_rate=learning_rate, momentum=momentum,
                         nesterov=True, **kw)


@register
class Adam(Optimizer):
    """≙ optimizer/adam.py: g += wd·w; w -= lr·m̂/(√v̂ + ε).  Control:
    lr, 1 − β₁ᵗ, 1 − β₂ᵗ."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kw):
        super().__init__(learning_rate=learning_rate,
                         lazy_update=lazy_update, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return {"mean": torch.zeros_like(weight),
                "var": torch.zeros_like(weight)}

    def _scalars(self, lr, t):
        return [lr, _bias_correction(self.beta1, t),
                _bias_correction(self.beta2, t)]

    def _moments(self, gs, states, c):
        """The moment updates in place → (m̂, v̂)."""
        ms = _ema(states, "mean", self.beta1, gs)
        vs = _ema_sq(states, "var", self.beta2, gs)
        return torch._foreach_div(ms, c[1]), torch._foreach_div(vs, c[2])

    def _den(self, vhat):
        den = torch._foreach_sqrt(vhat)
        torch._foreach_add_(den, self.epsilon)
        return den

    def _update(self, ws, gs, states, c):
        mhat, vhat = self._moments(_decay(self, gs, ws), states, c)
        torch._foreach_sub_(ws, torch._foreach_div(
            torch._foreach_mul(mhat, c[0]), self._den(vhat)))


@register
class AdamW(Adam):
    """Decoupled weight decay ≙ optimizer/adamW.py:
    w -= lr·(m̂/(√v̂ + ε) + wd·w)."""

    def _update(self, ws, gs, states, c):
        mhat, vhat = self._moments(gs, states, c)
        step = torch._foreach_div(mhat, self._den(vhat))
        torch._foreach_add_(step, torch._foreach_mul(ws, self.wd))
        torch._foreach_sub_(ws, torch._foreach_mul(step, c[0]))


@register
class Adamax(Optimizer):
    """≙ the reference's Adamax: g += wd·w; m = β₁m + (1−β₁)g;
    u = max(β₂u, |g|); w -= lr/(1 − β₁ᵗ)·m/(u + 1e-8).  Control: lr,
    lr/(1 − β₁ᵗ)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return {"mean": torch.zeros_like(weight),
                "inf": torch.zeros_like(weight)}

    def _scalars(self, lr, t):
        return [lr, lr / _bias_correction(self.beta1, t)]

    def _update(self, ws, gs, states, c):
        gs = _decay(self, gs, ws)
        ms = _ema(states, "mean", self.beta1, gs)
        us = [s["inf"] for s in states]
        torch._foreach_mul_(us, self.beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        den = torch._foreach_add(us, 1e-8)
        torch._foreach_sub_(ws, torch._foreach_div(
            torch._foreach_mul(ms, c[1]), den))


@register
class Nadam(Adam):
    """≙ the reference's Nadam: Adam's moments, then
    m̄ = β₁m̂ + (1−β₁)·g/(1 − β₁ᵗ); w -= lr·m̄/(√v̂ + ε)."""

    def _update(self, ws, gs, states, c):
        gs = _decay(self, gs, ws)
        mhat, vhat = self._moments(gs, states, c)
        ghat = torch._foreach_div(gs, c[1])
        mbar = torch._foreach_mul(mhat, self.beta1)
        torch._foreach_add_(mbar, torch._foreach_mul(ghat, 1 - self.beta1))
        torch._foreach_sub_(ws, torch._foreach_div(
            torch._foreach_mul(mbar, c[0]), self._den(vhat)))


@register
class AdaGrad(Optimizer):
    """≙ the reference's AdaGrad: g += wd·w; h += g·g;
    w -= lr·g/(√h + eps)."""

    def __init__(self, learning_rate=0.01, eps=1e-7, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.float_eps = eps

    def create_state(self, index, weight):
        return {"hist": torch.zeros_like(weight)}

    def _update(self, ws, gs, states, c):
        gs = _decay(self, gs, ws)
        hs = [s["hist"] for s in states]
        torch._foreach_add_(hs, torch._foreach_mul(gs, gs))
        den = torch._foreach_sqrt(hs)
        torch._foreach_add_(den, self.float_eps)
        torch._foreach_sub_(ws, torch._foreach_div(
            torch._foreach_mul(gs, c[0]), den))


@register
class AdaDelta(Optimizer):
    """≙ the reference's AdaDelta: g += wd·w;
    acc_g = ρ·acc_g + (1−ρ)g²; δ = √(acc_d + ε)/√(acc_g + ε)·g;
    acc_d = ρ·acc_d + (1−ρ)δ²; w -= lr·δ."""

    def __init__(self, learning_rate=1.0, rho=0.9, epsilon=1e-5, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return {"acc_g": torch.zeros_like(weight),
                "acc_d": torch.zeros_like(weight)}

    def _update(self, ws, gs, states, c):
        gs = _decay(self, gs, ws)
        acc_g = _ema_sq(states, "acc_g", self.rho, gs)
        acc_d = [s["acc_d"] for s in states]
        delta = torch._foreach_div(
            torch._foreach_sqrt(torch._foreach_add(acc_d, self.epsilon)),
            torch._foreach_sqrt(torch._foreach_add(acc_g, self.epsilon)))
        torch._foreach_mul_(delta, gs)
        _ema_sq(states, "acc_d", self.rho, delta)
        torch._foreach_sub_(ws, torch._foreach_mul(delta, c[0]))


@register
class AdaBelief(Adam):
    """≙ the reference's AdaBelief: as Adam, with
    v = β₂v + (1−β₂)(g − m)² + ε."""

    def _update(self, ws, gs, states, c):
        gs = _decay(self, gs, ws)
        ms = _ema(states, "mean", self.beta1, gs)
        diff = torch._foreach_sub(gs, ms)
        vs = _ema_sq(states, "var", self.beta2, diff)
        torch._foreach_add_(vs, self.epsilon)
        mhat = torch._foreach_div(ms, c[1])
        vhat = torch._foreach_div(vs, c[2])
        torch._foreach_sub_(ws, torch._foreach_div(
            torch._foreach_mul(mhat, c[0]), self._den(vhat)))


@register
class RMSProp(Optimizer):
    """≙ the reference's RMSProp: g += wd·w; n = ρn + (1−ρ)g²;
    w -= lr·g/(√n + ε).  Centered: ḡ = ρḡ + (1−ρ)g;
    δ = μδ − lr·g/√(n − ḡ² + ε); w += δ."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.rho, self.momentum, self.epsilon, self.centered = \
            rho, momentum, epsilon, centered

    def create_state(self, index, weight):
        s = {"n": torch.zeros_like(weight)}
        if self.centered:
            s["g"] = torch.zeros_like(weight)
            s["delta"] = torch.zeros_like(weight)
        return s

    def _update(self, ws, gs, states, c):
        gs = _decay(self, gs, ws)
        ns = _ema_sq(states, "n", self.rho, gs)
        lrg = torch._foreach_mul(gs, c[0])
        if not self.centered:
            den = torch._foreach_sqrt(ns)
            torch._foreach_add_(den, self.epsilon)
            torch._foreach_sub_(ws, torch._foreach_div(lrg, den))
            return
        gm = _ema(states, "g", self.rho, gs)
        den = torch._foreach_sub(ns, torch._foreach_mul(gm, gm))
        torch._foreach_add_(den, self.epsilon)
        deltas = [s["delta"] for s in states]
        torch._foreach_mul_(deltas, self.momentum)
        torch._foreach_sub_(deltas, torch._foreach_div(
            lrg, torch._foreach_sqrt(den)))
        torch._foreach_add_(ws, deltas)


@register
class Ftrl(Optimizer):
    """≙ the reference's Ftrl: n' = n + g²; σ = (√n' − √n)/lr;
    z += g − σw; w = −(z − sign(z)·λ₁)/((β + √n')/lr + wd) where
    |z| > λ₁, else 0."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return {"z": torch.zeros_like(weight), "n": torch.zeros_like(weight)}

    def _update(self, ws, gs, states, c):
        lr = c[0]
        ns = [s["n"] for s in states]
        zs = [s["z"] for s in states]
        root0 = torch._foreach_sqrt(ns)
        torch._foreach_add_(ns, torch._foreach_mul(gs, gs))
        root1 = torch._foreach_sqrt(ns)
        sigma = torch._foreach_div(torch._foreach_sub(root1, root0), lr)
        torch._foreach_add_(zs, gs)
        torch._foreach_sub_(zs, torch._foreach_mul(sigma, ws))
        den = torch._foreach_div(torch._foreach_add(root1, self.beta), lr)
        if self.wd:
            torch._foreach_add_(den, self.wd)
        for w, z, d in zip(ws, zs, den):
            w.copy_(torch.where(z.abs() > self.lamda1,
                                -(z - z.sign() * self.lamda1) / d, 0.0))


@register
class FTML(Optimizer):
    """≙ the reference's FTML: g += wd·w; v = β₂v + (1−β₂)g²;
    d = (1 − β₁ᵗ)/lr·(√(v/(1 − β₂ᵗ)) + ε); σ = d − β₁d_prev;
    z = β₁z + (1−β₁)g − σw; w = −z/d.  Control: lr, (1 − β₁ᵗ)/lr,
    1 − β₂ᵗ."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return {"d": torch.zeros_like(weight), "v": torch.zeros_like(weight),
                "z": torch.zeros_like(weight)}

    def _scalars(self, lr, t):
        return [lr, _bias_correction(self.beta1, t) / lr,
                _bias_correction(self.beta2, t)]

    def _update(self, ws, gs, states, c):
        gs = _decay(self, gs, ws)
        vs = _ema_sq(states, "v", self.beta2, gs)
        d = torch._foreach_sqrt(torch._foreach_div(vs, c[2]))
        torch._foreach_add_(d, self.epsilon)
        d = torch._foreach_mul(d, c[1])
        ds = [s["d"] for s in states]
        sigma = torch._foreach_sub(d, torch._foreach_mul(ds, self.beta1))
        zs = _ema(states, "z", self.beta1, gs)
        torch._foreach_sub_(zs, torch._foreach_mul(sigma, ws))
        torch._foreach_copy_(ws, torch._foreach_div(
            torch._foreach_neg(zs), d))
        torch._foreach_copy_(ds, d)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments ≙ optimizer/lamb.py: Adam's moments
    (bias-corrected unless ``bias_correction`` is False),
    r = m̂/(√v̂ + ε) + wd·w, the trust ratio ‖w‖/‖r‖ (1 where either is
    0) clipped to [``lower_bound``, ``upper_bound``], w -= lr·ratio·r.
    The norms are ``torch._foreach_norm``'s."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return {"mean": torch.zeros_like(weight),
                "var": torch.zeros_like(weight)}

    _scalars = Adam._scalars

    def _update(self, ws, gs, states, c):
        ms = _ema(states, "mean", self.beta1, gs)
        vs = _ema_sq(states, "var", self.beta2, gs)
        if self.bias_correction:
            ms, vs = torch._foreach_div(ms, c[1]), torch._foreach_div(vs,
                                                                      c[2])
        den = torch._foreach_sqrt(vs)
        torch._foreach_add_(den, self.epsilon)
        r = torch._foreach_div(ms, den)
        if self.wd:
            torch._foreach_add_(r, torch._foreach_mul(ws, self.wd))
        wn, rn = _norms(ws), _norms(r)
        ratio = torch.where((wn > 0) & (rn > 0), wn / rn, 1.0)
        if self.lower_bound is not None:
            ratio = torch.clamp_min(ratio, self.lower_bound)
        if self.upper_bound is not None:
            ratio = torch.clamp_max(ratio, self.upper_bound)
        torch._foreach_sub_(ws, torch._foreach_mul(r, list(
            (c[0] * ratio).unbind())))


@register
class LARS(SGD):
    """Layer-wise adaptive rate scaling ≙ optimizer/lars.py: SGD at
    lr·trust, trust = η‖w‖/(‖g‖ + wd‖w‖ + ε) (1 where either norm is 0),
    from the gradient before weight decay."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate=learning_rate, momentum=momentum,
                         **kw)
        self.eta, self.epsilon = eta, epsilon

    def _update(self, ws, gs, states, c):
        wn, gn = _norms(ws), _norms(gs)
        trust = torch.where((wn > 0) & (gn > 0), self.eta * wn / (
            gn + wn * float(self.wd) + self.epsilon), 1.0)
        self._sgd(ws, _decay(self, gs, ws), states,
                  list((c[0] * trust).unbind()))


@register
class LANS(LAMB):
    """LAMB on normalized gradients (optimizer/lans.py):
    g / (‖g‖ + 1e-12) first."""

    def _update(self, ws, gs, states, c):
        gn = torch._foreach_add(torch._foreach_norm(gs), 1e-12)
        super()._update(ws, torch._foreach_div(gs, gn), states, c)


@register
class Signum(Optimizer):
    """≙ the reference's Signum: mom = μ·mom − (1−μ)g;
    w = (1 − lr·wd_lh)w + lr·sign(mom) (without momentum
    w = (1 − lr·wd_lh)w − lr·sign(g)).  Control: lr, 1 − lr·wd_lh."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return {"mom": torch.zeros_like(weight)}
        return {}

    def _scalars(self, lr, t):
        return [lr, np.float32(1) - lr * np.float32(self.wd_lh)]

    def _update(self, ws, gs, states, c):
        torch._foreach_mul_(ws, c[1])
        if self.momentum != 0.0:
            moms = [s["mom"] for s in states]
            torch._foreach_mul_(moms, self.momentum)
            torch._foreach_sub_(moms, torch._foreach_mul(
                gs, 1 - self.momentum))
            torch._foreach_add_(ws, torch._foreach_mul(
                torch._foreach_sign(moms), c[0]))
        else:
            torch._foreach_sub_(ws, torch._foreach_mul(
                torch._foreach_sign(gs), c[0]))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (optimizer/sgld.py):
    g += wd·w; w = w − lr/2·g + √lr·ε, ε ~ N(0, 1) from this
    optimizer's own ``torch.Generator`` on the weights' device, seeded
    with ``seed`` (the reference draws from its own key; the two
    streams never agree).  Control: lr, lr/2, √lr."""

    def __init__(self, learning_rate=0.01, seed=0, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.seed = seed
        self._generators: Dict[torch.device, torch.Generator] = {}

    def generator(self, device) -> torch.Generator:
        """The generator the noise of weights on ``device`` comes from."""
        dev = torch.device(device)
        gen = self._generators.get(dev)
        if gen is None:
            gen = self._generators[dev] = torch.Generator(
                device=dev).manual_seed(self.seed)
        return gen

    def _scalars(self, lr, t):
        return [lr, lr / np.float32(2), np.sqrt(lr)]

    def _noise(self, w):
        return torch.randn(w.shape, generator=self.generator(w.device),
                           device=w.device, dtype=torch.float32).to(w.dtype)

    def _update(self, ws, gs, states, c):
        gs = _decay(self, gs, ws)
        noise = [self._noise(w) for w in ws]
        torch._foreach_sub_(ws, torch._foreach_mul(gs, c[1]))
        torch._foreach_add_(ws, torch._foreach_mul(noise, c[2]))


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (optimizer/dcasgd.py): g += wd·w;
    g += λ·g·g·(w − w_prev); mom = μ·mom − lr·g; w += mom; w_prev = w.
    The state ``prev`` starts at the weight."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04, **kw):
        super().__init__(learning_rate=learning_rate, **kw)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        return {"mom": torch.zeros_like(weight),
                "prev": weight.detach().clone()}

    def _update(self, ws, gs, states, c):
        gs = _decay(self, gs, ws)
        prev = [s["prev"] for s in states]
        comp = torch._foreach_mul(torch._foreach_mul(gs, self.lamda), gs)
        torch._foreach_mul_(comp, torch._foreach_sub(ws, prev))
        gs = torch._foreach_add(gs, comp)
        moms = [s["mom"] for s in states]
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_sub_(moms, torch._foreach_mul(gs, c[0]))
        torch._foreach_add_(ws, moms)
        torch._foreach_copy_(prev, ws)

