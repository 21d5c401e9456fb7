"""Random sampling (≙ ``mxnet_tpu/numpy/random.py``, the module behind
``mx.random`` and ``mx.np.random``).

Every sampler draws from an explicit ``torch.Generator`` of the device it
samples on; the module holds one a device, made at its first draw and
seeded with the current seed (0 until :func:`seed` is called, as the
reference's key chain starts from ``PRNGKey(0)``).  :func:`seed` reseeds
every one of them, so the same seed gives the same stream again on each
device.  The samplers take the reference's arguments; the device is
``device=`` (or ``ctx=``), else that of a tensor argument, else the card
(``context.resolve``: with no card and no device they raise).  Results
have the reference's dtypes: float32 draws, int32 counts and indices.
The streams differ from the reference's (``jax.random`` and torch never
agree): tests hold shapes, dtypes, moments and reproducibility.
"""
from __future__ import annotations

import math
import threading

import numpy as _onp
import torch

from . import context as _context

__all__ = ["seed", "uniform", "normal", "randn", "rand", "randint",
           "choice", "permutation", "shuffle", "beta", "gamma",
           "exponential", "poisson", "laplace", "gumbel", "logistic",
           "multinomial", "categorical", "bernoulli", "lognormal",
           "chisquare", "weibull", "pareto", "rayleigh", "binomial"]


class _Generators:
    """The per-device generators and the seed they start from."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seed = 0
        self._gens = {}

    def seed(self, s):
        with self._lock:
            self._seed = int(s)
            for g in self._gens.values():
                g.manual_seed(self._seed)

    def get(self, device):
        with self._lock:
            g = self._gens.get(device)
            if g is None:
                g = torch.Generator(device=device)
                g.manual_seed(self._seed)
                self._gens[device] = g
            return g


_generators = _Generators()
_gen = _generators.get      # the generator of a device


def seed(s):
    """Reseed the generator of every device (and of devices used later)."""
    _generators.seed(s)


def _shape(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(size)


def _dtype(dtype, default=torch.float32):
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, _onp.dtype(dtype).name)


def _device(ctx, device, *args):
    """``device`` or ``ctx`` if given, else the first tensor argument's
    device, else the card."""
    if device is None:
        device = ctx
    if device is None:
        for a in args:
            if isinstance(a, torch.Tensor):
                return a.device
    return _context.resolve(device)


def _rand(shape, dev, dtype=torch.float32):
    """Uniform draws in [0, 1)."""
    return torch.rand(shape, generator=_gen(dev), device=dev, dtype=dtype)


def _open01(shape, dev, low=1e-7):
    """Uniform draws in [low, 1), kept away from 0 for a log."""
    return _rand(shape, dev) * (1.0 - low) + low


def _exp(shape, dev):
    """Standard exponential draws."""
    return torch.empty(shape, device=dev).exponential_(generator=_gen(dev))


def _std_gamma(alpha, shape, dev):
    """Gamma(alpha, 1) draws of ``shape``."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    return torch._standard_gamma(a.expand(shape).contiguous(),
                                 generator=_gen(dev))


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, device=None):
    """Uniform on [low, high)."""
    dev = _device(ctx, device, low, high)
    return _rand(_shape(size), dev, _dtype(dtype)) * (high - low) + low


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None,
           device=None):
    dev = _device(ctx, device, loc, scale)
    z = torch.randn(_shape(size), generator=_gen(dev), device=dev,
                    dtype=_dtype(dtype))
    return z * scale + loc


def randn(*size, ctx=None, device=None):
    return normal(size=size if size else None, ctx=ctx, device=device)


def rand(*size, ctx=None, device=None):
    return uniform(size=size if size else None, ctx=ctx, device=device)


def randint(low, high=None, size=None, dtype=None, ctx=None, device=None):
    """Integers in [low, high) (or [0, low)), int32 by default."""
    if high is None:
        low, high = 0, low
    dev = _device(ctx, device)
    return torch.randint(int(low), int(high), _shape(size),
                         generator=_gen(dev), device=dev,
                         dtype=_dtype(dtype, torch.int32))


def choice(a, size=None, replace=True, p=None, ctx=None, device=None):
    """Draws from the entries of ``a`` (or ``range(a)``), with the
    probabilities ``p`` when given."""
    dev = _device(ctx, device, a, p)
    pool = torch.arange(a, dtype=torch.int32, device=dev) if \
        isinstance(a, int) else torch.as_tensor(a, device=dev)
    shape = _shape(size)
    n = math.prod(shape)
    if p is not None:
        probs = torch.as_tensor(p, dtype=torch.float32, device=dev)
        idx = torch.multinomial(probs, n, replacement=replace,
                                generator=_gen(dev))
    elif replace:
        idx = torch.randint(0, pool.shape[0], (n,), generator=_gen(dev),
                            device=dev)
    else:
        idx = torch.randperm(pool.shape[0], generator=_gen(dev),
                             device=dev)[:n]
    return pool[idx].reshape(shape + tuple(pool.shape[1:]))


def permutation(x, ctx=None, device=None):
    """A permutation of ``range(x)`` (int32), or of ``x``'s rows."""
    dev = _device(ctx, device, x)
    if isinstance(x, int):
        return torch.randperm(x, generator=_gen(dev), device=dev,
                              dtype=torch.int32)
    x = torch.as_tensor(x, device=dev)
    return x[torch.randperm(x.shape[0], generator=_gen(dev), device=dev)]


def shuffle(x):
    """Shuffle the tensor ``x`` along axis 0, in place."""
    x.copy_(permutation(x))


def beta(a, b, size=None, dtype=None, ctx=None, device=None):
    dev = _device(ctx, device, a, b)
    shape = _shape(size)
    ga, gb = _std_gamma(a, shape, dev), _std_gamma(b, shape, dev)
    return (ga / (ga + gb)).to(_dtype(dtype))


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None, device=None):
    """Gamma with shape ``shape`` and scale ``scale``."""
    dev = _device(ctx, device, shape, scale)
    return (_std_gamma(shape, _shape(size), dev) * scale).to(_dtype(dtype))


def exponential(scale=1.0, size=None, ctx=None, device=None):
    dev = _device(ctx, device, scale)
    return _exp(_shape(size), dev) * scale


def poisson(lam=1.0, size=None, ctx=None, device=None):
    """Poisson counts (int32)."""
    dev = _device(ctx, device, lam)
    rate = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    rate = rate.expand(_shape(size) or rate.shape).contiguous()
    return torch.poisson(rate, generator=_gen(dev)).to(torch.int32)


def laplace(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None,
            device=None):
    """Laplace: the difference of two standard exponentials, scaled."""
    dev = _device(ctx, device, loc, scale)
    shape = _shape(size)
    z = _exp(shape, dev) - _exp(shape, dev)
    return (z * scale + loc).to(_dtype(dtype))


def gumbel(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None,
           device=None):
    """Gumbel: −log of a standard exponential, scaled."""
    dev = _device(ctx, device, loc, scale)
    z = -torch.log(_exp(_shape(size), dev))
    return (z * scale + loc).to(_dtype(dtype))


def logistic(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None,
             device=None):
    """Logistic: ``log(u) − log(1 − u)`` of a uniform u, scaled."""
    dev = _device(ctx, device, loc, scale)
    u = _open01(_shape(size), dev)
    z = torch.log(u) - torch.log1p(-u)
    return (z * scale + loc).to(_dtype(dtype))


def multinomial(n, pvals, size=None, ctx=None, device=None):
    """Counts (int32) of ``n`` draws over the categories of ``pvals``,
    shape ``size + (k,)``."""
    dev = _device(ctx, device, pvals)
    p = torch.as_tensor(pvals, dtype=torch.float32, device=dev)
    shape = _shape(size)
    rows = math.prod(shape)
    idx = torch.multinomial(p.expand(rows, p.shape[-1]), int(n),
                            replacement=True, generator=_gen(dev))
    counts = torch.zeros(rows, p.shape[-1], dtype=torch.int32, device=dev)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts.reshape(shape + (p.shape[-1],))


def categorical(logits, size=None, ctx=None, device=None):
    """Category indices (int32) drawn from the softmax of ``logits`` over
    its last axis; ``size`` ends with ``logits``' leading axes."""
    dev = _device(ctx, device, logits)
    lg = torch.as_tensor(logits, dtype=torch.float32, device=dev)
    batch = tuple(lg.shape[:-1])
    shape = _shape(size) or batch
    lead = shape[:len(shape) - len(batch)]
    if tuple(shape[len(lead):]) != batch:
        raise ValueError(f"size {shape} must end with the logits' leading "
                         f"axes {batch}")
    probs = torch.softmax(lg.reshape(-1, lg.shape[-1]), dim=-1)
    idx = torch.multinomial(probs, math.prod(lead), replacement=True,
                            generator=_gen(dev))
    return idx.t().reshape(shape).to(torch.int32)


def bernoulli(p=0.5, size=None, dtype=None, ctx=None, device=None):
    """1 with probability ``p``, else 0 (float32 by default)."""
    dev = _device(ctx, device, p)
    prob = torch.as_tensor(p, dtype=torch.float32, device=dev)
    prob = prob.expand(_shape(size) or prob.shape).contiguous()
    return torch.bernoulli(prob, generator=_gen(dev)).to(_dtype(dtype))


def lognormal(mean=0.0, sigma=1.0, size=None, ctx=None, device=None):
    dev = _device(ctx, device, mean, sigma)
    return torch.exp(normal(size=size, device=dev) * sigma + mean)


def chisquare(df, size=None, ctx=None, device=None):
    dev = _device(ctx, device, df)
    return 2.0 * _std_gamma(df / 2.0, _shape(size), dev)


def weibull(a, size=None, ctx=None, device=None):
    dev = _device(ctx, device, a)
    return (-torch.log(_open01(_shape(size), dev))) ** (1.0 / a)


def pareto(a, size=None, ctx=None, device=None):
    dev = _device(ctx, device, a)
    return _open01(_shape(size), dev) ** (-1.0 / a) - 1.0


def rayleigh(scale=1.0, size=None, ctx=None, device=None):
    dev = _device(ctx, device, scale)
    return scale * torch.sqrt(-2.0 * torch.log(_open01(_shape(size), dev)))


def binomial(n=1, p=0.5, size=None, ctx=None, device=None):
    """Successes in ``n`` trials of probability ``p`` (float32, as the
    reference's sum of Bernoulli draws)."""
    dev = _device(ctx, device, p)
    prob = torch.as_tensor(p, dtype=torch.float32, device=dev)
    prob = prob.expand(_shape(size) or prob.shape).contiguous()
    count = torch.full_like(prob, float(int(n)))
    return torch.binomial(count, prob, generator=_gen(dev))
