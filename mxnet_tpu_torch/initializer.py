"""Weight initializers (≙ the subset of ``mxnet_tpu/initializer.py`` the
Gluon layers default to).

Each initializer fills a new float32 CPU tensor of a given shape from an
explicit ``torch.Generator``; the caller moves it to its device.  The
numbers differ from the JAX package's for the same seed (the two
random streams never agree): parity tests carry weights across as numpy
instead of relying on these.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "register", "create"]

_REGISTRY = {}


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    """An initializer from an instance, a registered name, or None (the
    reference's default, ``Uniform(0.07)``)."""
    if isinstance(name, Initializer):
        return name
    if name is None:
        return Uniform(0.07)
    return _REGISTRY[str(name).lower()](**kwargs)


class Initializer:
    def __call__(self, shape, generator: torch.Generator) -> torch.Tensor:
        return self.init_array(tuple(int(d) for d in shape), generator)

    def init_array(self, shape, generator):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__


@register
class Zero(Initializer):
    def init_array(self, shape, generator):
        return torch.zeros(shape)


@register
class One(Initializer):
    def init_array(self, shape, generator):
        return torch.ones(shape)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def init_array(self, shape, generator):
        return torch.full(shape, float(self.value))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def init_array(self, shape, generator):
        return (torch.rand(shape, generator=generator) * 2 - 1) * self.scale


@register
class Normal(Initializer):
    """Gaussian with mean 0 and standard deviation ``sigma``."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def init_array(self, shape, generator):
        return torch.randn(shape, generator=generator) * self.sigma


def _fan(shape):
    """fan_in/fan_out for dense (out, in) and conv HWIO (kh, kw, in, out)."""
    if len(shape) == 2:
        return shape[1], shape[0]
    if len(shape) == 4:
        rf = shape[0] * shape[1]
        return shape[2] * rf, shape[3] * rf
    if len(shape) >= 1:
        f = int(math.prod(shape) ** 0.5) or 1
        return f, f
    return 1, 1


@register
class Xavier(Initializer):
    """≙ ``mx.init.Xavier``: uniform or gaussian, scaled by
    ``sqrt(magnitude / factor)`` over the avg/in/out fan."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def init_array(self, shape, generator):
        fan_in, fan_out = _fan(shape)
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in}.get(
            self.factor_type, fan_out)
        scale = math.sqrt(self.magnitude / max(factor, 1.0))
        if self.rnd_type == "uniform":
            return (torch.rand(shape, generator=generator) * 2 - 1) * scale
        return torch.randn(shape, generator=generator) * scale
