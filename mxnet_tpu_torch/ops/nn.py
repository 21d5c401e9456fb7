"""Neural-network ops the GPT slice composes (≙ the parts of
``mxnet_tpu/ops/nn.py`` it uses)."""
from __future__ import annotations

import torch.nn.functional as F

from .cuda_kernels import layernorm_fused

__all__ = ["layer_norm", "gelu"]


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis (≙ ``ops/nn.py layer_norm``).  A CUDA
    tensor launches the LayerNorm kernel; a CPU tensor takes its plain
    version."""
    return layernorm_fused(x, gamma, beta, eps)


def gelu(x):
    """GELU with the tanh approximation — ``jax.nn.gelu``'s default (the
    exact erf form that ``F.gelu`` defaults to differs by ~4e-4)."""
    return F.gelu(x, approximate="tanh")
