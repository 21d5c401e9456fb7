"""Neural-network ops the GPT and BERT slices compose (≙ the parts of
``mxnet_tpu/ops/nn.py`` they use)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_kernels import LayerNormFn, layernorm_fused

__all__ = ["layer_norm", "gelu"]


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis (≙ ``ops/nn.py layer_norm``).  A CUDA
    tensor launches the LayerNorm kernel; a CPU tensor takes its plain
    version.  With autograd recording and an input that requires grad,
    the call goes through ``LayerNormFn`` (closed-form backward);
    otherwise no autograd node is made, which the decode step, issuing
    25 of these per token, should not pay for."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return LayerNormFn.apply(x, gamma, beta, eps)
    return layernorm_fused(x, gamma, beta, eps)


def gelu(x):
    """GELU with the tanh approximation — ``jax.nn.gelu``'s default (the
    exact erf form that ``F.gelu`` defaults to differs by ~4e-4)."""
    return F.gelu(x, approximate="tanh")
