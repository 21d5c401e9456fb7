"""Neural-network ops the port's slices compose (≙ the parts of
``mxnet_tpu/ops/nn.py`` they use).

Layouts are the JAX package's: activations NHWC (channels last), conv
weights HWIO ``(kh, kw, in/groups, out)``, dense weights ``(out, in)``.
Convolution and pooling run as PyTorch calls on channels-last NCHW
views of the NHWC tensors (cuDNN on the card, with TF32 off: see
``context.exact_fp32``), as the JAX package leaves them to XLA; the one
Pallas kernel of the image path, the fused conv + frozen BN (+ add)
(+ ReLU) of ``residual_block``, is ``ops/conv_block.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import conv_block
from .cuda_kernels import LayerNormFn, layernorm_fused

__all__ = ["layer_norm", "gelu", "activation", "fully_connected",
           "convolution", "pooling", "batch_norm", "residual_block"]


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


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softplus": F.softplus,
    "softsign": F.softsign,
}


def activation(x, act_type: str = "relu"):
    """≙ ``npx.activation`` for the element-wise activations above."""
    try:
        return _ACTIVATIONS[act_type](x)
    except KeyError:
        raise ValueError(f"unknown act_type {act_type!r}; have "
                         f"{sorted(_ACTIVATIONS)}") from None


def _pair(v, n=2):
    return (v,) * n if isinstance(v, int) else tuple(v)


def fully_connected(x, weight, bias=None, flatten: bool = True):
    """≙ FullyConnected: ``x·weightᵀ + bias`` with weight (out, in);
    ``flatten`` folds every axis after the first into one."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, bias)


def _nchw(x):
    """NCHW view of an NHWC tensor (channels-last memory)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _check_layout(layout):
    if layout != "NHWC":
        raise ValueError(f"layout {layout!r}: the port's image ops take "
                         f"NHWC")


def convolution(x, weight, bias=None, stride=1, pad=0, dilate=1,
                groups: int = 1, layout: str = "NHWC"):
    """2-D convolution ≙ Convolution, NHWC × HWIO.  One ``F.conv2d`` on
    the channels-last view; the result is NHWC-contiguous when the
    backend keeps channels last (cuDNN does).  The JAX package's
    space-to-depth stem rewrite is a TPU layout trick computing the same
    conv and is not carried over."""
    _check_layout(layout)
    return _nhwc(F.conv2d(_nchw(x), weight.permute(3, 2, 0, 1), bias,
                          _pair(stride), _pair(pad), _pair(dilate), groups))


def pooling(x, kernel=2, stride=None, pad=0, pool_type: str = "max",
            global_pool: bool = False, count_include_pad: bool = True,
            layout: str = "NHWC"):
    """≙ Pooling over NHWC: max (−inf padding) or avg windows, or the
    global average of the whole H×W plane."""
    _check_layout(layout)
    if global_pool:
        if pool_type != "avg":
            raise ValueError(f"global {pool_type} pooling is not ported")
        return x.mean(dim=(1, 2), keepdim=True)
    kernel = _pair(kernel)
    stride = _pair(stride if stride is not None else kernel)
    pad = _pair(pad)
    if pool_type == "max":
        out = F.max_pool2d(_nchw(x), kernel, stride, pad)
    elif pool_type == "avg":
        out = F.avg_pool2d(_nchw(x), kernel, stride, pad,
                           count_include_pad=count_include_pad)
    else:
        raise ValueError(f"pool_type {pool_type!r} is not ported")
    return _nhwc(out)


def _training_slice(what):
    return NotImplementedError(
        f"{what} in training mode (batch statistics and their running "
        f"averages) belongs to the ResNet-training slice of the port, "
        f"which is not ported yet; run the block in inference mode")


def batch_norm(x, gamma, beta, running_mean, running_var, momentum=0.9,
               eps: float = 1e-5, use_global_stats: bool = False,
               training: bool = False, axis: int = -1):
    """≙ BatchNorm, frozen statistics only: normalizes ``axis`` by the
    running mean/var.  Returns ``(out, running_mean, running_var)`` (the
    stats unchanged), as the JAX package's inference branch does."""
    if training and not use_global_stats:
        raise _training_slice("batch_norm")
    ch = axis % x.dim()
    xc = x.movedim(ch, 1) if ch != 1 else x
    out = F.batch_norm(xc, running_mean, running_var, gamma, beta,
                       training=False, eps=eps)
    out = out.movedim(1, ch) if ch != 1 else out
    return out, running_mean, running_var


def residual_block(x, weight, gamma, beta, running_mean, running_var,
                   residual=None, momentum=0.9, eps: float = 1e-5,
                   use_global_stats: bool = False, training: bool = False,
                   relu: bool = True):
    """Fused 3×3/s1 SAME conv + frozen BatchNorm (+ residual add)
    (+ ReLU), NHWC/HWIO → ``(out, running_mean, running_var)``.  Every
    call goes to ``conv_block.conv_affine``: the kernel on the card, its
    plain version on the CPU.  ``x``, ``weight`` and ``residual`` are
    made contiguous here (a no-op on the path, where the producing
    cuDNN and element-wise calls keep NHWC contiguous), since the kernel
    takes contiguous NHWC only."""
    if training and not use_global_stats:
        raise _training_slice("residual_block")
    out = conv_block.conv_affine(
        x.contiguous(), weight.contiguous(), gamma, beta, running_mean,
        running_var, residual.contiguous() if residual is not None
        else None, eps=eps, relu=relu)
    return out, running_mean, running_var
