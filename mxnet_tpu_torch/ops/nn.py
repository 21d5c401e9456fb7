"""Neural-network ops the port's slices compose (≙ the parts of
``mxnet_tpu/ops/nn.py`` they use).

Layouts are the JAX package's: activations NHWC (channels last), conv
weights HWIO ``(kh, kw, in/groups, out)``, dense weights ``(out, in)``.
Convolution and pooling run as PyTorch calls on channels-last NCHW
views of the NHWC tensors (cuDNN on the card, with TF32 off: see
``context.exact_fp32``), as the JAX package leaves them to XLA, and so
do BatchNorm, GELU, the embedding gather, dropout and the losses.  The
last-axis softmax and LayerNorm are the Pallas kernels of
``ops/pallas_kernels.py`` in the reference and the CUDA kernels of
``ops/cuda_kernels.py`` here; the fused conv + BN (+ add) (+ ReLU) of
``residual_block``, in inference and training, is ``ops/conv_block.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import conv_block
from .cuda_kernels import (LayerNormFn, SoftmaxFn, layernorm_fused,
                           softmax_fused)

__all__ = ["softmax", "layer_norm", "gelu", "activation", "fully_connected",
           "convolution", "pooling", "batch_norm", "residual_block",
           "log_softmax", "pick", "softmax_cross_entropy", "embedding",
           "dropout"]


def _records(*ts):
    """Autograd would record a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def softmax(x, axis: int = -1, temperature=None):
    """≙ ``ops/nn.py softmax`` (``npx.softmax``): ``x`` is divided by
    ``temperature`` first when one other than 1 is given.  Over the last
    axis a CUDA tensor launches the softmax kernel and a CPU tensor takes
    its plain version, through ``SoftmaxFn`` (closed-form backward) only
    when autograd records, as ``layer_norm`` does.  Any other axis is
    ``torch.softmax``, where the reference has ``jax.nn.softmax``."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if axis in (-1, x.dim() - 1):
        if _records(x):
            return SoftmaxFn.apply(x)
        return softmax_fused(x)
    return torch.softmax(x, dim=axis)


def layer_norm(x, gamma, beta, axis: int = -1, eps: float = 1e-5):
    """LayerNorm over ``axis`` (≙ ``ops/nn.py layer_norm``), gamma and
    beta of that axis's length.  Over the last axis a CUDA tensor
    launches the LayerNorm kernel; a CPU tensor takes its plain version.
    With autograd recording and an input that requires grad, the call
    goes through ``LayerNormFn`` (closed-form backward); otherwise no
    autograd node is made, which the decode step, issuing 25 of these
    per token, should not pay for.  Another axis is moved last, normalized
    the same way and moved back."""
    if axis not in (-1, x.dim() - 1):
        out = layer_norm(x.movedim(axis, -1).contiguous(), gamma, beta,
                         eps=eps)
        return out.movedim(-1, axis)
    if _records(x, gamma, beta):
        return LayerNormFn.apply(x, gamma, beta, eps)
    return layernorm_fused(x, gamma, beta, eps)


def gelu(x, approximate: bool = True):
    """≙ ``ops/nn.py gelu`` (``jax.nn.gelu``): the tanh approximation by
    default, as GPT and the functional BERT call it; ``approximate=False``
    is the exact erf form, which Gluon's ``GELU`` block defaults to (the
    two differ by ~4e-4)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


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


def batch_norm(x, gamma, beta, running_mean, running_var, momentum=0.9,
               eps: float = 1e-5, use_global_stats: bool = False,
               training: bool = False, axis: int = -1):
    """≙ BatchNorm over channel ``axis``; returns ``(out, new_mean,
    new_var)``.

    Training (and not ``use_global_stats``), fp32: batch statistics from
    one-pass *shifted* sums (the first element of each channel is
    subtracted first, so ``E[x²] − E[x]²`` does not cancel when
    ``|mean| ≫ std``), the biased batch variance, and running averages
    under MXNet's convention ``new = momentum·running +
    (1 − momentum)·batch`` (detached: they are state, not outputs to
    differentiate).  The gradient flows through the batch statistics by
    autograd, as the reference's fp32 branch leaves it to JAX's AD.
    ``F.batch_norm`` is not used here: its momentum is ``1 − momentum``
    and it stores the unbiased variance.

    Otherwise: normalization by the running statistics, which come back
    unchanged."""
    ch = axis % x.dim()
    if training and not use_global_stats:
        if x.dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(
                f"batch_norm in training mode on {x.dtype}: the port "
                f"trains in fp32; low-precision BatchNorm comes with the "
                f"bf16 serving / amp item of the port's queue")
        C = x.shape[ch]
        shape = [1] * x.dim()
        shape[ch] = C
        rax = tuple(i for i in range(x.dim()) if i != ch)
        s = x.detach().movedim(ch, -1).reshape(-1, C)[0]
        xs = x - s.reshape(shape)
        m1 = xs.mean(dim=rax)
        m2 = (xs * xs).mean(dim=rax)
        mean = m1 + s
        var = torch.clamp(m2 - m1 * m1, min=0.0)
        out = ((x - mean.reshape(shape))
               * torch.rsqrt(var.reshape(shape) + eps)
               * gamma.reshape(shape) + beta.reshape(shape))
        new_mean = momentum * running_mean + (1 - momentum) * mean.detach()
        new_var = momentum * running_var + (1 - momentum) * var.detach()
        return out, new_mean, new_var
    xc = x.movedim(ch, 1) if ch != 1 else x
    out = F.batch_norm(xc, running_mean, running_var, gamma, beta,
                       training=False, eps=eps)
    out = out.movedim(1, ch) if ch != 1 else out
    return out, running_mean, running_var


def residual_block(x, weight, gamma, beta, running_mean, running_var,
                   residual=None, momentum=0.9, eps: float = 1e-5,
                   use_global_stats: bool = False, training: bool = False,
                   relu: bool = True):
    """Fused 3×3/s1 SAME conv + BatchNorm (+ residual add) (+ ReLU),
    NHWC/HWIO → ``(out, new_mean, new_var)`` with ``batch_norm``'s
    running-statistics contract.  Every call goes to ``ops/conv_block``:
    its kernels on the card, their plain versions on the CPU.

    Training: ``residual_block_fused`` (conv + batch statistics, then the
    affine pass; its backward runs dgrad and wgrad).  Frozen
    (``use_global_stats`` or inference) with autograd recording: the same
    Function's frozen branch.  Frozen without gradients: ``conv_affine``
    alone, with no autograd node.  ``x``, ``weight`` and ``residual`` are
    made contiguous here (a no-op on the path, where the producing cuDNN
    and element-wise calls keep NHWC contiguous), since the kernels take
    contiguous NHWC only."""
    x = x.contiguous()
    weight = weight.contiguous()
    if residual is not None:
        residual = residual.contiguous()
    frozen = use_global_stats or not training
    if frozen and not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, gamma, beta, residual))):
        out = conv_block.conv_affine(x, weight, gamma, beta, running_mean,
                                     running_var, residual, eps=eps,
                                     relu=relu)
        return out, running_mean, running_var
    out, bmean, bvar = conv_block.residual_block_fused(
        x, weight, gamma, beta, running_mean, running_var, residual,
        eps=eps, frozen=frozen, relu=relu)
    if frozen:
        return out, running_mean, running_var
    new_mean = momentum * running_mean + (1 - momentum) * bmean
    new_var = momentum * running_var + (1 - momentum) * bvar
    return out, new_mean, new_var


def log_softmax(x, axis: int = -1):
    """≙ ``ops/nn.py log_softmax``."""
    return F.log_softmax(x, dim=axis)


def pick(x, index, axis: int = -1, keepdims: bool = False):
    """≙ pick: the element of ``x`` along ``axis`` at ``index`` for every
    other position."""
    idx = index.long().unsqueeze(axis)
    out = torch.gather(x, axis, idx)
    return out if keepdims else out.squeeze(axis)


def softmax_cross_entropy(logits, labels, sparse: bool = True,
                          axis: int = -1):
    """≙ SoftmaxCrossEntropy: ``−log_softmax(logits)`` at the label (or
    summed against dense label distributions)."""
    logp = log_softmax(logits, axis=axis)
    if sparse:
        return -pick(logp, labels, axis=axis)
    return -(labels * logp).sum(dim=axis)


def embedding(indices, weight):
    """≙ Embedding: the rows of ``weight`` at integer ``indices`` (any
    shape; int32 or int64).  Out-of-range ids are not checked here: the
    reference's ``jnp.take`` gives NaN rows for them, ``F.embedding``
    fails (a device assert on the card)."""
    return F.embedding(indices, weight)


def dropout(x, rate: float, generator=None, training: bool = True):
    """≙ ``ops/nn.py dropout``: outside training or at rate 0 the input
    itself; else each element kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``.  The random draws come from the explicit
    ``torch.Generator`` (on its own device; the keep mask then moves to
    ``x``'s), as the reference draws from an explicit key."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator,
                      device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, 0.0).to(x.dtype)
