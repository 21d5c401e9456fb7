"""Neural-network ops the port's slices compose (≙ the parts of
``mxnet_tpu/ops/nn.py`` they use).

Layouts are the JAX package's: activations NHWC (channels last), conv
weights HWIO ``(kh, kw, in/groups, out)``, dense weights ``(out, in)``.
Convolution and pooling run as PyTorch calls on channels-last NCHW
views of the NHWC tensors (cuDNN on the card, with TF32 off: see
``context.exact_fp32``), as the JAX package leaves them to XLA, except
the lone fp32 or bf16 3×3/s1 conv, which is ``ops/pallas_conv.py``; and
so do BatchNorm (below fp32 in training the reference's ``_bn_train``
custom VJP, :class:`_BNTrain`), GELU, the embedding gather, dropout and the losses.  The
last-axis softmax and LayerNorm are the Pallas kernels of
``ops/pallas_kernels.py`` in the reference and the CUDA kernels of
``ops/cuda_kernels.py`` here; the fused conv + BN (+ add) (+ ReLU) of
``residual_block``, in inference and training, is ``ops/conv_block.py``.
The rest of the reference's ops (the activation zoo, transposed and N-d
convolution and pooling, the instance, group and RMS norms, one-hot,
top-k, the sequence ops, global-norm clipping) are plain torch or one
library call each, as the reference leaves them to XLA.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import conv_block, cuda_int8, pallas_conv
from .cuda_kernels import _HALF, _as_dtype as _const
from .cuda_kernels import (LayerNormFn, SoftmaxFn, layernorm_fused,
                           softmax_fused, softmax_plain)

__all__ = ["softmax", "layer_norm", "gelu", "activation", "fully_connected",
           "convolution", "pooling", "batch_norm", "residual_block",
           "log_softmax", "masked_softmax", "masked_log_softmax", "pick",
           "softmax_cross_entropy",
           "sigmoid_binary_cross_entropy", "embedding",
           "dropout", "quantized_dense", "quantized_conv", "silu", "swish",
           "mish", "leaky_relu", "elu", "selu", "prelu", "hard_sigmoid",
           "log_sigmoid", "conv_transpose", "convolution_nd", "pooling_nd",
           "reflection_pad2d", "rms_norm", "instance_norm", "group_norm",
           "l2_normalize", "one_hot", "topk", "sequence_mask",
           "sequence_last", "sequence_reverse", "clip_global_norm"]


def _records(*ts):
    """Autograd would record a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def softmax(x, axis: int = -1, temperature=None):
    """≙ ``ops/nn.py softmax`` (``npx.softmax``): ``x`` is divided by
    ``temperature`` first when one other than 1 is given.  For fp32, bf16
    or fp16 ``x`` over the last axis a CUDA tensor launches the softmax
    kernel (its instance of the dtype) and a CPU tensor takes its plain
    version, through ``SoftmaxFn`` (closed-form backward) only when
    autograd records, as ``layer_norm`` does.  The half instances round
    where the reference's jitted ``jax.nn.softmax`` rounds
    (``cuda_kernels.softmax_plain``).  Over any other axis fp32 is
    ``torch.softmax``, where the reference has ``jax.nn.softmax``, and
    every other dtype, on every axis, that closed form written out."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    last = axis in (-1, x.dim() - 1)
    if last and (x.dtype == torch.float32 or x.dtype in _HALF):
        if _records(x):
            return SoftmaxFn.apply(x)
        return softmax_fused(x)
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=axis)
    return softmax_plain(x, axis)


def layer_norm(x, gamma, beta, axis: int = -1, eps: float = 1e-5):
    """LayerNorm over ``axis`` (≙ ``ops/nn.py layer_norm``).  Over the
    last axis a CUDA tensor launches the LayerNorm kernel; a CPU tensor
    takes its plain version.  With autograd recording and an input that
    requires grad, the call goes through ``LayerNormFn`` (closed-form
    backward); otherwise no autograd node is made, which the decode step,
    issuing 25 of these per token, should not pay for.  Over another axis
    it is the reference's closed form: normalized over ``axis`` with fp32
    statistics, then ``· gamma + beta`` broadcast along the LAST axis, as
    the reference does (it raises where that broadcast fails).  A
    non-fp32 ``x`` takes that closed form on every axis, as in the
    reference (``ops/nn.py:482-493``): the kernel and its plain version
    are fp32 only."""
    if axis not in (-1, x.dim() - 1) or x.dtype != torch.float32:
        xf = x.float()
        mean = xf.mean(dim=axis, keepdim=True)
        var = xf.var(dim=axis, unbiased=False, keepdim=True)
        out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
        return out * gamma + beta
    if _records(x, gamma, beta):
        return LayerNormFn.apply(x, gamma, beta, eps)
    return layernorm_fused(x, gamma, beta, eps)


# bf16 and fp16 element-wise ops follow the reference's jitted
# expressions step by step: XLA on the CPU evaluates each step in fp32 and
# rounds it to the input's dtype (``_r``), except where noted.  Torch's
# own half-precision ops work in fp32 inside and round once, which moves
# results by up to hundreds of steps of the dtype where a value cancels
# (GELU of a negative input) or turns an exact 0 into a small value.
def _r(t, dtype):
    """fp32 ``t`` rounded to ``dtype`` and back: one of XLA's roundings."""
    return t.to(dtype).float()


def _gelu_half(x, approximate):
    """``jax.nn.gelu`` on bf16 or fp16 ``x`` as XLA evaluates it.  Tanh
    form: x³ as (x·x)·x, then x + 0.044715·x³ (on fp16 one fused
    multiply-add, exact in fp32 since the product of two fp16 values is),
    ·√(2/π), tanh, 1 +, ·0.5, ·x.  Erf form: ½x · erfc(−x·√½), where
    −x·√½ is rounded on fp16 and kept in fp32 on bf16."""
    dt, xf = x.dtype, x.float()
    if approximate:
        x3 = _r(_r(xf * xf, dt) * xf, dt)
        p = _const(0.044715, dt) * x3
        a = _r(xf + (p if dt == torch.float16 else _r(p, dt)), dt)
        t = _r(torch.tanh(_r(_const(math.sqrt(2 / math.pi), dt) * a, dt)),
               dt)
        return (xf * _r(0.5 * _r(1.0 + t, dt), dt)).to(dt)
    a = -xf * _const(math.sqrt(0.5), dt)
    if dt == torch.float16:
        a = _r(a, dt)
    return (_r(0.5 * xf, dt) * _r(torch.special.erfc(a), dt)).to(dt)


def gelu(x, approximate: bool = True):
    """≙ ``ops/nn.py gelu`` (``jax.nn.gelu``): the tanh approximation by
    default, as GPT and the functional BERT call it; ``approximate=False``
    is the exact erf form, which Gluon's ``GELU`` block defaults to (the
    two differ by ~4e-4).  bf16 and fp16 follow the reference's roundings
    (``_gelu_half``)."""
    if x.dtype in _HALF:
        return _gelu_half(x, approximate)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _sigmoid(x):
    """``jax.nn.sigmoid``: on bf16 and fp16 XLA's 1 / (1 + exp(−x)), each
    step rounded."""
    if x.dtype not in _HALF:
        return torch.sigmoid(x)
    dt = x.dtype
    u = _r(1.0 + _r(torch.exp(-x.float()), dt), dt)
    return (1.0 / u).to(dt)


# XLA's log1p on fp16 (its elemental emitter, from the Cephes library):
# log(1 + x) with 1 + x rounded, or for |x| < √2 − 1 the rational form
# x − x²/2 + x³·P(x)/Q(x), every step in fp16; LLVM fuses each Horner
# step p·x + c into one multiply-add (exact in fp32 for fp16 operands).
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_f16(x):
    """log1p of fp32 ``x`` holding fp16 values, as XLA computes it on
    fp16, returned in fp32 (fp16 values)."""
    dt = torch.float16

    def horner(cs):
        p = torch.zeros_like(x)
        for c in cs:
            p = _r(p * x + _const(c, dt), dt)
        return p

    x2 = _r(x * x, dt)
    small = _r(horner(_LOG1P_P) / horner(_LOG1P_Q), dt)
    small = _r(_r(x * x2, dt) * small, dt)
    small = _r(x + _r(-0.5 * x2 + small, dt), dt)
    large = _r(torch.log(_r(x + 1.0, dt)), dt)
    return torch.where(x.abs() < _const(math.sqrt(2) - 1, dt), small, large)


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): on bf16 and fp16
    max(x, 0) + log1p(exp(−|x|)), each step rounded (fp16's log1p is
    XLA's own, ``_log1p_f16``); NaN stays NaN."""
    if x.dtype not in _HALF:
        return F.softplus(x)
    dt, xf = x.dtype, x.float()
    e = _r(torch.exp(-xf.abs()), dt)
    l = _log1p_f16(e) if dt == torch.float16 else _r(torch.log1p(e), dt)
    out = (torch.clamp(xf, min=0.0) + l).to(dt)
    return torch.where(torch.isnan(x), x, out)


def silu(x):
    """``jax.nn.silu``: x · sigmoid(x); on bf16 and fp16 the sigmoid's
    steps and the product each rounded."""
    if x.dtype not in _HALF:
        return F.silu(x)
    return x * _sigmoid(x)


swish = silu


def mish(x):
    """≙ ``ops/nn.py mish``: x · tanh(softplus(x)), each step in the
    input's dtype."""
    return x * torch.tanh(_softplus(x))


def _weak(v, x):
    """The Python float ``v`` as JAX applies it to ``x``: a weakly typed
    constant, rounded to ``x``'s dtype first where that is bf16 or
    fp16."""
    return _const(v, x.dtype) if x.dtype in _HALF else v


def leaky_relu(x, slope=0.01):
    """≙ ``ops/nn.py leaky_relu``: x where x ≥ 0, else slope · x."""
    return torch.where(x >= 0, x, _weak(slope, x) * x)


def elu(x, alpha=1.0):
    """≙ ``ops/nn.py elu``: x where x > 0, else alpha · expm1(x)."""
    return torch.where(x > 0, x, _weak(alpha, x) * torch.expm1(x))


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def selu(x):
    """``jax.nn.selu``: scale · elu(x, alpha) with the SELU constants."""
    return _weak(_SELU_SCALE, x) * elu(x, _SELU_ALPHA)


def prelu(x, alpha):
    """≙ ``ops/nn.py prelu``: x where x ≥ 0, else alpha · x (``alpha``
    broadcast along the last axis, the channels)."""
    return torch.where(x >= 0, x, alpha * x)


def hard_sigmoid(x, alpha=0.2, beta=0.5):
    """≙ ``ops/nn.py hard_sigmoid``: clip(alpha · x + beta, 0, 1); on fp16
    alpha · x + beta is one fused multiply-add rounded once, as XLA
    evaluates it (exact in fp32)."""
    a, b = _weak(alpha, x), _weak(beta, x)
    if x.dtype == torch.float16:
        return torch.clamp((a * x.float() + b).to(x.dtype), 0.0, 1.0)
    return torch.clamp(a * x + b, 0.0, 1.0)


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: −softplus(−x)."""
    return -_softplus(-x)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": _sigmoid,
    "tanh": torch.tanh,
    "softrelu": _softplus,
    "softplus": _softplus,
    "softsign": F.softsign,
    "gelu": gelu,
    "silu": silu,
    "swish": swish,
    "mish": mish,
    "elu": elu,
    "selu": selu,
    "leaky": leaky_relu,
    "log_sigmoid": log_sigmoid,
}


def activation(x, act_type: str = "relu"):
    """≙ ``npx.activation`` for the reference's element-wise activations
    (``gelu`` is the tanh form, ``leaky`` has slope 0.01, ``elu`` alpha
    1, as the reference's table gives them)."""
    try:
        return _ACTIVATIONS[act_type](x)
    except KeyError:
        raise ValueError(f"unknown act_type {act_type!r}; have "
                         f"{sorted(_ACTIVATIONS)}") from None


def _pair(v, n=2):
    return (v,) * n if isinstance(v, int) else tuple(v)


def fully_connected(x, weight, bias=None, flatten: bool = True):
    """≙ FullyConnected: ``x·weightᵀ + bias`` with weight (out, in);
    ``flatten`` folds every axis after the first into one.  On bf16 and
    fp16, as the reference: the product summed in fp32 and rounded to the
    dtype, then the bias added in the dtype (``F.linear`` would add it
    before its one rounding)."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    if x.dtype in _HALF and bias is not None:
        return F.linear(x, weight) + bias
    return F.linear(x, weight, bias)


def _nchw(x):
    """NCHW view of an NHWC tensor (channels-last memory)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def convolution(x, weight, bias=None, stride=1, pad=0, dilate=1,
                groups: int = 1, layout: str = "NHWC"):
    """2-D convolution ≙ Convolution, NHWC × HWIO.  A conv that
    ``pallas_conv.eligible`` takes (3×3, stride 1, pad 1, no dilation, one
    group, fp32, bf16 or fp16, the weight in x's dtype) is
    ``pallas_conv.conv3x3_s1``, with the bias added after,
    as the reference routes it: the conv3x3 / conv_wgrad kernels on the
    card, their plain versions on the CPU.  Any other is one ``F.conv2d``
    on the channels-last view (cuDNN on the card); the result is
    NHWC-contiguous when the backend keeps channels last (cuDNN does).
    ``layout="NCHW"`` transposes the activation to NHWC and back, as the
    reference does; the weight stays HWIO.  On bf16 and fp16 the bias is
    added in the dtype after the conv's one rounding, as the reference
    adds it.  An fp16 conv on the CPU is the fp32 conv of the widened
    operands rounded once, forward and backward, as XLA computes one (and
    cuDNN on the card): torch's own CPU fp16 conv rounds inside its sums,
    on some builds hundreds of fp16 steps off in a stem's weight
    gradient.  The JAX package's space-to-depth stem rewrite is a TPU
    layout trick computing the same conv and is not carried over."""
    if layout == "NCHW":
        return _nchw(convolution(_nhwc(x), weight, bias, stride, pad,
                                 dilate, groups))
    if layout != "NHWC":
        raise ValueError(f"layout {layout!r}: NHWC or NCHW")
    if weight.dtype == x.dtype and pallas_conv.eligible(
            x.shape, weight.shape, stride, pad, dilate, groups, x.dtype):
        out = pallas_conv.conv3x3_s1(x, weight)
        return out if bias is None else out + bias
    if x.dtype in _HALF and bias is not None:
        return convolution(x, weight, None, stride, pad, dilate,
                           groups) + bias
    dt = x.dtype
    if dt == torch.float16 and x.device.type == "cpu":
        x, weight = x.float(), weight.float()
    return _nhwc(F.conv2d(_nchw(x), weight.permute(3, 2, 0, 1), bias,
                          _pair(stride), _pair(pad), _pair(dilate),
                          groups)).to(dt)


def _transpose_weight(weight, groups):
    """HWIO ``(kh, kw, in/groups, out)`` → ``F.conv_transpose2d``'s
    ``(in, out/groups, kh, kw)``, group by group."""
    kh, kw, cin_g, cout = weight.shape
    w = weight.reshape(kh, kw, cin_g, groups, cout // groups)
    return w.permute(3, 2, 4, 0, 1).reshape(groups * cin_g, cout // groups,
                                            kh, kw)


def conv_transpose(x, weight, bias=None, stride=1, pad=0, dilate=1,
                   output_padding=0, groups: int = 1, layout: str = "NHWC"):
    """2-D transposed conv ≙ ``ops/nn.py conv_transpose`` (Deconvolution):
    the reference's lhs-dilated direct conv with the spatially flipped
    HWIO weight is ``F.conv_transpose2d`` with the unflipped weight read
    as ``(in, out/groups, kh, kw)``: no in/out swap of the channel
    mixing.  ``layout="NCHW"`` transposes as ``convolution`` does."""
    if layout == "NCHW":
        return _nchw(conv_transpose(_nhwc(x), weight, bias, stride, pad,
                                    dilate, output_padding, groups))
    if layout != "NHWC":
        raise ValueError(f"layout {layout!r}: NHWC or NCHW")
    return _nhwc(F.conv_transpose2d(
        _nchw(x), _transpose_weight(weight, groups), bias, _pair(stride),
        _pair(pad), _pair(output_padding), groups, _pair(dilate)))


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _cfirst(x):
    """(N, ..., C) → (N, C, ...)."""
    return x.movedim(-1, 1)


def _clast(x):
    return x.movedim(1, -1)


def convolution_nd(x, weight, bias=None, stride=1, pad=0, dilate=1,
                   groups: int = 1, ndims: int = 3):
    """N-d convolution ≙ ``ops/nn.py convolution_nd``: channels-last
    ``(N, ..., C)`` × ``(..., in/groups, out)``, one ``F.conv{1,2,3}d``
    on the channels-first view."""
    w = weight.movedim(-1, 0).movedim(-1, 1)
    return _clast(_CONV[ndims](_cfirst(x), w, bias, _pair(stride, ndims),
                               _pair(pad, ndims), _pair(dilate, ndims),
                               groups))


def _pool_cf(x, kernel, stride, pad, pool_type, count_include_pad):
    """Pooling of channels-first ``x`` with 2 or 3 spatial dims:
    ``max`` (−inf padding), ``avg`` (divided by the whole window, or by
    its real count without ``count_include_pad``), ``sum`` and ``lp``
    (√Σx², the reference's)."""
    nd = x.dim() - 2
    if pool_type == "max":
        return (F.max_pool2d if nd == 2 else F.max_pool3d)(
            x, kernel, stride, pad)
    avg = F.avg_pool2d if nd == 2 else F.avg_pool3d
    if pool_type == "avg":
        return avg(x, kernel, stride, pad,
                   count_include_pad=count_include_pad)
    if pool_type == "sum":
        return avg(x, kernel, stride, pad, divisor_override=1)
    if pool_type == "lp":
        return torch.sqrt(avg(x * x, kernel, stride, pad,
                              divisor_override=1))
    raise ValueError(f"unknown pool_type {pool_type!r}")


def pooling(x, kernel=2, stride=None, pad=0, pool_type: str = "max",
            global_pool: bool = False, count_include_pad: bool = True,
            layout: str = "NHWC"):
    """≙ Pooling (``ops/nn.py pooling``) over NHWC: ``max``, ``avg``,
    ``sum`` or ``lp`` windows, or with ``global_pool`` the whole H×W
    plane (``keepdim``).  ``layout="NCHW"`` transposes to NHWC and
    back."""
    if layout == "NCHW":
        return _nchw(pooling(_nhwc(x), kernel, stride, pad, pool_type,
                             global_pool, count_include_pad))
    if layout != "NHWC":
        raise ValueError(f"layout {layout!r}: NHWC or NCHW")
    if global_pool:
        if pool_type == "max":
            return x.amax(dim=(1, 2), keepdim=True)
        if pool_type == "avg":
            return x.mean(dim=(1, 2), keepdim=True)
        if pool_type == "sum":
            return x.sum(dim=(1, 2), keepdim=True)
        if pool_type == "lp":
            return torch.sqrt((x * x).sum(dim=(1, 2), keepdim=True))
        raise ValueError(f"unknown pool_type {pool_type!r}")
    kernel = _pair(kernel)
    stride = _pair(stride if stride is not None else kernel)
    return _nhwc(_pool_cf(_nchw(x), kernel, stride, _pair(pad), pool_type,
                          count_include_pad))


def pooling_nd(x, kernel, stride=None, pad=0, pool_type: str = "max",
               global_pool: bool = False, count_include_pad: bool = True,
               ndims: int = 3):
    """N-d pooling (channels-last) ≙ ``ops/nn.py pooling_nd``: ``max``,
    ``sum``, and every other type the average, as in the reference.  A
    1-d input pools as a 2-d one of height 1."""
    if global_pool:
        kernel, stride, pad = x.shape[1:1 + ndims], (1,) * ndims, 0
    kernel = _pair(kernel, ndims)
    stride = _pair(stride if stride is not None else kernel, ndims)
    pad = _pair(pad, ndims)
    if pool_type not in ("max", "sum"):
        pool_type = "avg"
    xc = _cfirst(x)
    if ndims == 1:
        out = _pool_cf(xc.unsqueeze(2), (1,) + kernel, (1,) + stride,
                       (0,) + pad, pool_type, count_include_pad).squeeze(2)
    else:
        out = _pool_cf(xc, kernel, stride, pad, pool_type,
                       count_include_pad)
    return _clast(out)


def reflection_pad2d(x, pad):
    """≙ ReflectionPad2D: NHWC ``x`` padded by reflection, ``pad`` rows
    and columns on each side (an int or an (h, w) pair)."""
    ph, pw = _pair(pad)
    return _nhwc(F.pad(_nchw(x), (pw, pw, ph, ph), mode="reflect"))


def _bn_stats(x, ch):
    """≙ ``_bn_stats``: per-channel ``(mean, E[x²])`` of ``x`` over every
    axis but ``ch``, summed in fp32 from the widened values."""
    rax = tuple(i for i in range(x.dim()) if i != ch)
    n = x.numel() // x.shape[ch]
    xf = x.float()
    return xf.sum(dim=rax) / n, (xf * xf).sum(dim=rax) / n


class _BNTrain(torch.autograd.Function):
    """≙ the reference's ``_bn_train`` custom VJP: training BatchNorm of a
    low-precision ``x`` (bf16, fp16), its saved tensors ``(x, γ, μ, 1/σ)``
    in their own dtypes.  Forward (``_bn_train_fwd``): μ and
    ``σ² = max(E[x²] − μ², 0)`` in fp32, ``inv = rsqrt(σ² + ε)``, then
    ``(x − μ)·inv·γ + β`` with μ and inv cast to x's dtype, each op
    rounded in the dtype of its operands (an fp32 γ or β promotes, as in
    the reference).  Backward (``_bn_train_bwd``): ``x̂ = (x − μ)·inv`` in
    x's dtype; Σdy and Σdy·x̂ in fp32 over the widened operands;
    ``dγ`` in γ's dtype, ``dβ`` in dy's; ``dx = (γ·inv)·(dy − Σdy/n −
    x̂·Σdy·x̂/n)`` with ``γ·inv`` (fp32) and the two means cast to dy's
    dtype, each op rounded there.  Returns ``(out, μ, σ²)``, the batch
    statistics fp32 and not differentiated (they feed the running
    averages only)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, ch):
        mean, m2 = _bn_stats(x, ch)
        var = torch.clamp(m2 - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        shape = [1] * x.dim()
        shape[ch] = x.shape[ch]
        out = ((x - mean.reshape(shape).to(x.dtype))
               * inv.reshape(shape).to(x.dtype)
               * gamma.reshape(shape) + beta.reshape(shape))
        ctx.ch = ch
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, *stat_cotangents):
        x, gamma, mean, inv = ctx.saved_tensors
        ch = ctx.ch
        rax = tuple(i for i in range(x.dim()) if i != ch)
        n = x.numel() // x.shape[ch]
        shape = [1] * x.dim()
        shape[ch] = x.shape[ch]
        xhat = ((x - mean.reshape(shape).to(x.dtype))
                * inv.reshape(shape).to(x.dtype))
        dyf = dy.float()
        sum_dy = dyf.sum(dim=rax)
        sum_dy_xhat = (dyf * xhat.float()).sum(dim=rax)
        dt = dy.dtype
        scale = gamma.float() * inv
        dx = (scale.reshape(shape).to(dt)
              * (dy - (sum_dy / n).reshape(shape).to(dt)
                 - xhat * (sum_dy_xhat / n).reshape(shape).to(dt)))
        return (dx.to(x.dtype), sum_dy_xhat.to(gamma.dtype), sum_dy.to(dt),
                None, None)


def batch_norm(x, gamma, beta, running_mean, running_var, momentum=0.9,
               eps: float = 1e-5, use_global_stats: bool = False,
               training: bool = True, axis: int = -1):
    """≙ BatchNorm over channel ``axis``; returns ``(out, new_mean,
    new_var)``.  ``training`` defaults to True, as the reference's does.

    Training (and not ``use_global_stats``), fp32: batch statistics from
    one-pass *shifted* sums (the first element of each channel is
    subtracted first, so ``E[x²] − E[x]²`` does not cancel when
    ``|mean| ≫ std``), the biased batch variance, and running averages
    under MXNet's convention ``new = momentum·running +
    (1 − momentum)·batch`` (detached: they are state, not outputs to
    differentiate).  The gradient flows through the batch statistics by
    autograd, as the reference's fp32 branch leaves it to JAX's AD.
    ``F.batch_norm`` is not used here: its momentum is ``1 − momentum``
    and it stores the unbiased variance.  Below fp32 (bf16, fp16) it is
    the reference's ``_bn_train`` (:class:`_BNTrain`): the statistics and
    the running averages in fp32, the normalization and its backward in
    x's dtype.

    Otherwise: normalization by the running statistics, which come back
    unchanged.  On bf16 and fp16 ``x`` that is the reference's expression
    in the dtype, each step rounded: ``(x − μ)·inv·γ + β`` with μ cast to
    the dtype and ``inv = rsqrt(σ² + ε)`` cast to it (ε rounded to σ²'s
    dtype first, as JAX's weak constant is); γ, β or the statistics kept
    in fp32 promote the result as they do in the reference."""
    ch = axis % x.dim()
    if training and not use_global_stats:
        if x.dtype not in (torch.float32, torch.float64):
            out, mean, var = _BNTrain.apply(x, gamma, beta, float(eps), ch)
            new_mean = momentum * running_mean + (1 - momentum) * mean
            new_var = momentum * running_var + (1 - momentum) * var
            return out, new_mean, new_var
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
    if x.dtype in _HALF:
        shape = [1] * x.dim()
        shape[ch] = x.shape[ch]
        var = running_var.reshape(shape)
        inv = torch.rsqrt(var + (_const(eps, var.dtype)
                                 if var.dtype in _HALF else eps))
        out = ((x - running_mean.reshape(shape).to(x.dtype))
               * inv.to(x.dtype) * gamma.reshape(shape)
               + beta.reshape(shape))
        return out, running_mean, running_var
    xc = x.movedim(ch, 1) if ch != 1 else x
    out = F.batch_norm(xc, running_mean, running_var, gamma, beta,
                       training=False, eps=eps)
    out = out.movedim(1, ch) if ch != 1 else out
    return out, running_mean, running_var


def residual_block(x, weight, gamma, beta, running_mean, running_var,
                   residual=None, momentum=0.9, eps: float = 1e-5,
                   use_global_stats: bool = False, training: bool = True,
                   relu: bool = True):
    """Fused 3×3/s1 SAME conv + BatchNorm (+ residual add) (+ ReLU),
    NHWC/HWIO → ``(out, new_mean, new_var)`` with ``batch_norm``'s
    running-statistics contract (and its default, ``training=True``).
    Every call goes to ``ops/conv_block``: its kernels on the card, their
    plain versions on the CPU; under ``amp.init`` (``convolution``
    patched) it is the reference's layer route, conv then
    ``batch_norm``, add and ReLU, as there.

    Training: ``residual_block_fused`` (conv + batch statistics, then the
    affine pass; its backward runs dgrad and wgrad).  Frozen
    (``use_global_stats`` or inference) with autograd recording: the same
    Function's frozen branch.  Frozen without gradients: ``conv_affine``
    alone, with no autograd node.  bf16 and fp16 take the kernels' half
    instances on every route (the BatchNorm vectors in x's dtype or, as
    a half step keeps its running statistics, fp32).  ``x``, ``weight`` and
    ``residual`` are made contiguous here (a no-op on the path, where the
    producing cuDNN and element-wise calls keep NHWC contiguous), since
    the kernels take contiguous NHWC only."""
    if hasattr(convolution, "__wrapped__"):
        # amp.init patched the conv: the reference's layer route, whose
        # conv then runs in the target dtype
        z = convolution(x, weight, None, stride=1, pad=1)
        out, new_mean, new_var = batch_norm(
            z, gamma, beta, running_mean, running_var, momentum=momentum,
            eps=eps, use_global_stats=use_global_stats, training=training)
        if residual is not None:
            out = out + residual
        return (torch.relu(out) if relu else out), new_mean, new_var
    x = x.contiguous()
    weight = weight.contiguous()
    if residual is not None:
        residual = residual.contiguous()
    frozen = use_global_stats or not training
    recording = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, weight, gamma, beta, residual))
    if frozen and not recording:
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


def rms_norm(x, gamma, axis: int = -1, eps: float = 1e-6):
    """≙ ``ops/nn.py rms_norm``: x / √(mean(x²) + eps) in fp32, cast back,
    times gamma."""
    xf = x.float()
    ms = (xf * xf).mean(dim=axis, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * gamma


def instance_norm(x, gamma, beta, eps: float = 1e-5, axis: int = -1):
    """≙ ``ops/nn.py instance_norm``: each sample's channel normalized
    over the spatial axes (biased variance), then the channel's gamma
    and beta."""
    ch = axis % x.dim()
    rax = tuple(i for i in range(1, x.dim()) if i != ch)
    mean = x.mean(dim=rax, keepdim=True)
    var = x.var(dim=rax, unbiased=False, keepdim=True)
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    return ((x - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape)
            + beta.reshape(shape))


def group_norm(x, gamma, beta, num_groups: int, eps: float = 1e-5):
    """≙ ``ops/nn.py group_norm`` (channels last): the channels split into
    ``num_groups`` groups, each normalized over the spatial axes and its
    channels, then gamma and beta along the last axis."""
    c = x.shape[-1]
    xg = x.reshape(*x.shape[:-1], num_groups, c // num_groups)
    rax = tuple(range(1, x.dim() - 1)) + (x.dim(),)
    mean = xg.mean(dim=rax, keepdim=True)
    var = xg.var(dim=rax, unbiased=False, keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return xg.reshape(x.shape) * gamma + beta


def l2_normalize(x, axis: int = -1, eps: float = 1e-10):
    """≙ ``ops/nn.py l2_normalize``: x / √(Σx² + eps) along ``axis``."""
    return x * torch.rsqrt((x * x).sum(dim=axis, keepdim=True) + eps)


def log_softmax(x, axis: int = -1):
    """≙ ``ops/nn.py log_softmax`` (``jax.nn.log_softmax``).  bf16 and
    fp16 follow XLA's roundings: ``d = x − max`` rounded, ``exp(d)`` kept
    in fp32 on bf16 and rounded on fp16, summed in fp32, the sum rounded,
    its log rounded, then ``d − log`` rounded."""
    if x.dtype not in _HALF:
        return F.log_softmax(x, dim=axis)
    dt, xf = x.dtype, x.float()
    d = _r(xf - xf.amax(dim=axis, keepdim=True), dt)
    e = torch.exp(d)
    if dt == torch.float16:
        e = _r(e, dt)
    s = _r(e.sum(dim=axis, keepdim=True), dt)
    return (d - _r(torch.log(s), dt)).to(dt)


def _keep(mask, x):
    """``mask`` as a bool tensor on ``x``'s device (nonzero = keep, as
    ``jnp.where`` reads a mask)."""
    m = torch.as_tensor(mask, device=x.device)
    return m if m.dtype == torch.bool else m != 0


def masked_softmax(x, mask, axis: int = -1, temperature=1.0):
    """≙ ``ops/nn.py masked_softmax`` (``src/operator/nn/masked_softmax``;
    ``mask`` true = keep, broadcast as ``jnp.where`` broadcasts it):
    ``x`` divided by ``temperature`` when it is not 1, the masked entries
    set to the dtype's most negative finite value, the softmax over
    ``axis``, then the masked outputs zeroed: a fully masked row gives
    zeros.  Plain torch, as the reference's is ``jax.nn.softmax`` and not
    its routed softmax kernel; bf16 and fp16 round as
    ``cuda_kernels.softmax_plain`` (the reference's jitted closed
    form)."""
    keep = _keep(mask, x)
    if temperature != 1.0:
        x = x / temperature
    x = torch.where(keep, x, torch.finfo(x.dtype).min)
    if x.dtype in _HALF:
        out = softmax_plain(x, axis)
    else:
        out = torch.softmax(x, dim=axis)
    return torch.where(keep, out, 0.0)


def masked_log_softmax(x, mask, axis: int = -1):
    """≙ ``ops/nn.py masked_log_softmax``: the masked entries set to the
    dtype's most negative finite value, then :func:`log_softmax`; the
    masked outputs are not zeroed, as in the reference, so a fully
    masked row gives ``-log(n)`` everywhere."""
    x = torch.where(_keep(mask, x), x, torch.finfo(x.dtype).min)
    return log_softmax(x, axis=axis)


def pick(x, index, axis: int = -1, keepdims: bool = False):
    """≙ pick (``jnp.take_along_axis`` in fill mode): the element of ``x``
    along ``axis`` at ``index`` for every other position.  An index in
    [-n, 0) reads entry n + index; one outside [-n, n) gives NaN with a
    zero gradient, on the CPU and on the card alike (the index is clamped
    before the gather, so no device assert)."""
    n = x.shape[axis]
    idx = index.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = ((idx >= 0) & (idx < n)).unsqueeze(axis)
    out = torch.gather(x, axis, torch.where(ok, idx.unsqueeze(axis), 0))
    out = torch.where(ok, out, float("nan"))
    return out if keepdims else out.squeeze(axis)


def softmax_cross_entropy(logits, labels, sparse: bool = True,
                          axis: int = -1):
    """≙ SoftmaxCrossEntropy: ``−log_softmax(logits)`` at the label (or
    summed against dense label distributions)."""
    logp = log_softmax(logits, axis=axis)
    if sparse:
        return -pick(logp, labels, axis=axis)
    return -(labels * logp).sum(dim=axis)


def sigmoid_binary_cross_entropy(logits, labels, from_sigmoid=False):
    """≙ ``ops/nn.py sigmoid_binary_cross_entropy``: on probabilities
    (``from_sigmoid``) ``−(z·log(p + ε) + (1 − z)·log(1 − p + ε))`` with
    ε = 1e-12; on logits the stable ``max(x, 0) − x·z + log1p(exp(−|x|))``."""
    if from_sigmoid:
        eps = 1e-12
        return -(labels * torch.log(logits + eps)
                 + (1 - labels) * torch.log(1 - logits + eps))
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def embedding(indices, weight):
    """≙ Embedding (``jnp.take`` in fill mode): the rows of ``weight`` at
    integer ``indices`` (any shape; int32 or int64).  An id in [-n, 0)
    reads row n + id; an id outside [-n, n) gives a row of NaN, on the
    CPU and on the card alike (no device assert)."""
    n = weight.shape[0]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    rows = F.embedding(torch.where(ok, idx, 0), weight)
    return torch.where(ok.unsqueeze(-1), rows, float("nan"))


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


# ------------------------------------------------------------ int8 ops
def _quantize_sym(x, in_t):
    """Symmetric per-tensor int8 quantization of an activation against a
    calibrated threshold (≙ ``ops/nn.py _quantize_sym``): scale ``127/T``
    (a Python float, as in the reference), round half to even, clip to
    ±127 → ``(qx, s_in)``."""
    s_in = 127.0 / max(float(in_t), 1e-12)
    qx = torch.round(x.float() * s_in).clamp_(-127, 127).to(torch.int8)
    return qx, s_in


def quantized_dense(x, qw, w_scale, bias=None, *, in_t, flatten=True,
                    act=None, qw_packed=None):
    """int8 fully-connected (≙ ``ops/nn.py quantized_dense``): ``x``
    quantized against ``in_t``, times the int8 weight ``qw`` (in, units)
    summed exactly in int32, then ``/ (s_in·w_scale) + bias`` and the
    activation.  ``qw_packed`` is ``qwᵀ`` contiguous (units, in), the
    form :func:`cuda_int8.int8_matmul` takes (made here when not
    given)."""
    qx, s_in = _quantize_sym(x, in_t)
    if flatten and qx.dim() > 2:
        qx = qx.reshape(qx.shape[0], -1)
    wt = qw_packed if qw_packed is not None else qw.t().contiguous()
    lead = qx.shape[:-1]
    acc = cuda_int8.int8_matmul(qx.reshape(-1, qx.shape[-1]), wt)
    out = acc.reshape(*lead, wt.shape[0]).float() / (s_in * w_scale.float())
    if bias is not None:
        out = out + bias.float()
    if act is not None:
        out = activation(out, act)
    return out


def quantized_conv(x, qw, w_scale, bias=None, residual=None, *, in_t,
                   stride=(1, 1), pad=(1, 1), dilate=(1, 1), groups=1,
                   relu=False, act=None, qw_packed=None):
    """int8 conv, NHWC activation × pre-quantized HWIO int8 weight, with
    the dequantization ``1/(s_in·w_scale)`` + ``bias`` (+ ``residual``)
    (+ ReLU) epilogue (≙ ``ops/nn.py quantized_conv``).  A 3×3/s1/p1
    single-group conv goes to ``cuda_int8.qconv3x3_affine`` (the kernel on
    the card, its plain version on the CPU); every other geometry (the
    1×1 convs, strided as a strided slice, the 7×7/s2 stem as im2col) is
    the int8 patch matrix times the weight through
    ``cuda_int8.int8_matmul`` and the same epilogue in plain PyTorch.
    ``qw_packed`` is :func:`cuda_int8.pack_weight` of ``qw`` (made here
    when not given).  ``bias`` is the per-channel shift: after BatchNorm
    folding it is the folded BN."""
    qx, s_in = _quantize_sym(x, in_t)
    cout = qw.shape[-1]
    dq = 1.0 / (s_in * w_scale.float())
    shift = bias.float() if bias is not None else \
        torch.zeros(cout, device=x.device)
    fuse_relu = bool(relu) or act == "relu"
    stride, pad, dilate = _pair(stride), _pair(pad), _pair(dilate)
    if residual is not None:
        residual = residual.float().contiguous()
    if (stride == (1, 1) and pad == (1, 1) and dilate == (1, 1)
            and groups == 1 and tuple(qw.shape[:2]) == (3, 3)):
        out = cuda_int8.qconv3x3_affine(qx.contiguous(), qw, dq, shift,
                                        res=residual, relu=fuse_relu,
                                        qw_packed=qw_packed)
    else:
        wt = qw_packed if qw_packed is not None else \
            cuda_int8.pack_weight(qw)
        kh, kw, cg = qw.shape[:3]
        cog = cout // groups
        accs = []
        for g in range(groups):
            xg = qx if groups == 1 else qx[..., g * cg:(g + 1) * cg]
            p = cuda_int8.im2col(xg, (kh, kw), stride, pad, dilate)
            accs.append(cuda_int8.int8_matmul(
                p.reshape(-1, p.shape[-1]),
                wt[g * cog:(g + 1) * cog]).reshape(*p.shape[:3], cog))
        acc = accs[0] if groups == 1 else torch.cat(accs, dim=-1)
        out = acc.float() * dq + shift
        if residual is not None:
            out = out + residual
        if fuse_relu:
            out = torch.relu(out)
    if act is not None and act != "relu":
        out = activation(out, act)
    return out


# ------------------------------------------------------------ the tail
def one_hot(indices, depth: int, on_value=1.0, off_value=0.0,
            dtype=torch.float32):
    """≙ ``ops/nn.py one_hot`` (``jax.nn.one_hot``): a row of zeros for an
    index outside [0, depth); ``on_value`` / ``off_value`` as
    ``oh · (on − off) + off``."""
    oh = (indices.long().unsqueeze(-1) == torch.arange(
        depth, device=indices.device)).to(dtype)
    if on_value != 1.0 or off_value != 0.0:
        oh = oh * (on_value - off_value) + off_value
    return oh


def topk(x, k: int = 1, axis: int = -1, ret_typ: str = "indices",
         is_ascend: bool = False):
    """≙ ``ops/nn.py topk``: the ``k`` largest (smallest with
    ``is_ascend``) along ``axis``, sorted; int32 indices.  ``ret_typ``
    ``"indices"``, ``"value"``, or anything else for (values, indices)."""
    vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend,
                           sorted=True)
    idx = idx.to(torch.int32)
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    return vals, idx


def sequence_mask(x, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis: int = 0):
    """≙ SequenceMask: positions at or past each sequence's length along
    the time ``axis`` (batch on axis 1 when time is 0, else 0) set to
    ``value``."""
    if not use_sequence_length or sequence_length is None:
        return x
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    pos = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    lens_shape = [1] * x.dim()
    batch = 1 if axis == 0 else 0
    lens_shape[batch] = x.shape[batch]
    keep = pos < sequence_length.reshape(lens_shape)
    return torch.where(keep, x, torch.as_tensor(value, dtype=x.dtype,
                                                device=x.device))


def sequence_last(x, sequence_length=None, use_sequence_length=False,
                  axis: int = 0):
    """≙ SequenceLast: each sequence's last valid step along ``axis``."""
    if not use_sequence_length or sequence_length is None:
        return x.select(axis, x.shape[axis] - 1)
    xm = x.movedim(axis, 0)
    idx = (sequence_length.long() - 1).reshape(
        (1, -1) + (1,) * (xm.dim() - 2)).expand(1, *xm.shape[1:])
    return torch.gather(xm, 0, idx)[0]


def sequence_reverse(x, sequence_length=None, use_sequence_length=False,
                     axis: int = 0):
    """≙ SequenceReverse: each sequence's valid steps reversed along
    ``axis``, the padding after them left in place."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(x, dims=(axis,))
    xm = x.movedim(axis, 0)
    T = xm.shape[0]
    pos = torch.arange(T, device=x.device)[:, None]
    lens = sequence_length.long()[None, :]
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    src = src.reshape(src.shape + (1,) * (xm.dim() - 2)).expand(xm.shape)
    return torch.gather(xm, 0, src).movedim(0, axis)


def clip_global_norm(arrays, max_norm):
    """≙ ``ops/nn.py clip_global_norm``: every array scaled by
    min(1, max_norm / (‖all‖₂ + 1e-12)), the norm summed in fp32 →
    (scaled arrays, the norm)."""
    total = torch.sqrt(sum((a.float() ** 2).sum() for a in arrays))
    scale = torch.clamp(max_norm / (total + 1e-12), max=1.0)
    return [a * scale.to(a.dtype) for a in arrays], total
