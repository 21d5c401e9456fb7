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

import math

import torch
import torch.nn.functional as F

from . import conv_block, cuda_int8
from .cuda_kernels import (LayerNormFn, SoftmaxFn, layernorm_fused,
                           softmax_fused)

__all__ = ["softmax", "layer_norm", "gelu", "activation", "fully_connected",
           "convolution", "pooling", "batch_norm", "residual_block",
           "log_softmax", "pick", "softmax_cross_entropy", "embedding",
           "dropout", "quantized_dense", "quantized_conv"]


def _records(*ts):
    """Autograd would record a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def softmax(x, axis: int = -1, temperature=None):
    """≙ ``ops/nn.py softmax`` (``npx.softmax``): ``x`` is divided by
    ``temperature`` first when one other than 1 is given.  For fp32 ``x``
    over the last axis a CUDA tensor launches the softmax kernel and a CPU
    tensor takes its plain version, through ``SoftmaxFn`` (closed-form
    backward) only when autograd records, as ``layer_norm`` does; over any
    other axis it is ``torch.softmax``, where the reference has
    ``jax.nn.softmax``.  A non-fp32 ``x`` takes the reference's jitted
    ``jax.nn.softmax`` written out on every axis (the kernel and its plain
    version are fp32 only), rounded where XLA on the CPU rounds it:
    ``d = x - max`` in the dtype; for bf16, which XLA carries in fp32
    between its roundings, ``exp(d)`` stays fp32, its sum is taken in fp32
    and rounded, and ``exp(d)`` is rounded before the divide; for other
    dtypes ``exp(d)`` is rounded first and summed from the rounded values."""
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if x.dtype == torch.float32:
        if axis not in (-1, x.dim() - 1):
            return torch.softmax(x, dim=axis)
        if _records(x):
            return SoftmaxFn.apply(x)
        return softmax_fused(x)
    d = x - x.amax(dim=axis, keepdim=True)
    if x.dtype == torch.bfloat16:
        e = torch.exp(d.float())
        return e.to(x.dtype) / e.sum(dim=axis, keepdim=True).to(x.dtype)
    e = torch.exp(d)
    return e / e.sum(dim=axis, keepdim=True)


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
_HALF = (torch.bfloat16, torch.float16)


def _r(t, dtype):
    """fp32 ``t`` rounded to ``dtype`` and back: one of XLA's roundings."""
    return t.to(dtype).float()


def _const(v, dtype):
    """The Python float ``v`` as the reference's constant of ``dtype``."""
    return torch.tensor(v, dtype=torch.float64).to(dtype).item()


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


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": _sigmoid,
    "tanh": torch.tanh,
    "softrelu": _softplus,
    "softplus": _softplus,
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
                   use_global_stats: bool = False, training: bool = True,
                   relu: bool = True):
    """Fused 3×3/s1 SAME conv + BatchNorm (+ residual add) (+ ReLU),
    NHWC/HWIO → ``(out, new_mean, new_var)`` with ``batch_norm``'s
    running-statistics contract (and its default, ``training=True``).
    Every call goes to ``ops/conv_block``: its kernels on the card, their
    plain versions on the CPU.

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
