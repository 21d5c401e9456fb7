"""Row softmax and LayerNorm forward: the hand-written CUDA kernels and
their plain versions.

≙ the softmax and layernorm sections of ``mxnet_tpu/ops/pallas_kernels.py``
(``_softmax_kernel``, ``_softmax_pallas``, ``softmax_fused``;
``_layernorm_kernel``, ``_layernorm_pallas``, ``layernorm_fused``).  The
kernels live in ``csrc/softmax.cu`` and ``csrc/layernorm.cu``; see the
note at the top of each for its bound and design.

``softmax_fused`` and ``layernorm_fused`` launch their kernel for a CUDA
tensor and raise on anything it does not take; a CPU tensor takes the
plain version.  There is no other route.  ``SoftmaxFn`` and
``LayerNormFn`` make them differentiable: the forward is the kernel and
the backward the reference's closed form (``_softmax_bwd``, ``_ln_bwd``)
in plain PyTorch, as the JAX package has no backward kernel for either.
"""
from __future__ import annotations

import threading

import torch

from .. import _build

__all__ = ["softmax_fused", "softmax_plain", "softmax_bwd", "SoftmaxFn",
           "layernorm_fused", "layernorm_plain", "layernorm_bwd",
           "LayerNormFn"]

_count_mu = threading.Lock()


def softmax_plain(x):
    """Plain PyTorch softmax over the last axis with the kernel's
    arithmetic: ``exp(x - max) / sum(exp(x - max))``."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def softmax_fused(x):
    """Softmax over the last axis of fp32 ``x`` (any leading shape, any
    last dim).  CUDA tensors launch ``csrc/softmax.cu``; CPU tensors take
    :func:`softmax_plain`.  A non-contiguous CUDA input is copied to a
    contiguous one first (the kernel reads rows of a contiguous
    ``(rows, cols)`` view); the output is a new contiguous tensor."""
    if x.device.type == "cpu":
        return softmax_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"softmax_fused: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"softmax_fused: x must be float32, got {x.dtype}")
    if x.dim() == 0:
        raise ValueError("softmax_fused: x needs at least one axis")
    x = x.contiguous()
    y = torch.empty_like(x)
    cols = x.shape[-1]
    if x.numel() == 0:
        return y
    if cols >= 2 ** 31:
        raise ValueError(f"softmax_fused: last dim {cols} >= 2**31")
    rows = x.numel() // cols
    vec4 = int(cols % 4 == 0 and x.data_ptr() % 16 == 0 and
               y.data_ptr() % 16 == 0)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mxt_softmax_f32(x.data_ptr(), y.data_ptr(), rows, cols,
                                  vec4, stream)
    _build.check(err, "softmax_fused")
    with _count_mu:
        softmax_fused.launches += 1
    return y


softmax_fused.launches = 0


def softmax_bwd(y, g):
    """Gradient of the last-axis softmax at output ``y`` for upstream
    ``g``: the closed form of ``pallas_kernels._softmax_bwd``,
    ``(g - sum(g * y)) * y``."""
    return (g - (g * y).sum(dim=-1, keepdim=True)) * y


class SoftmaxFn(torch.autograd.Function):
    """Softmax with the kernel forward (≙ ``softmax_fused``'s custom VJP):
    saves the output, and the backward is :func:`softmax_bwd`."""

    @staticmethod
    def forward(ctx, x):
        y = softmax_fused(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return softmax_bwd(y, g)


def layernorm_plain(x, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch LayerNorm over the last axis with the kernel's
    arithmetic: mean, centred variance, ``(x-mu)*rsqrt(var+eps)*g+b``."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * gamma + beta


def layernorm_fused(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis of fp32 ``x`` (any leading shape,
    any last dim ``C``), gamma/beta ``(C,)``.  CUDA tensors launch
    ``csrc/layernorm.cu`` (a warp a row up to C = 4096, a block a row
    above); CPU tensors take :func:`layernorm_plain`."""
    if x.device.type == "cpu":
        return layernorm_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_fused: no kernel for device {x.device}")
    C = x.shape[-1] if x.dim() else 0
    for name, t, shape in (("gamma", gamma, (C,)), ("beta", beta, (C,))):
        if t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(f"layernorm_fused: {name} must be {shape} on "
                             f"{x.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32:
            raise TypeError(f"layernorm_fused: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"layernorm_fused: {name} must be contiguous")
    if not 1 <= C < 2 ** 31:
        raise ValueError(f"layernorm_fused: last dim {C} not in "
                         f"[1, 2**31)")
    y = torch.empty_like(x)
    rows = x.numel() // C
    if rows == 0:
        return y
    vec4 = int(C % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (x, gamma, beta, y)))
    lib = _build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mxt_layernorm_f32(x.data_ptr(), gamma.data_ptr(),
                                    beta.data_ptr(), y.data_ptr(), rows, C,
                                    float(eps), vec4, stream)
    _build.check(err, "layernorm_fused")
    with _count_mu:
        layernorm_fused.launches += 1
    return y


layernorm_fused.launches = 0


def layernorm_bwd(x, gamma, g, eps: float = 1e-5):
    """(dx, dgamma, dbeta) of LayerNorm over the last axis for upstream
    gradient ``g`` — the closed form of ``pallas_kernels._ln_bwd``, with
    the statistics recomputed from ``x``."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    gg = g * gamma
    dx = rstd * (gg - gg.mean(dim=-1, keepdim=True) -
                 xhat * (gg * xhat).mean(dim=-1, keepdim=True))
    lead = tuple(range(g.dim() - 1))
    return dx, (g * xhat).sum(dim=lead), g.sum(dim=lead)


class LayerNormFn(torch.autograd.Function):
    """LayerNorm with the kernel forward (≙ ``layernorm_fused``'s custom
    VJP): saves x and gamma, and the backward is :func:`layernorm_bwd`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return layernorm_fused(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        return (*layernorm_bwd(x, gamma, g, ctx.eps), None)
