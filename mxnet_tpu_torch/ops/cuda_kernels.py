"""LayerNorm forward: the hand-written CUDA kernel and its plain version.

≙ ``mxnet_tpu/ops/pallas_kernels.py`` layernorm (``_layernorm_kernel``,
``_layernorm_pallas``, ``layernorm_fused``).  The kernel lives in
``csrc/layernorm.cu``; see the note at its top for its bound and design.

``layernorm_fused`` launches the kernel for a CUDA tensor and raises on
anything the kernel does not take; a CPU tensor takes
``layernorm_plain``.  There is no other route.  ``LayerNormFn`` makes it
differentiable: its forward is ``layernorm_fused`` and its backward the
closed form of ``_ln_bwd`` in plain PyTorch, as the JAX package has no
backward kernel for LayerNorm.
"""
from __future__ import annotations

import threading

import torch

from .. import _build

__all__ = ["layernorm_fused", "layernorm_plain", "layernorm_bwd",
           "LayerNormFn"]

_MAX_C = 4096
_count_mu = threading.Lock()


def layernorm_plain(x, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch LayerNorm over the last axis with the kernel's
    arithmetic: mean, centred variance, ``(x-mu)*rsqrt(var+eps)*g+b``."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * gamma + beta


def layernorm_fused(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis of fp32 ``x`` (any leading shape,
    last dim ``C`` <= 4096), gamma/beta ``(C,)``.  CUDA tensors launch
    ``csrc/layernorm.cu``; CPU tensors take :func:`layernorm_plain`."""
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
    if not 1 <= C <= _MAX_C:
        raise ValueError(f"layernorm_fused: last dim {C} not in "
                         f"[1, {_MAX_C}]")
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
