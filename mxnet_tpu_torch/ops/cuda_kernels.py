"""Row softmax and LayerNorm forward: the hand-written CUDA kernels and
their plain versions.

≙ the softmax and layernorm sections of ``mxnet_tpu/ops/pallas_kernels.py``
(``_softmax_kernel``, ``_softmax_pallas``, ``softmax_fused``;
``_layernorm_kernel``, ``_layernorm_pallas``, ``layernorm_fused``).  The
kernels live in ``csrc/softmax.cu`` (fp32, bf16 and fp16 instances) and
``csrc/layernorm.cu`` (fp32); see the note at the top of each for its
bound and design.

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

__all__ = ["softmax_fused", "softmax_plain", "softmax_prologue_plain",
           "softmax_bwd", "SoftmaxFn",
           "layernorm_fused", "layernorm_plain", "layernorm_bwd",
           "LayerNormFn"]

_count_mu = threading.Lock()
_MASKED = -1e9      # the model's finite mask value


_HALF = (torch.bfloat16, torch.float16)
# the C entry of the softmax kernel for each dtype it takes
_SOFTMAX_ENTRY = {torch.float32: "mxt_softmax_f32",
                  torch.bfloat16: "mxt_softmax_bf16",
                  torch.float16: "mxt_softmax_f16"}


def _as_dtype(v, dtype):
    """The Python float ``v`` as the reference's weak constant of
    ``dtype``: rounded to it, returned as a Python float."""
    return torch.tensor(float(v), dtype=torch.float64).to(dtype).item()


def softmax_plain(x, axis: int = -1):
    """Plain PyTorch softmax over ``axis`` (the last by default) with the
    kernel's arithmetic: ``exp(x - max) / sum(exp(x - max))``.  On bf16
    and fp16 it is the reference's jitted ``jax.nn.softmax`` as XLA on the
    CPU rounds it: ``d = x - max`` in the dtype; for bf16 ``exp(d)`` kept
    in fp32, its fp32 sum rounded, and ``exp(d)`` rounded before the
    divide; for fp16 ``exp(d)`` rounded first and summed from the rounded
    values; each quotient rounded."""
    d = x - x.amax(dim=axis, keepdim=True)
    if x.dtype == torch.bfloat16:
        e = torch.exp(d.float())
        return e.to(x.dtype) / e.sum(dim=axis, keepdim=True).to(x.dtype)
    e = torch.exp(d)
    return e / e.sum(dim=axis, keepdim=True)


def _keep_per(x, keep):
    """Rows of ``x`` that share one row of ``keep``: ``keep`` is bool or
    uint8 with ``x``'s last dim, on ``x``'s device, and its rows divide
    ``x``'s rows into equal runs of consecutive rows (a ``(B, T)`` key
    mask of ``(B, H, T, T)`` scores: ``H * T`` rows a mask row)."""
    if keep.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"softmax_fused: keep must be bool or uint8, got "
                        f"{keep.dtype}")
    if keep.device != x.device:
        raise ValueError(f"softmax_fused: keep is on {keep.device}, x on "
                         f"{x.device}")
    cols = x.shape[-1] if x.dim() else 0
    m = keep.numel() // cols if cols and keep.dim() and \
        keep.shape[-1] == cols else 0
    rows = x.numel() // cols if cols else 0
    if m == 0 or rows % m:
        raise ValueError(f"softmax_fused: keep {tuple(keep.shape)} does not "
                         f"divide the rows of x {tuple(x.shape)}")
    return rows // m


def softmax_prologue_plain(x, div=None, keep=None):
    """The kernel's prologue in plain PyTorch: ``where(keep, x / div,
    -1e9)``, ``keep``'s rows broadcast over their runs of ``x``'s rows
    (no division without ``div``, no mask without ``keep``).  On bf16 and
    fp16 the quotient and -1e9 are rounded to the dtype (-1e9 is -inf in
    fp16), as the reference's weakly typed constants are."""
    if div is not None:
        if x.dtype in _HALF:
            # the reference's x / div in the dtype: div rounded to it
            # first (on the host: nothing is copied to the card, so a
            # CUDA graph can capture it), an IEEE division of the two,
            # rounded
            x = (x.float() / _as_dtype(div, x.dtype)).to(x.dtype)
        else:
            x = x / div
    if keep is not None:
        cols = x.shape[-1]
        m = keep.numel() // cols
        x = torch.where(keep.reshape(m, 1, cols) != 0,
                        x.reshape(m, -1, cols),
                        _as_dtype(_MASKED, x.dtype) if x.dtype in _HALF
                        else _MASKED).reshape(x.shape)
    return x


def softmax_fused(x, *, div=None, keep=None):
    """Softmax over the last axis of fp32, bf16 or fp16 ``x`` (any
    leading shape, any last dim), of ``where(keep, x / div, -1e9)`` when
    a divisor or a keep mask is given (the attention's scale and key mask;
    the division is IEEE).  ``keep`` is bool or uint8 with ``x``'s last
    dim, and its rows divide ``x``'s rows into equal runs of consecutive
    rows that share one mask row (``(B, T)`` for ``(B, H, T, T)``
    scores).  CUDA tensors launch ``csrc/softmax.cu`` with the prologue
    folded into the kernel's load (the half instances round where the
    reference rounds: :func:`softmax_plain`); any other dtype raises
    ``TypeError``.  CPU tensors take :func:`softmax_plain` of the same
    prologue in plain PyTorch.  A non-contiguous CUDA input is copied to
    a contiguous one first (the kernel reads rows of a contiguous
    ``(rows, cols)`` view); the output is a new contiguous tensor.
    ``launches`` counts every launch, ``launches_by_dtype`` each dtype's
    (keyed by the torch dtype)."""
    per = 1 if keep is None else _keep_per(x, keep)
    if x.device.type == "cpu":
        return softmax_plain(softmax_prologue_plain(x, div, keep))
    if x.device.type != "cuda":
        raise ValueError(f"softmax_fused: no kernel for device {x.device}")
    entry = _SOFTMAX_ENTRY.get(x.dtype)
    if entry is None:
        raise TypeError(f"softmax_fused: x must be float32, bfloat16 or "
                        f"float16, got {x.dtype}")
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
    prologue = div is not None or keep is not None
    kptr = 0
    if keep is not None:
        keep = keep.contiguous()
        if keep.dtype == torch.bool:
            keep = keep.view(torch.uint8)
        kptr = keep.data_ptr()
    # values a load moves: 16 bytes (4 floats, 8 halves) where the width
    # and every base allow
    wide = 4 if x.dtype == torch.float32 else 8
    vec = wide if (cols % wide == 0 and x.data_ptr() % 16 == 0 and
                   y.data_ptr() % 16 == 0 and kptr % wide == 0) else 1
    dv = 1.0 if div is None else float(div)
    if x.dtype in _HALF:
        dv = _as_dtype(dv, x.dtype)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(x.data_ptr(), y.data_ptr(), rows, cols,
                                  vec, int(prologue), dv, kptr or None, per,
                                  stream)
    _build.check(err, "softmax_fused")
    with _count_mu:
        softmax_fused.launches += 1
        softmax_fused.launches_by_dtype[x.dtype] += 1
    return y


softmax_fused.launches = 0
softmax_fused.launches_by_dtype = dict.fromkeys(_SOFTMAX_ENTRY, 0)


def softmax_bwd(y, g):
    """Gradient of the last-axis softmax at output ``y`` for upstream
    ``g``: the closed form of ``pallas_kernels._softmax_bwd``,
    ``(g - sum(g * y)) * y``."""
    return (g - (g * y).sum(dim=-1, keepdim=True)) * y


class SoftmaxFn(torch.autograd.Function):
    """Softmax with the kernel forward (≙ ``softmax_fused``'s custom VJP):
    saves the output, and the backward is :func:`softmax_bwd`, in the
    output's dtype (fp32, bf16 or fp16)."""

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
