"""Fused 3×3/s1 conv + folded frozen BatchNorm (+ residual add) (+ ReLU):
the hand-written CUDA kernel and its plain version.

≙ the frozen-stats forward of ``mxnet_tpu/ops/pallas_block.py``
(``_conv_affine_kernel``, ``_conv_affine``, ``_fold`` and the frozen
branch of ``_fused_fwd``).  The kernel lives in ``csrc/conv_affine.cu``;
see the note at its top for its bound and design.

``conv_affine`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; CPU tensors take
``conv_affine_plain``.  There is no other route: the TPU package's VMEM
gate (``eligible_block``) and its per-stage A/B table are budgets of
the TPU, and on the card every 3×3/s1 frozen segment goes to the kernel.
Layouts are the JAX package's: activations NHWC, the weight HWIO
``(3, 3, C, Cout)``, both contiguous (the caller makes them so).
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["conv_affine", "conv_affine_plain", "fold"]

_count_mu = threading.Lock()


def fold(gamma, beta, mean, var, eps: float = 1e-5):
    """Frozen BN as a per-channel affine, in f32 as ``_fold`` computes it:
    ``scale = γ·rsqrt(σ²+ε)``, ``shift = β − μ·scale``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def conv_affine_plain(x, w, gamma, beta, mean, var, residual=None,
                      eps: float = 1e-5, relu: bool = True):
    """Plain PyTorch version of the kernel: 3×3/s1/p1 conv of NHWC ``x``
    with HWIO ``w``, then ``·scale + shift``, ``+ residual``, ReLU."""
    scale, shift = fold(gamma, beta, mean, var, eps)
    z = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    y = z * scale + shift
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _check(x, w, vecs, residual):
    """Refuse what the kernel does not take; → (N, H, W, C, Cout)."""
    if x.dim() != 4:
        raise ValueError(f"conv_affine: x must be NHWC, got {tuple(x.shape)}")
    N, H, W, C = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"conv_affine: w must be (3, 3, {C}, Cout) HWIO, "
                         f"got {tuple(w.shape)}")
    Cout = w.shape[3]
    named = [("x", x), ("w", w)] + list(vecs)
    if residual is not None:
        if tuple(residual.shape) != (N, H, W, Cout):
            raise ValueError(f"conv_affine: residual must be "
                             f"{(N, H, W, Cout)}, got "
                             f"{tuple(residual.shape)}")
        named.append(("residual", residual))
    for name, t in vecs:
        if tuple(t.shape) != (Cout,):
            raise ValueError(f"conv_affine: {name} must be ({Cout},), got "
                             f"{tuple(t.shape)}")
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"conv_affine: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"conv_affine: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"conv_affine: {name} must be contiguous "
                             f"({'NHWC' if t.dim() == 4 else 'dense'})")
    return N, H, W, C, Cout


def conv_affine(x, w, gamma, beta, mean, var, residual=None,
                eps: float = 1e-5, relu: bool = True):
    """``act(conv3x3(x, w)·scale + shift (+ residual))`` with the BN
    statistics folded as :func:`fold` does.  ``x`` (N, H, W, C) and
    ``residual`` (N, H, W, Cout) contiguous NHWC fp32, ``w`` contiguous
    HWIO (3, 3, C, Cout), the four BN vectors (Cout,).  CUDA tensors
    launch ``csrc/conv_affine.cu``; CPU tensors take
    :func:`conv_affine_plain`."""
    if x.device.type == "cpu":
        return conv_affine_plain(x, w, gamma, beta, mean, var, residual,
                                 eps, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv_affine: no kernel for device {x.device}")
    vecs = (("gamma", gamma), ("beta", beta), ("mean", mean), ("var", var))
    N, H, W, C, Cout = _check(x, w, vecs, residual)
    out = torch.empty((N, H, W, Cout), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    ptrs = [t.data_ptr() for t in (x, w, out) +
            ((residual,) if residual is not None else ())]
    vec = int(C % 16 == 0 and Cout % 4 == 0 and
              all(p % 16 == 0 for p in ptrs))
    lib = _build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mxt_conv_affine_f32(
            x.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), var.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), N, H, W, C, Cout, float(eps), int(bool(relu)),
            vec, stream)
    _build.check(err, "conv_affine")
    with _count_mu:
        conv_affine.launches += 1
    return out


conv_affine.launches = 0
