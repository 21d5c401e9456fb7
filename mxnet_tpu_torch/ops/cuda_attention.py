"""Causal attention forward: the hand-written CUDA kernel and its plain
version.

≙ ``mxnet_tpu/ops/pallas_attention.py`` (``_causal_attn_kernel``,
``_causal_attention_pallas``, ``causal_attention_xla``,
``causal_attention``).  The kernel's entry is ``csrc/causal_attention.cu``
and its body, shared with the non-causal forward, is
``csrc/flash_fwd_tc.cuh``; see the notes at their tops for its bound and
design.

``causal_attention`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; CPU tensors take
``causal_attention_plain``.  The TPU package's route table, env switch
and eligibility gate have no counterpart here: on the card the kernel
takes any L (ragged edges are masked in the kernel) and head dims 64 and
128.  Forward only: decoding never differentiates.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import _build

__all__ = ["causal_attention", "causal_attention_plain"]

# finite mask value: exp(-1e30 - m) underflows to exactly 0; a true -inf
# would turn a fully masked row into nan
_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_count_mu = threading.Lock()


def causal_attention_plain(q, k, v, scale):
    """Causal-masked f32 einsum softmax for (B, H, L, D) tensors — the
    plain version and parity reference (≙ ``causal_attention_xla``).
    Key column j is visible to query row i iff j <= i (top-left)."""
    Lq, Lk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    rows = torch.arange(Lq, device=q.device)[:, None]
    cols = torch.arange(Lk, device=q.device)[None, :]
    s = torch.where(cols <= rows, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(),
                        v.float()).to(q.dtype)


def _strides(t):
    b, h, l_, _ = t.stride()
    return (ctypes.c_longlong * 3)(b, h, l_)


def causal_attention(q, k, v, scale=None):
    """Causal softmax(Q Kᵀ·scale) V for (B, H, L, D) fp32 tensors.

    CUDA tensors launch ``csrc/causal_attention.cu``.  Each of q/k/v may
    be a strided view (any batch/head/row strides, unit last-dim stride,
    rows 16-byte aligned), so a caller can pass views into a fused qkv
    projection.  The output is a (B, H, Lq, D) view of a (B, Lq, H, D)
    buffer, so ``out.transpose(1, 2)`` is contiguous.  CPU tensors take
    :func:`causal_attention_plain`."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("causal_attention: q, k, v must be (B, H, L, D)")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if tuple(k.shape) != (B, H, Lk, D) or tuple(v.shape) != (B, H, Lk, D):
        raise ValueError(f"causal_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"causal_attention: head dim {D} not in "
                         f"{_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"causal_attention: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"causal_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError(f"causal_attention: {name} needs a contiguous "
                             "last dim and 16-byte aligned rows, got "
                             f"strides {t.stride()}")
    out = torch.empty((B, Lq, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B * H == 0 or Lq == 0:
        return out
    if Lk == 0:
        raise ValueError("causal_attention: no keys (Lk == 0)")
    lib = _build.lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxt_causal_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Lq, Lk, D, _strides(q), _strides(k), _strides(v), _strides(out),
            float(scale), stream)
    _build.check(err, "causal_attention")
    with _count_mu:
        causal_attention.launches += 1
    return out


causal_attention.launches = 0
