"""Non-causal flash attention, forward and backward: the hand-written
CUDA kernels, their plain versions, and the differentiable
``attention_fused``.

≙ the attention section of ``mxnet_tpu/ops/pallas_kernels.py``
(``_attn_kernel``/``_attention_pallas``, ``_attn_dq_kernel`` and
``_attn_dkv_kernel``/``_attn_bwd_pallas``, ``attention_fused`` with its
custom VJP).  The forward (o and the row logsumexp) is
``csrc/flash_fwd_tc.cu``: FlashAttention-2 on the tensor cores in
3xTF32 (``mma.sync`` m16n8k8 on operands split into TF32 hi and lo, P
kept in registers), the body it shares with the causal kernel in
``csrc/flash_fwd_tc.cuh``.  The dq and dk/dv kernels are
``csrc/flash_bwd_tc.cu``, on the tensor cores in 3xTF32 too: Q and G (K
and V) resident, the other operands streamed, P and dS (Pᵀ and dSᵀ)
kept in registers as the A operand of the next product.  The note at
the top of each file gives its bound and design; :func:`bwd_plan` is
the host's view of the backward grids.

Each wrapper (``attention_fwd``, ``attention_dq``, ``attention_dkv``)
launches its kernel for CUDA tensors and raises on anything the kernel
does not take; CPU tensors take the plain version beside it.  There is
no other route: the TPU package's eligibility predicate (``D % 128``) is
a lane-tiling rule of the TPU, and on the card the kernels take head
dims 64 and 128 and any L.  Δ = rowsum(g ⊙ o) stays one plain torch
reduction in the backward, as it is outside the Pallas kernels.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from .. import _build

__all__ = ["attention_fused", "attention_fwd", "attention_dq",
           "attention_dkv", "attention_fwd_plain", "attention_dq_plain",
           "attention_dkv_plain", "bwd_plan", "BwdPlan"]

_HEAD_DIMS = (64, 128)
_BWD_ROWS = 64          # resident rows a block of the backward kernels
_count_mu = threading.Lock()


# ------------------------------------------------------ plain versions

def attention_fwd_plain(q, k, v, scale):
    """Softmax(q·scale kᵀ) v for (B, H, L, D) tensors with the row
    logsumexp — the forward kernel's arithmetic in one tile: q scaled
    before the dot, ``acc / l`` at the end → (o, lse (B, H, Lq))."""
    s = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v) / l
    return o, (m + torch.log(l))[..., 0]


def _probs(q, k, v, g, lse, delta, scale):
    # the backward kernels' recompute: s scaled AFTER the dot
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    return p, p * (dp - delta[..., None])


def attention_dq_plain(q, k, v, g, lse, delta, scale):
    """dq from the saved lse and Δ: p = exp(s·scale − lse),
    ds = p ⊙ (g·vᵀ − Δ), dq = ds·k·scale."""
    _, ds = _probs(q, k, v, g, lse, delta, scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale


def attention_dkv_plain(q, k, v, g, lse, delta, scale):
    """(dk, dv) from the saved lse and Δ: dv = pᵀ·g, dk = dsᵀ·q·scale."""
    p, ds = _probs(q, k, v, g, lse, delta, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return dk, dv


# ------------------------------------------------------------ wrappers

def _check(fn, q, k, v, more=(), rows=()):
    """Refuse what the kernels do not take; → (B, H, Lq, Lk, D).
    ``more``: (name, tensor) operands shaped like q; ``rows``: (name,
    tensor) (B, H, Lq) row statistics."""
    if any(t.dim() != 4 for t in (q, k, v)):
        raise ValueError(f"{fn}: q, k, v must be (B, H, L, D)")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if tuple(k.shape) != (B, H, Lk, D) or tuple(v.shape) != (B, H, Lk, D):
        raise ValueError(f"{fn}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {D} not in {_HEAD_DIMS}")
    for name, t, shape in [(n, t, tuple(q.shape)) for n, t in more] + \
            [(n, t, (B, H, Lq)) for n, t in rows]:
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), *more, *rows):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), *more):
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} needs a contiguous last dim and "
                             f"16-byte aligned rows, got strides "
                             f"{t.stride()}")
    for name, t in rows:
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if B * H == 0 or Lq == 0 or Lk == 0:
        raise ValueError(f"{fn}: empty operand (B·H={B * H}, Lq={Lq}, "
                         f"Lk={Lk})")
    return B, H, Lq, Lk, D


def _like_out(t):
    """An output laid out (B, L, H, D) and viewed (B, H, L, D), so that
    ``out.transpose(1, 2).reshape(B, L, H * D)`` is free."""
    B, H, L, D = t.shape
    return torch.empty((B, L, H, D), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _strides(t):
    b, h, l_, _ = t.stride()
    return (ctypes.c_longlong * 3)(b, h, l_)


def _launch(fn, entry, q, *args):
    lib = _build.lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    _build.check(err, fn.__name__)
    with _count_mu:
        fn.launches += 1


def _on_cpu(fn, q):
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {q.device}")
    return False


def attention_fwd(q, k, v, scale):
    """(o, lse) for (B, H, L, D) fp32 q/k/v: o (B, H, Lq, D), lse
    (B, H, Lq) fp32.  CUDA tensors launch the tensor-core forward of
    ``csrc/flash_fwd_tc.cu``; q/k/v may be strided views (unit last-dim
    stride, 16-byte aligned rows), and o is a (B, H, Lq, D) view of a
    (B, Lq, H, D) buffer.  CPU tensors take
    :func:`attention_fwd_plain`."""
    if _on_cpu("attention_fwd", q):
        return attention_fwd_plain(q, k, v, scale)
    B, H, Lq, Lk, D = _check("attention_fwd", q, k, v)
    o = _like_out(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    _launch(attention_fwd, "mxt_attention_fwd_f32", q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H,
            Lq, Lk, D, _strides(q), _strides(k), _strides(v), _strides(o),
            float(scale))
    return o, lse


def attention_dq(q, k, v, g, lse, delta, scale):
    """dq for upstream gradient g (shaped like q), the forward's lse and
    Δ = rowsum(g ⊙ o), both (B, H, Lq) fp32 contiguous.  CUDA tensors
    launch ``csrc/flash_bwd_tc.cu``'s dq kernel; CPU tensors take
    :func:`attention_dq_plain`."""
    if _on_cpu("attention_dq", q):
        return attention_dq_plain(q, k, v, g, lse, delta, scale)
    B, H, Lq, Lk, D = _check("attention_dq", q, k, v, more=(("g", g),),
                             rows=(("lse", lse), ("delta", delta)))
    dq = _like_out(q)
    _launch(attention_dq, "mxt_attention_dq_f32", q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B, H, Lq, Lk, D, _strides(q),
            _strides(k), _strides(v), _strides(g), _strides(dq),
            float(scale))
    return dq


def attention_dkv(q, k, v, g, lse, delta, scale):
    """(dk, dv), arguments as :func:`attention_dq`.  CUDA tensors launch
    ``csrc/flash_bwd_tc.cu``'s dk/dv kernel; CPU tensors take
    :func:`attention_dkv_plain`."""
    if _on_cpu("attention_dkv", q):
        return attention_dkv_plain(q, k, v, g, lse, delta, scale)
    B, H, Lq, Lk, D = _check("attention_dkv", q, k, v, more=(("g", g),),
                             rows=(("lse", lse), ("delta", delta)))
    dk, dv = _like_out(k), _like_out(v)
    _launch(attention_dkv, "mxt_attention_dkv_f32", q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Lq, Lk, D,
            _strides(q), _strides(k), _strides(v), _strides(g),
            _strides(dk), _strides(dv), float(scale))
    return dk, dv


attention_fwd.launches = 0
attention_dq.launches = 0
attention_dkv.launches = 0


class BwdPlan(NamedTuple):
    blocks: int         # (B·H) × ceil(rows / 64)
    per_sm: int         # blocks an SM holds (the occupancy API)
    waves: float        # blocks / (SMs × per_sm)


def bwd_plan(which, B, H, Lq, Lk, D, sms, per_sm=None):
    """The grid of the ``which`` ("dq" or "dkv") backward kernel: a block
    per 64 query (dq) or key (dk/dv) rows of each (batch, head), and the
    waves it takes on ``sms`` SMs that hold ``per_sm`` blocks each —
    asked of ``mxt_attention_{which}_blocks_per_sm`` on the current card
    when not given.  The launches never ask: their grid is fixed."""
    if which not in ("dq", "dkv"):
        raise ValueError(f"bwd_plan: which is 'dq' or 'dkv', got {which!r}")
    rows = Lq if which == "dq" else Lk
    blocks = B * H * -(-rows // _BWD_ROWS)
    if per_sm is None:
        entry = f"mxt_attention_{which}_blocks_per_sm"
        out = ctypes.c_int(0)
        _build.check(getattr(_build.lib(), entry)(D, ctypes.byref(out)),
                     entry)
        if out.value < 1:
            raise RuntimeError(f"{entry}: the D={D} kernel fits no block on "
                               f"an SM")
        per_sm = out.value
    return BwdPlan(blocks, per_sm, blocks / (sms * per_sm))


# ------------------------------------------------------------ autograd

class _Attention(torch.autograd.Function):
    """≙ ``attention_fused``'s custom VJP: the forward saves q, k, v, o
    and lse (``_attn_fwd``); the backward runs Δ, then the dq and the
    dk/dv passes (``_attn_bwd_pallas``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        if g.stride(-1) != 1 or g.data_ptr() % 16 or \
                any(s % 4 for s in g.stride()[:-1]):
            g = g.contiguous()
        delta = (g * o).sum(dim=-1).contiguous()
        dq = attention_dq(q, k, v, g, lse, delta, ctx.scale)
        dk, dv = attention_dkv(q, k, v, g, lse, delta, ctx.scale)
        return dq, dk, dv, None


def attention_fused(q, k, v, scale=None):
    """Softmax(Q Kᵀ·scale) V for (B, H, L, D) tensors, differentiable.

    With autograd recording and an input that requires grad, the call
    goes through the ``torch.autograd.Function`` (forward kernel, saved
    o and lse, dq and dk/dv kernels in the backward); otherwise it
    launches the forward kernel alone, with no autograd node."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        return _Attention.apply(q, k, v, scale)
    return attention_fwd(q, k, v, scale)[0]
