"""int8 3×3/s1 implicit GEMM with a fused dequantization epilogue: the
hand-written CUDA kernel and its plain version (≙
``mxnet_tpu/ops/pallas_int8.py``: ``_qconv_affine_kernel``,
``qconv3x3_affine``, ``qconv3x3_xla``), plus the exact int8 products the
plain versions and the other quantized convs and dense layers use.

- ``qconv3x3_affine`` launches ``csrc/qconv_affine.cu`` for CUDA tensors
  and raises on anything the kernel does not take; CPU tensors take
  :func:`qconv3x3_plain`.  There is no other route: the TPU package's
  VMEM gate (``eligible_int8``), its per-stage table and its
  ``MXNET_TPU_PALLAS_INT8`` switch are budgets of the TPU, and on the
  card every quantized 3×3/s1 conv goes to the kernel.
- ``int8_matmul`` is the int8 × int8 → int32 product of the plain
  routes: ``torch._int_mm`` (cuBLASLt on the card, where the operands are
  zero-padded to the shapes it takes; exact on the CPU).  The reference
  leaves these products to XLA outside any Pallas kernel.

Layouts are the JAX package's: activations NHWC, weights HWIO.  The
kernel takes the weight packed once as the ``(Cout, kh·kw·C)`` matrix
(:func:`pack_weight`, which ``QuantizedConv2D`` keeps beside its HWIO
copy), so its K-contiguous rows load straight into the tensor cores'
fragments.  See the note at the top of the ``.cu`` file for its bound
and design.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["qconv3x3_affine", "qconv3x3_plain", "pack_weight", "im2col",
           "int8_matmul"]

_count_mu = threading.Lock()


def pack_weight(qw):
    """HWIO int8 ``(kh, kw, C, Cout)`` → the contiguous ``(Cout,
    kh·kw·C)`` matrix, K tap-major as the HWIO weight reads."""
    kh, kw, c, cout = qw.shape
    return qw.reshape(kh * kw * c, cout).t().contiguous()


def im2col(qx, kernel, stride=(1, 1), pad=(0, 0), dilate=(1, 1)):
    """The patch tensor ``(N, Ho, Wo, kh·kw·C)`` of NHWC ``qx``, taps in
    row-major order, channels inside each tap (the order of
    :func:`pack_weight`'s K); zero padding, which is exact for symmetric
    int8."""
    kh, kw = kernel
    (sh, sw), (ph, pw), (dh, dw) = stride, pad, dilate
    N, H, W, C = qx.shape
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if (kh, kw) == (1, 1) and (ph, pw) == (0, 0):
        return qx[:, ::sh, ::sw, :][:, :Ho, :Wo]
    xp = F.pad(qx, (0, 0, pw, pw, ph, ph)) if ph or pw else qx
    taps = [xp[:, i * dh:i * dh + (Ho - 1) * sh + 1:sh,
               j * dw:j * dw + (Wo - 1) * sw + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(taps, dim=-1)


def int8_matmul(a, wt):
    """``a (M, K) · wtᵀ`` for int8 ``a`` and ``wt (N, K)`` → int32 ``(M,
    N)``, exact.  On the card ``torch._int_mm`` takes more than 16 rows
    and K and N multiples of 8, so the operands are zero-padded to that
    (exact) and the result cut back."""
    M, K = a.shape
    N = wt.shape[0]
    if a.device.type == "cuda":
        Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
        if (Mp, Kp) != (M, K):
            a = F.pad(a, (0, Kp - K, 0, Mp - M))
        if (Np, Kp) != (N, K):
            wt = F.pad(wt, (0, Kp - K, 0, Np - N))
        out = torch._int_mm(a.contiguous(), wt.contiguous().t())
        return out[:M, :N] if (Mp, Np) != (M, N) else out
    return torch._int_mm(a.contiguous(), wt.t())


def qconv3x3_plain(qx, qw, scale, shift, res=None, relu: bool = True,
                   qw_packed=None):
    """Plain PyTorch version of the kernel (≙ ``qconv3x3_xla``): the int8
    patch matrix times the weight, summed exactly in int32, then
    ``f32(acc)·scale + shift (+ res)`` (two rounded operations, no FMA)
    and ReLU."""
    N, H, W, C = qx.shape
    cout = qw.shape[-1]
    wt = qw_packed if qw_packed is not None else pack_weight(qw)
    acc = int8_matmul(im2col(qx, (3, 3), pad=(1, 1)).reshape(-1, 9 * C),
                      wt).reshape(N, H, W, cout)
    y = acc.float() * scale + shift
    if res is not None:
        y = y + res
    return torch.relu(y) if relu else y


def _check(qx, qw, scale, shift, res, wt):
    if qx.dim() != 4:
        raise ValueError(f"qconv3x3_affine: qx must be NHWC, got "
                         f"{tuple(qx.shape)}")
    N, H, W, C = qx.shape
    if qw.dim() != 4 or tuple(qw.shape[:3]) != (3, 3, C):
        raise ValueError(f"qconv3x3_affine: qw must be (3, 3, {C}, Cout) "
                         f"HWIO, got {tuple(qw.shape)}")
    cout = qw.shape[3]
    named = [("qx", qx, torch.int8, (N, H, W, C)),
             ("qw_packed", wt, torch.int8, (cout, 9 * C)),
             ("scale", scale, torch.float32, (cout,)),
             ("shift", shift, torch.float32, (cout,))]
    if res is not None:
        named.append(("res", res, torch.float32, (N, H, W, cout)))
    for name, t, dt, shape in named:
        if t.device != qx.device:
            raise ValueError(f"qconv3x3_affine: {name} is on {t.device}, "
                             f"qx on {qx.device}")
        if t.dtype != dt:
            raise TypeError(f"qconv3x3_affine: {name} must be {dt}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"qconv3x3_affine: {name} must be {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"qconv3x3_affine: {name} must be contiguous")
    return N, H, W, C, cout


def qconv3x3_affine(qx, qw, scale, shift, res=None, relu: bool = True,
                    qw_packed=None):
    """``act(f32(conv3x3(qx, qw))·scale + shift (+ res))``, 3×3/s1 SAME,
    f32 out (≙ ``pallas_int8.qconv3x3_affine``).  ``qx`` (N, H, W, C)
    int8 NHWC (symmetric, zero-point 0), ``qw`` (3, 3, C, Cout) int8 HWIO
    and optionally its :func:`pack_weight` form ``qw_packed`` (packed here
    when not given), ``scale``/``shift`` (Cout,) f32, ``res`` (N, H, W,
    Cout) f32; all contiguous.  CUDA tensors launch
    ``csrc/qconv_affine.cu``; CPU tensors take :func:`qconv3x3_plain`."""
    if qx.device.type == "cpu":
        return qconv3x3_plain(qx, qw, scale, shift, res, relu, qw_packed)
    if qx.device.type != "cuda":
        raise ValueError(f"qconv3x3_affine: no kernel for device "
                         f"{qx.device}")
    wt = qw_packed if qw_packed is not None else pack_weight(qw)
    N, H, W, C, cout = _check(qx, qw, scale, shift, res, wt)
    out = torch.empty((N, H, W, cout), device=qx.device,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    vec = int(C % 16 == 0 and cout % 2 == 0 and all(
        t.data_ptr() % 16 == 0
        for t in (qx, wt, out) + ((res,) if res is not None else ())))
    lib = _build.lib()
    with torch.cuda.device(qx.device):
        err = lib.mxt_qconv_affine_s8(
            qx.data_ptr(), wt.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), res.data_ptr() if res is not None else None,
            out.data_ptr(), N, H, W, C, cout, int(bool(relu)), vec,
            torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "qconv3x3_affine")
    with _count_mu:
        qconv3x3_affine.launches += 1
    return out


qconv3x3_affine.launches = 0
