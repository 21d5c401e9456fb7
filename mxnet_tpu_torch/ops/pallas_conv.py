"""The standalone 3×3/s1 convolution (≙ ``mxnet_tpu/ops/pallas_conv.py``):
a lone conv, with no BatchNorm fused into it, trained through the
hand-written kernels of ``ops/conv_block``.

``conv3x3_s1(x, w)`` is the reference's custom-VJP op as an autograd
Function: the forward is ``conv_block.conv3x3``, the backward
``conv_block.conv3x3_dgrad`` for dx and ``conv_block.conv_wgrad`` for
dW, on the card the kernels of ``csrc/conv3x3_tc.cu`` and
``csrc/conv_wgrad.cu`` and on the CPU their plain versions.
``ops.nn.convolution`` sends a conv here when :func:`eligible` takes its
geometry and dtype (ResNet v2's stride-1 bottleneck convs, a user's
``Conv2D(k, 3, padding=1)``).  The reference's VMEM budget and per-stage
decision table are budgets of the TPU and are not carried over: the
route is chosen by geometry and dtype alone, and a kernel that fails
raises.
"""
from __future__ import annotations

import torch

from . import conv_block

__all__ = ["eligible", "Conv3x3Fn", "conv3x3_s1"]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def eligible(x_shape, w_shape, stride, pad, dilate, groups,
             dtype=torch.float32) -> bool:
    """The geometry ``conv_block.conv3x3`` computes: an NHWC activation
    and an HWIO 3×3 weight over all of its channels, stride 1, pad 1, no
    dilation, one group, fp32."""
    return (dtype == torch.float32 and groups == 1
            and len(x_shape) == 4 and len(w_shape) == 4
            and tuple(w_shape[:3]) == (3, 3, x_shape[-1])
            and _pair(stride) == (1, 1) and _pair(pad) == (1, 1)
            and _pair(dilate) == (1, 1))


class Conv3x3Fn(torch.autograd.Function):
    """≙ ``pallas_conv.conv3x3_s1`` with ``_conv_fwd_rule`` /
    ``_conv_bwd_rule``: x and w are saved; dx is the conv of dy with the
    rotated weight, dW the patchesᵀ·dy reduction, each cast to its
    input's dtype.  Every operand is made contiguous NHWC / HWIO before
    a launch (a pre-activation output or an incoming gradient may be
    another layout)."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return conv_block.conv3x3(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv_block.conv3x3_dgrad(w, dy).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv_block.conv_wgrad(x, dy).to(w.dtype)
        return dx, dw


def conv3x3_s1(x, w):
    """3×3 stride-1 pad-1 conv of NHWC ``x`` with HWIO ``w`` through
    :class:`Conv3x3Fn` (the kernels on the card, their plain versions on
    the CPU)."""
    return Conv3x3Fn.apply(x, w)
