"""Gluon layers of the image-serving slice (≙ the subset of
``mxnet_tpu/gluon/nn/__init__.py`` the ResNet zoo uses).

The reference's conventions hold: NHWC activations, HWIO conv weights,
dense weights ``(units, in_units)``, BatchNorm over the last axis with
running statistics as buffers.  Inference only: a BatchNorm in training
mode (batch statistics and their running average) raises, naming the
ResNet-training slice that brings it.
"""
from __future__ import annotations

import math

from ... import initializer as init
from ...ops import nn as _nn
from ..block import Block, HybridBlock, HybridSequential, Sequential

__all__ = ["Dense", "Flatten", "Activation", "Conv2D", "MaxPool2D",
           "GlobalAvgPool2D", "BatchNorm",
           "Sequential", "HybridSequential", "Block", "HybridBlock",
           "fused_conv_bn_relu", "fused_block_active"]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Dense(HybridBlock):
    """≙ ``gluon.nn.Dense``: weight (units, in_units), one matmul."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 weight_initializer=None, bias_initializer="zero",
                 in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self.act = activation
        self._param("weight", (units, in_units), weight_initializer)
        if use_bias:
            self._param("bias", (units,), init.create(bias_initializer
                                                      or "zero"))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._finish("weight", (self._units, in_units), x.device)
        if self.bias is not None:
            self._finish("bias", (self._units,), x.device)
        out = _nn.fully_connected(x, self.weight, self.bias,
                                  flatten=self._flatten)
        return _nn.activation(out, self.act) if self.act else out


class Flatten(HybridBlock):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act = activation

    def forward(self, x):
        return _nn.activation(x, self._act)


class _ConvBase(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels, activation, use_bias,
                 weight_initializer, bias_initializer, ndims, **kwargs):
        super().__init__(**kwargs)
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * ndims
        self._channels = channels
        self._kernel = tuple(kernel_size)
        self._strides = strides
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._layout = layout
        self.act = activation
        # HWIO weight (the JAX package's layout; the reference's MXNet
        # stores OIHW for cuDNN)
        self._param("weight", self._kernel + (in_channels // groups,
                                              channels),
                    weight_initializer or init.Xavier())
        if use_bias:
            self._param("bias", (channels,),
                        init.create(bias_initializer or "zero"))
        else:
            self.register_parameter("bias", None)

    def _infer(self, x):
        self._finish("weight", self._kernel + (x.shape[-1] // self._groups,
                                               self._channels), x.device)
        if self.bias is not None:
            self._finish("bias", (self._channels,), x.device)


class Conv2D(_ConvBase):
    """≙ ``gluon.nn.Conv2D``: ``ops.nn.convolution`` (cuDNN on the card)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NHWC", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zero", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, 2, **kwargs)

    def forward(self, x):
        self._infer(x)
        out = _nn.convolution(x, self.weight, self.bias,
                              stride=self._strides, pad=self._padding,
                              dilate=self._dilation, groups=self._groups,
                              layout=self._layout)
        return _nn.activation(out, self.act) if self.act else out


class _Pool(HybridBlock):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NHWC",
                 count_include_pad=True, pool_type="max", global_pool=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._kw = dict(kernel=pool_size, stride=strides, pad=padding,
                        pool_type=pool_type, global_pool=global_pool,
                        count_include_pad=count_include_pad, layout=layout)

    def forward(self, x):
        return _nn.pooling(x, **self._kw)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NHWC",
                 **kwargs):
        super().__init__(pool_size, strides, padding, layout,
                         pool_type="max", **kwargs)


class GlobalAvgPool2D(_Pool):
    def __init__(self, layout="NHWC", **kwargs):
        super().__init__(layout=layout, pool_type="avg", global_pool=True,
                         **kwargs)


class BatchNorm(HybridBlock):
    """≙ ``gluon.nn.BatchNorm`` over ``axis`` (default -1, NHWC), with
    frozen statistics: gamma/beta are parameters, running_mean/var
    buffers.  Training mode raises ``NotImplementedError``."""

    def __init__(self, axis=-1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._use_global_stats = use_global_stats
        sh = (in_channels,)
        self._param("gamma", sh, init.One(), differentiable=scale)
        self._param("beta", sh, init.Zero(), differentiable=center)
        self._aux("running_mean", sh, init.Zero())
        self._aux("running_var", sh, init.One())

    def _infer(self, c, device):
        for name in ("gamma", "beta", "running_mean", "running_var"):
            self._finish(name, (c,), device)

    def forward(self, x):
        self._infer(x.shape[self._axis], x.device)
        out, _, _ = _nn.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            momentum=self._momentum, eps=self._eps,
            use_global_stats=self._use_global_stats, training=self.training,
            axis=self._axis)
        return out


def fused_block_active() -> bool:
    """True: the port's ResNet blocks always take the fused forward.
    The reference consults its TPU A/B table here; the port routes by
    device inside ``ops.conv_block.conv_affine`` instead."""
    return True


def fused_conv_bn_relu(conv: Conv2D, bn: BatchNorm, x, residual=None,
                       relu: bool = True):
    """Run a Conv2D + BatchNorm (+ residual add) (+ ReLU) segment through
    ``ops.nn.residual_block`` (the conv_affine kernel on the card) when
    it has the kernel's structure: 3×3, stride 1, pad 1, no dilation,
    groups or bias, NHWC, BN over the last axis.  Any other segment runs
    its layers one by one, which computes the same function."""
    if not (conv._kernel == (3, 3) and _pair(conv._strides) == (1, 1)
            and _pair(conv._padding) == (1, 1)
            and _pair(conv._dilation) == (1, 1) and conv._groups == 1
            and conv.bias is None and conv.act is None
            and conv._layout == "NHWC" and bn._axis in (-1, 3)):
        out = bn(conv(x))
        if residual is not None:
            out = out + residual
        return out.relu() if relu else out
    conv._infer(x)
    bn._infer(conv._channels, x.device)
    y, _, _ = _nn.residual_block(
        x, conv.weight, bn.gamma, bn.beta, bn.running_mean, bn.running_var,
        residual, momentum=bn._momentum, eps=bn._eps,
        use_global_stats=bn._use_global_stats, training=bn.training,
        relu=relu)
    return y
