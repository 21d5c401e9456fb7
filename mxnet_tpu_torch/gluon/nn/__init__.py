"""Gluon layers (≙ ``mxnet_tpu/gluon/nn/__init__.py``, all of its blocks
but ``SyncBatchNorm``).

The reference's conventions hold: NHWC activations, HWIO conv weights,
dense weights ``(units, in_units)``, BatchNorm over the last axis with
running statistics as buffers.  In training mode BatchNorm runs on batch
statistics and writes the new running statistics back in place, as the
reference's ``set_data`` does, and Dropout drops.  The mode
(``_training``): inside an ``autograd.record()``, ``pause()``,
``train_mode()`` or ``predict_mode()`` scope (or after
``autograd.set_training``) it is ``autograd.is_training()``, as the
reference's ``tape.is_training()``; so ``predict_mode()`` inside
``record()`` gives inference.  Outside every scope it is the block's own
``train()`` / ``eval()`` flag, so callers that use those keep their
results.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from ... import autograd
from ... import initializer as init
from ... import random as _random
from ...ops import nn as _nn
from ..block import (Block, HybridBlock, HybridSequential, Sequential,
                     _Sequence)
from ..parameter import as_dtype

__all__ = ["Dense", "Dropout", "Flatten", "Activation", "LeakyReLU", "PReLU",
           "ELU", "SELU", "GELU", "Swish", "SiLU", "Conv1D", "Conv2D",
           "Conv2DTranspose", "Conv3D", "Conv1DTranspose", "MaxPool1D",
           "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D", "GlobalAvgPool2D",
           "MaxPool3D", "AvgPool3D", "AvgPool1D", "GlobalMaxPool1D",
           "GlobalAvgPool1D", "GlobalMaxPool3D", "GlobalAvgPool3D",
           "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm",
           "Embedding", "Lambda", "HybridLambda", "Identity",
           "ReflectionPad2D", "HybridConcatenate", "Concatenate",
           "Sequential", "HybridSequential", "Block", "HybridBlock",
           "fused_conv_bn_relu", "fused_block_active"]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _training(block):
    """``block``'s mode: the ``autograd`` scope's where one set it on this
    thread, else the block's own ``training`` flag."""
    scoped = autograd.training_scope()
    return block.training if scoped is None else scoped


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


class Dropout(HybridBlock):
    """≙ ``gluon.nn.Dropout``: the identity in inference mode; in training
    mode (``_training``) ``ops.nn.dropout`` at ``rate``, drawing from
    ``generator=`` when one is given, else from the ``mx.random``
    generator of the input's device, which ``mx.seed`` seeds.  ``axes``
    is taken and not used: the reference drops element by element
    whatever it says, and so does this block (the mask is not shared
    along ``axes`` in either)."""

    def __init__(self, rate, axes=(), generator=None, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._generator = generator

    def forward(self, x):
        if not _training(self) or self._rate == 0.0:
            return x
        return _nn.dropout(x, self._rate, self.generator(x.device),
                           training=True)

    def generator(self, device):
        """The generator a training forward on ``device`` draws from."""
        if self._generator is not None:
            return self._generator
        return _random._gen(torch.device(device))


class Flatten(HybridBlock):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act = activation

    def forward(self, x):
        return _nn.activation(x, self._act)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return _nn.leaky_relu(x, self._alpha)


class PReLU(HybridBlock):
    """≙ ``gluon.nn.PReLU``: a learned slope ``alpha`` of ``in_channels``
    entries (Constant 0.25), broadcast along the last axis."""

    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        self._param("alpha", (in_channels,),
                    alpha_initializer or init.Constant(0.25))

    def forward(self, x):
        self._finish("alpha", self._specs["alpha"].shape, x.device)
        return _nn.prelu(x, self.alpha)


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return _nn.elu(x, self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return _nn.selu(x)


class Swish(HybridBlock):
    def forward(self, x):
        return _nn.silu(x)


SiLU = Swish


class GELU(HybridBlock):
    """≙ ``gluon.nn.GELU``: ``approximation="erf"`` (the default) is the
    exact form, anything else the tanh approximation."""

    def __init__(self, approximation="erf", **kwargs):
        super().__init__(**kwargs)
        self._approx = approximation != "erf"

    def forward(self, x):
        return _nn.gelu(x, approximate=self._approx)


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

    def _infer(self, x, lead=()):
        c_in = x.shape[-1] if self._layout.endswith("C") else x.shape[1]
        self._finish("weight", lead + self._kernel + (
            c_in // self._groups, self._channels), x.device)
        if self.bias is not None:
            self._finish("bias", (self._channels,), x.device)

    def _act(self, out):
        return _nn.activation(out, self.act) if self.act else out


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
        return self._act(out)


def _first(v):
    return v if isinstance(v, int) else v[0]


class Conv1D(_ConvBase):
    """≙ ``gluon.nn.Conv1D`` (NWC): a 2-D conv of height 1, its weight
    ``(1, k, in/groups, out)`` as the reference's."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NWC", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zero", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, "NHWC", in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, 1, **kwargs)
        self._specs["weight"].shape = (1,) + self._specs["weight"].shape

    def forward(self, x):
        self._infer(x, lead=(1,))
        out = _nn.convolution(x.unsqueeze(1), self.weight, self.bias,
                              stride=(1, _first(self._strides)),
                              pad=(0, _first(self._padding)),
                              dilate=(1, _first(self._dilation)),
                              groups=self._groups)
        return self._act(out.squeeze(1))


class Conv2DTranspose(_ConvBase):
    """≙ ``gluon.nn.Conv2DTranspose``: ``ops.nn.conv_transpose`` with the
    HWIO weight ``(kh, kw, in/groups, out)``."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NHWC",
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zero", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, 2, **kwargs)
        self._output_padding = output_padding

    def forward(self, x):
        self._infer(x)
        out = _nn.conv_transpose(x, self.weight, self.bias,
                                 stride=self._strides, pad=self._padding,
                                 dilate=self._dilation,
                                 output_padding=self._output_padding,
                                 groups=self._groups, layout=self._layout)
        return self._act(out)


class Conv3D(_ConvBase):
    """≙ ``gluon.nn.Conv3D`` (NDHWC, weight DHWIO)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NDHWC", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zero", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, 3, **kwargs)

    def forward(self, x):
        self._infer(x)
        out = _nn.convolution_nd(x, self.weight, self.bias,
                                 stride=self._strides, pad=self._padding,
                                 dilate=self._dilation, groups=self._groups,
                                 ndims=3)
        return self._act(out)


class Conv1DTranspose(HybridBlock):
    """≙ ``gluon.nn.Conv1DTranspose`` (NWC): a ``Conv2DTranspose`` of
    height 1, held as the child ``_inner`` as in the reference."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, in_channels=0, use_bias=True,
                 weight_initializer=None, bias_initializer="zero", **kwargs):
        super().__init__(**kwargs)
        self._inner = Conv2DTranspose(
            channels, (1, kernel_size), strides=(1, strides),
            padding=(0, padding), output_padding=(0, output_padding),
            in_channels=in_channels, use_bias=use_bias,
            weight_initializer=weight_initializer,
            bias_initializer=bias_initializer)

    def forward(self, x):
        return self._inner(x.unsqueeze(1)).squeeze(1)


class _Pool(HybridBlock):
    """``ceil_mode`` is accepted and ignored, as the reference's
    ``_Pool`` ignores it: its windows are always the floor's."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NHWC",
                 ceil_mode=False, count_include_pad=True, pool_type="max",
                 global_pool=False, **kwargs):
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


class MaxPool1D(HybridBlock):
    """≙ ``gluon.nn.MaxPool1D`` (NWC): a 2-D max pool of height 1."""

    def __init__(self, pool_size=2, strides=None, padding=0, **kwargs):
        super().__init__(**kwargs)
        self._kw = dict(kernel=(1, pool_size),
                        stride=(1, strides if strides else pool_size),
                        pad=(0, padding), pool_type="max")

    def forward(self, x):
        return _nn.pooling(x.unsqueeze(1), **self._kw).squeeze(1)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NHWC",
                 count_include_pad=True, **kwargs):
        super().__init__(pool_size, strides, padding, layout,
                         count_include_pad=count_include_pad,
                         pool_type="avg", **kwargs)


class GlobalMaxPool2D(_Pool):
    def __init__(self, layout="NHWC", **kwargs):
        super().__init__(layout=layout, pool_type="max", global_pool=True,
                         **kwargs)


class GlobalAvgPool2D(_Pool):
    def __init__(self, layout="NHWC", **kwargs):
        super().__init__(layout=layout, pool_type="avg", global_pool=True,
                         **kwargs)


class _PoolND(HybridBlock):
    """The 1-D and 3-D pools (channels last) on ``ops.nn.pooling_nd``."""

    def __init__(self, ndims, pool_size, strides, padding, pool_type,
                 global_pool=False, count_include_pad=True, **kwargs):
        super().__init__(**kwargs)
        self._kw = dict(kernel=pool_size, stride=strides, pad=padding,
                        pool_type=pool_type, global_pool=global_pool,
                        count_include_pad=count_include_pad, ndims=ndims)

    def forward(self, x):
        return _nn.pooling_nd(x, **self._kw)


class MaxPool3D(_PoolND):
    def __init__(self, pool_size=2, strides=None, padding=0, **kwargs):
        super().__init__(3, pool_size, strides, padding, "max", **kwargs)


class AvgPool3D(_PoolND):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 count_include_pad=True, **kwargs):
        super().__init__(3, pool_size, strides, padding, "avg",
                         count_include_pad=count_include_pad, **kwargs)


class AvgPool1D(_PoolND):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 count_include_pad=True, **kwargs):
        super().__init__(1, pool_size, strides, padding, "avg",
                         count_include_pad=count_include_pad, **kwargs)


class GlobalMaxPool1D(_PoolND):
    def __init__(self, **kwargs):
        super().__init__(1, 1, None, 0, "max", global_pool=True, **kwargs)


class GlobalAvgPool1D(_PoolND):
    def __init__(self, **kwargs):
        super().__init__(1, 1, None, 0, "avg", global_pool=True, **kwargs)


class GlobalMaxPool3D(_PoolND):
    def __init__(self, **kwargs):
        super().__init__(3, 1, None, 0, "max", global_pool=True, **kwargs)


class GlobalAvgPool3D(_PoolND):
    def __init__(self, **kwargs):
        super().__init__(3, 1, None, 0, "avg", global_pool=True, **kwargs)


def _write_back(bn, new_mean, new_var):
    """Store a training step's running statistics into ``bn``'s buffers
    (in place, outside autograd)."""
    with torch.no_grad():
        bn.running_mean.copy_(new_mean)
        bn.running_var.copy_(new_var)


class BatchNorm(HybridBlock):
    """≙ ``gluon.nn.BatchNorm`` over ``axis`` (default -1, NHWC): gamma/
    beta are parameters, running_mean/var buffers.  In training mode it
    normalizes by the batch statistics and updates the running ones
    (``new = momentum·running + (1 − momentum)·batch``) unless
    ``use_global_stats``."""

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
        training = _training(self)
        out, new_mean, new_var = _nn.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            momentum=self._momentum, eps=self._eps,
            use_global_stats=self._use_global_stats, training=training,
            axis=self._axis)
        if training and not self._use_global_stats:
            _write_back(self, new_mean, new_var)
        return out


class LayerNorm(HybridBlock):
    """≙ ``gluon.nn.LayerNorm`` over ``axis`` (``ops.nn.layer_norm``: the
    LayerNorm kernel on the card over the last axis): gamma One, beta
    Zero, their length deferred to the first input when ``in_channels``
    is 0."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._eps = epsilon
        sh = (in_channels,)
        self._param("gamma", sh, init.One(), differentiable=scale)
        self._param("beta", sh, init.Zero(), differentiable=center)

    def forward(self, x):
        c = x.shape[self._axis]
        for name in ("gamma", "beta"):
            self._finish(name, (c,), x.device)
        return _nn.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._eps)


class GroupNorm(HybridBlock):
    """≙ ``gluon.nn.GroupNorm`` over the last axis (``ops.nn.group_norm``):
    gamma One, beta Zero, of the channels' length."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._ng = num_groups
        self._eps = epsilon
        self._param("gamma", (in_channels,), init.One())
        self._param("beta", (in_channels,), init.Zero())

    def forward(self, x):
        for name in ("gamma", "beta"):
            self._finish(name, (x.shape[-1],), x.device)
        return _nn.group_norm(x, self.gamma, self.beta,
                              num_groups=self._ng, eps=self._eps)


class InstanceNorm(HybridBlock):
    """≙ ``gluon.nn.InstanceNorm`` (``ops.nn.instance_norm``), channels on
    ``axis``."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._eps = epsilon
        self._param("gamma", (in_channels,), init.One())
        self._param("beta", (in_channels,), init.Zero())

    def forward(self, x):
        for name in ("gamma", "beta"):
            self._finish(name, (x.shape[self._axis],), x.device)
        return _nn.instance_norm(x, self.gamma, self.beta, eps=self._eps,
                                 axis=self._axis)


class Embedding(HybridBlock):
    """≙ ``gluon.nn.Embedding``: weight ``(input_dim, output_dim)`` of
    ``dtype`` (a float dtype: float32, float64, bfloat16, float16),
    ``Normal(0.02)`` by default; the forward gathers its rows at integer
    ids.  ``sparse_grad=True`` marks the weight ``grad_stype =
    "row_sparse"``, as the reference does: the forward and the dense
    gradient autograd writes are unchanged, and ``Trainer`` sends the
    weight through the optimizer's lazy update of the rows whose gradient
    has a non-zero entry."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        dt = as_dtype(dtype)
        if not dt.is_floating_point:
            raise TypeError(f"Embedding dtype {dtype!r}: the table is of "
                            f"a float dtype")
        self._param("weight", (input_dim, output_dim),
                    weight_initializer or init.Normal(0.02), dtype=dt)
        if sparse_grad:
            self.weight.grad_stype = "row_sparse"

    def forward(self, x):
        return _nn.embedding(x, self.weight)


class Lambda(Block):
    """≙ ``gluon.nn.Lambda``: a block whose forward is ``function``."""

    def __init__(self, function, **kwargs):
        super().__init__(**kwargs)
        self._fn = function

    def forward(self, *args):
        return self._fn(*args)


class HybridLambda(Lambda, HybridBlock):
    """≙ ``gluon.nn.HybridLambda``."""


class Identity(HybridBlock):
    def forward(self, x):
        return x


class ReflectionPad2D(HybridBlock):
    """≙ ``gluon.nn.ReflectionPad2D`` (NHWC)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        self._pad = padding

    def forward(self, x):
        return _nn.reflection_pad2d(x, self._pad)


class HybridConcatenate(_Sequence, HybridBlock):
    """≙ ``gluon.nn.HybridConcatenate``: the children, named "0", "1",
    ..., run on the same input and their outputs are concatenated along
    ``axis`` (default -1, the channels of NHWC)."""

    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis
        self._layers = []

    def forward(self, x):
        return torch.cat([b(x) for b in self._layers], dim=self._axis)


Concatenate = HybridConcatenate


_route = threading.local()


@contextlib.contextmanager
def _layer_by_layer():
    """While active on this thread, ``fused_conv_bn_relu`` runs every
    segment as its layers (``bn(conv(x))``), which computes the same
    function: ``quantization.quantize_net`` calibrates under it, so each
    conv's input passes through the conv's own call, as the reference
    switches its fused route off for the calibration."""
    prev = getattr(_route, "layers", False)
    _route.layers = True
    try:
        yield
    finally:
        _route.layers = prev


def fused_block_active() -> bool:
    """True: the port's ResNet blocks always take the fused forward.
    The reference consults its TPU A/B table here; the port routes by
    device inside ``ops.conv_block.conv_affine`` instead."""
    return True


def fused_conv_bn_relu(conv: Conv2D, bn: BatchNorm, x, residual=None,
                       relu: bool = True):
    """Run a Conv2D + BatchNorm (+ residual add) (+ ReLU) segment through
    ``ops.nn.residual_block`` (the fused kernels on the card: conv_affine
    in inference, conv_stats + bn_affine in training) when it has the
    kernels' structure: 3×3, stride 1, pad 1, no dilation, groups or bias,
    NHWC, BN over the last axis.  In training mode the BN's running
    statistics are updated as ``BatchNorm`` updates them.  Any other
    segment runs its layers one by one, which computes the same
    function.

    A conv that ``quantization.observe_activations`` watches has its
    input recorded on the fused route too.

    After ``quantization.quantize_net`` the conv slot holds a
    ``QuantizedConv2D`` twin and the BN slot the identity its BN was
    folded into: the twin's ``fused_forward`` carries the epilogue
    (dequantization, folded BN, residual add, ReLU) through the int8
    kernel, before any other check, as in the reference."""
    fused = getattr(conv, "fused_forward", None)
    if fused is not None:
        return fused(x, residual=residual, relu=relu)
    if getattr(_route, "layers", False) or not (
            conv._kernel == (3, 3) and _pair(conv._strides) == (1, 1)
            and _pair(conv._padding) == (1, 1)
            and _pair(conv._dilation) == (1, 1) and conv._groups == 1
            and conv.bias is None and conv.act is None
            and conv._layout == "NHWC" and bn._axis in (-1, 3)):
        out = bn(conv(x))
        if residual is not None:
            out = out + residual
        return out.relu() if relu else out
    watch = getattr(conv, "_mx_observe", None)
    if watch is not None:
        # quantization.observe_activations: the conv's input, seen here
        # because this route never calls the conv's forward
        watch(x)
    conv._infer(x)
    bn._infer(conv._channels, x.device)
    training = _training(bn)
    y, new_mean, new_var = _nn.residual_block(
        x, conv.weight, bn.gamma, bn.beta, bn.running_mean, bn.running_var,
        residual, momentum=bn._momentum, eps=bn._eps,
        use_global_stats=bn._use_global_stats, training=training,
        relu=relu)
    if training and not bn._use_global_stats:
        _write_back(bn, new_mean, new_var)
    return y
