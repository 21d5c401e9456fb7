"""Inception-v3 (≙ ``mxnet_tpu/models/inception.py``), NHWC, input
299×299×3.  The branch blocks keep the reference's child names:
``_Concurrent`` holds ``b0``, ``b1``, ..., ``_SplitConcat`` a ``base``
and ``head0``, ``head1``, and their outputs join by ``torch.cat`` on the
channel axis.  Every conv is conv + ``BatchNorm(epsilon=0.001)`` +
ReLU; the auxiliary classifier is left out, as the reference leaves it.
Ten of its convs are 3×3/s1/p1 and take the standalone conv route
(``ops/pallas_conv.py``): the stem's 32→64, two a block in the three A
blocks, one in B, one in each E block."""
from __future__ import annotations

import torch

from ..gluon import nn

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel, strides=1, padding=0):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel, strides=strides, padding=padding,
                      use_bias=False),
            nn.BatchNorm(epsilon=0.001),
            nn.Activation("relu"))
    return out


class _Concurrent(nn.HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._branches = []

    def add(self, *blocks):
        for b in blocks:
            self.add_module(f"b{len(self._branches)}", b)
            self._branches.append(b)

    def forward(self, x):
        return torch.cat([b(x) for b in self._branches], dim=-1)


def _pool_branch(pool_type, channels):
    out = nn.HybridSequential()
    if pool_type == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    else:
        out.add(nn.MaxPool2D(pool_size=3, strides=1, padding=1))
    if channels:
        out.add(_conv(channels, 1))
    return out


def _seq(*blocks):
    s = nn.HybridSequential()
    s.add(*blocks)
    return s


def _make_A(pool_features):
    out = _Concurrent()
    out.add(_conv(64, 1),
            _seq(_conv(48, 1), _conv(64, 5, padding=2)),
            _seq(_conv(64, 1), _conv(96, 3, padding=1),
                 _conv(96, 3, padding=1)),
            _pool_branch("avg", pool_features))
    return out


def _make_B():
    out = _Concurrent()
    out.add(_conv(384, 3, strides=2),
            _seq(_conv(64, 1), _conv(96, 3, padding=1),
                 _conv(96, 3, strides=2)),
            _seq(nn.MaxPool2D(pool_size=3, strides=2)))
    return out


def _make_C(channels_7x7):
    c = channels_7x7
    out = _Concurrent()
    out.add(_conv(192, 1),
            _seq(_conv(c, 1), _conv(c, (1, 7), padding=(0, 3)),
                 _conv(192, (7, 1), padding=(3, 0))),
            _seq(_conv(c, 1), _conv(c, (7, 1), padding=(3, 0)),
                 _conv(c, (1, 7), padding=(0, 3)),
                 _conv(c, (7, 1), padding=(3, 0)),
                 _conv(192, (1, 7), padding=(0, 3))),
            _pool_branch("avg", 192))
    return out


def _make_D():
    out = _Concurrent()
    out.add(_seq(_conv(192, 1), _conv(320, 3, strides=2)),
            _seq(_conv(192, 1), _conv(192, (1, 7), padding=(0, 3)),
                 _conv(192, (7, 1), padding=(3, 0)),
                 _conv(192, 3, strides=2)),
            _seq(nn.MaxPool2D(pool_size=3, strides=2)))
    return out


class _SplitConcat(nn.HybridBlock):
    """``base``, then its output through each head, the heads' outputs
    concatenated (the E block's fan-out)."""

    def __init__(self, base, heads, **kwargs):
        super().__init__(**kwargs)
        self.base = base
        for i, h in enumerate(heads):
            self.add_module(f"head{i}", h)
        self._n_heads = len(heads)

    def forward(self, x):
        y = self.base(x)
        return torch.cat([getattr(self, f"head{i}")(y)
                          for i in range(self._n_heads)], dim=-1)


def _make_E():
    out = _Concurrent()
    out.add(_conv(320, 1),
            _SplitConcat(_conv(384, 1),
                         [_conv(384, (1, 3), padding=(0, 1)),
                          _conv(384, (3, 1), padding=(1, 0))]),
            _SplitConcat(_seq(_conv(448, 1), _conv(384, 3, padding=1)),
                         [_conv(384, (1, 3), padding=(0, 1)),
                          _conv(384, (3, 1), padding=(1, 0))]),
            _pool_branch("avg", 192))
    return out


class Inception3(nn.HybridBlock):
    """Inception v3 (input 299×299×3 NHWC)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        f = nn.HybridSequential()
        f.add(_conv(32, 3, strides=2),
              _conv(32, 3),
              _conv(64, 3, padding=1),
              nn.MaxPool2D(pool_size=3, strides=2),
              _conv(80, 1),
              _conv(192, 3),
              nn.MaxPool2D(pool_size=3, strides=2),
              _make_A(32), _make_A(64), _make_A(64),
              _make_B(),
              _make_C(128), _make_C(160), _make_C(160), _make_C(192),
              _make_D(),
              _make_E(), _make_E(),
              nn.GlobalAvgPool2D(),
              nn.Dropout(0.5))
        self.features = f
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(classes=1000, **kwargs):
    return Inception3(classes=classes, **kwargs)
