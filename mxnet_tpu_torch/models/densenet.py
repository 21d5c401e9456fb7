"""DenseNet 121/161/169/201 (≙ ``mxnet_tpu/models/densenet.py``), NHWC:
each layer's output joins its input by ``torch.cat`` on the channel
(last) axis.  Every layer's 3×3 growth conv (stride 1, pad 1, no bias)
takes the standalone conv route (``ops/pallas_conv.py``): 58 a
DenseNet-121 forward."""
from __future__ import annotations

import torch

from ..gluon import nn

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]

_SPEC = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


class _DenseLayer(nn.HybridBlock):
    def __init__(self, growth_rate, bn_size=4, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        self.body.add(
            nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(bn_size * growth_rate, 1, use_bias=False),
            nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(growth_rate, 3, padding=1, use_bias=False),
        )

    def forward(self, x):
        return torch.cat([x, self.body(x)], dim=-1)


class _Transition(nn.HybridBlock):
    def __init__(self, out_channels, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        self.body.add(
            nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(out_channels, 1, use_bias=False),
            nn.AvgPool2D(2, 2),
        )

    def forward(self, x):
        return self.body(x)


class DenseNet(nn.HybridBlock):
    def __init__(self, num_layers=121, classes=1000, bn_size=4, **kwargs):
        super().__init__(**kwargs)
        num_init, growth, block_cfg = _SPEC[num_layers]
        self.features = nn.HybridSequential()
        self.features.add(
            nn.Conv2D(num_init, 7, strides=2, padding=3, use_bias=False),
            nn.BatchNorm(), nn.Activation("relu"),
            nn.MaxPool2D(3, 2, 1),
        )
        ch = num_init
        for i, n in enumerate(block_cfg):
            stage = nn.HybridSequential()
            for _ in range(n):
                stage.add(_DenseLayer(growth, bn_size))
            self.features.add(stage)
            ch += n * growth
            if i != len(block_cfg) - 1:
                ch //= 2
                self.features.add(_Transition(ch))
        self.features.add(nn.BatchNorm(), nn.Activation("relu"),
                          nn.GlobalAvgPool2D(), nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def _ctor(n):
    def f(classes=1000, **kwargs):
        return DenseNet(num_layers=n, classes=classes, **kwargs)
    f.__name__ = f"densenet{n}"
    return f


densenet121, densenet161, densenet169, densenet201 = \
    _ctor(121), _ctor(161), _ctor(169), _ctor(201)
