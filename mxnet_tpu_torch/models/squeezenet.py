"""SqueezeNet 1.0 and 1.1 (≙ ``mxnet_tpu/models/squeezenet.py``), NHWC.
The pools pass ``ceil_mode=True``, which ``nn.MaxPool2D`` ignores as the
reference's does, so a 224² input gives planes of 54, 26 and 12 (1.1:
55, 27, 13)."""
from __future__ import annotations

import torch

from ..gluon import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(nn.HybridBlock):
    def __init__(self, squeeze, expand1x1, expand3x3, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = nn.Conv2D(squeeze, 1, activation="relu")
        self.e1 = nn.Conv2D(expand1x1, 1, activation="relu")
        self.e3 = nn.Conv2D(expand3x3, 3, padding=1, activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.e1(x), self.e3(x)], dim=-1)


class SqueezeNet(nn.HybridBlock):
    def __init__(self, version="1.0", classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(
                nn.Conv2D(96, 7, strides=2, activation="relu"),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(16, 64, 64), _Fire(16, 64, 64), _Fire(32, 128, 128),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(32, 128, 128), _Fire(48, 192, 192),
                _Fire(48, 192, 192), _Fire(64, 256, 256),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(64, 256, 256),
            )
        else:
            self.features.add(
                nn.Conv2D(64, 3, strides=2, activation="relu"),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(16, 64, 64), _Fire(16, 64, 64),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(32, 128, 128), _Fire(32, 128, 128),
                nn.MaxPool2D(3, 2, ceil_mode=True),
                _Fire(48, 192, 192), _Fire(48, 192, 192),
                _Fire(64, 256, 256), _Fire(64, 256, 256),
            )
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(
            nn.Conv2D(classes, 1, activation="relu"),
            nn.GlobalAvgPool2D(),
            nn.Flatten(),
        )

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(classes=1000, **kwargs):
    return SqueezeNet("1.0", classes, **kwargs)


def squeezenet1_1(classes=1000, **kwargs):
    return SqueezeNet("1.1", classes, **kwargs)
