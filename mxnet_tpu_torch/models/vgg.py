"""VGG 11/13/16/19, with and without BatchNorm (≙
``mxnet_tpu/models/vgg.py``), NHWC."""
from __future__ import annotations

from ..gluon import nn

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"]

_SPEC = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(nn.HybridBlock):
    def __init__(self, num_layers=16, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        layers, filters = _SPEC[num_layers]
        self.features = nn.HybridSequential()
        for n, f in zip(layers, filters):
            for _ in range(n):
                self.features.add(nn.Conv2D(f, 3, padding=1))
                if batch_norm:
                    self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(2, 2))
        self.features.add(
            nn.Flatten(),
            nn.Dense(4096, activation="relu"), nn.Dropout(0.5),
            nn.Dense(4096, activation="relu"), nn.Dropout(0.5),
        )
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def _ctor(n, bn=False):
    def f(classes=1000, batch_norm=bn, **kwargs):
        return VGG(num_layers=n, classes=classes, batch_norm=batch_norm,
                   **kwargs)
    f.__name__ = f"vgg{n}_bn" if bn else f"vgg{n}"
    return f


vgg11, vgg13, vgg16, vgg19 = _ctor(11), _ctor(13), _ctor(16), _ctor(19)
vgg11_bn, vgg13_bn = _ctor(11, bn=True), _ctor(13, bn=True)
vgg16_bn, vgg19_bn = _ctor(16, bn=True), _ctor(19, bn=True)
