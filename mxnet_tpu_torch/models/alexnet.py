"""AlexNet (≙ ``mxnet_tpu/models/alexnet.py``), NHWC; the first Dense
reads the features flattened in NHWC order, as the reference's."""
from __future__ import annotations

from ..gluon import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(nn.HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(
            nn.Conv2D(64, 11, strides=4, padding=2, activation="relu"),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 5, padding=2, activation="relu"),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(384, 3, padding=1, activation="relu"),
            nn.Conv2D(256, 3, padding=1, activation="relu"),
            nn.Conv2D(256, 3, padding=1, activation="relu"),
            nn.MaxPool2D(3, 2),
            nn.Flatten(),
            nn.Dense(4096, activation="relu"),
            nn.Dropout(0.5),
            nn.Dense(4096, activation="relu"),
            nn.Dropout(0.5),
        )
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(classes=1000, **kwargs):
    return AlexNet(classes=classes, **kwargs)
