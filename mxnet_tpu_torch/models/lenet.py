"""LeNet-5 (≙ ``mxnet_tpu/models/lenet.py``, the Net of
``example/gluon/mnist/mnist.py``): NHWC input (N, 28, 28, 1)."""
from __future__ import annotations

from ..gluon import nn

__all__ = ["LeNet"]


class LeNet(nn.HybridSequential):
    def __init__(self, classes=10, **kwargs):
        super().__init__(**kwargs)
        self.add(
            nn.Conv2D(20, kernel_size=5, activation="relu"),
            nn.MaxPool2D(pool_size=2, strides=2),
            nn.Conv2D(50, kernel_size=5, activation="relu"),
            nn.MaxPool2D(pool_size=2, strides=2),
            nn.Flatten(),
            nn.Dense(500, activation="relu"),
            nn.Dense(classes),
        )
