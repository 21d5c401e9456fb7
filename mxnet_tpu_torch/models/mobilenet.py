"""MobileNet v1 and v2 at the four width multipliers (≙
``mxnet_tpu/models/mobilenet.py``), NHWC.  A depthwise conv is a
``Conv2D`` with ``groups`` equal to its channels (cuDNN on the card)."""
from __future__ import annotations

from ..gluon import nn

__all__ = ["MobileNet", "MobileNetV2",
           "mobilenet1_0", "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
           "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
           "mobilenet_v2_0_25"]


def _conv_bn(out, kernel, stride=1, pad=0, groups=1, act="relu"):
    seq = nn.HybridSequential()
    seq.add(nn.Conv2D(out, kernel, strides=stride, padding=pad, groups=groups,
                      use_bias=False),
            nn.BatchNorm())
    if act:
        seq.add(nn.Activation(act))
    return seq


class _DWSep(nn.HybridBlock):
    def __init__(self, in_ch, out_ch, stride, **kwargs):
        super().__init__(**kwargs)
        self.dw = _conv_bn(in_ch, 3, stride, 1, groups=in_ch)
        self.pw = _conv_bn(out_ch, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


def _width(multiplier):
    return lambda ch: max(int(ch * multiplier), 8)


class MobileNet(nn.HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        c = _width(multiplier)
        spec = [(c(64), 1), (c(128), 2), (c(128), 1), (c(256), 2),
                (c(256), 1), (c(512), 2)] + [(c(512), 1)] * 5 + \
            [(c(1024), 2), (c(1024), 1)]
        self.features = nn.HybridSequential()
        self.features.add(_conv_bn(c(32), 3, 2, 1))
        in_ch = c(32)
        for out_ch, s in spec:
            self.features.add(_DWSep(in_ch, out_ch, s))
            in_ch = out_ch
        self.features.add(nn.GlobalAvgPool2D(), nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class _InvertedResidual(nn.HybridBlock):
    def __init__(self, in_ch, out_ch, stride, expand, **kwargs):
        super().__init__(**kwargs)
        mid = in_ch * expand
        self.use_shortcut = stride == 1 and in_ch == out_ch
        self.body = nn.HybridSequential()
        if expand != 1:
            self.body.add(_conv_bn(mid, 1, act="relu"))
        self.body.add(_conv_bn(mid, 3, stride, 1, groups=mid, act="relu"),
                      _conv_bn(out_ch, 1, act=None))

    def forward(self, x):
        out = self.body(x)
        return out + x if self.use_shortcut else out


class MobileNetV2(nn.HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        c = _width(multiplier)
        self.features = nn.HybridSequential()
        self.features.add(_conv_bn(c(32), 3, 2, 1))
        in_ch = c(32)
        spec = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        for t, ch, n, s in spec:
            for i in range(n):
                self.features.add(_InvertedResidual(
                    in_ch, c(ch), s if i == 0 else 1, t))
                in_ch = c(ch)
        self.features.add(_conv_bn(max(1280, c(1280)), 1),
                          nn.GlobalAvgPool2D(), nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def _ctor(cls, mult, name):
    def f(classes=1000, **kwargs):
        return cls(mult, classes, **kwargs)
    f.__name__ = name
    return f


mobilenet1_0 = _ctor(MobileNet, 1.0, "mobilenet1_0")
mobilenet0_75 = _ctor(MobileNet, 0.75, "mobilenet0_75")
mobilenet0_5 = _ctor(MobileNet, 0.5, "mobilenet0_5")
mobilenet0_25 = _ctor(MobileNet, 0.25, "mobilenet0_25")
mobilenet_v2_1_0 = _ctor(MobileNetV2, 1.0, "mobilenet_v2_1_0")
mobilenet_v2_0_75 = _ctor(MobileNetV2, 0.75, "mobilenet_v2_0_75")
mobilenet_v2_0_5 = _ctor(MobileNetV2, 0.5, "mobilenet_v2_0_5")
mobilenet_v2_0_25 = _ctor(MobileNetV2, 0.25, "mobilenet_v2_0_25")
