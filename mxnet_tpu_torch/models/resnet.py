"""ResNet v1/v2 (≙ ``mxnet_tpu/models/resnet.py``, 18/34/50/101/152).

NHWC throughout, children named as in the reference so that parameter
names line up.  The v1 blocks always take the fused forward: every
3×3/s1 conv + BatchNorm (+ add) (+ ReLU) segment goes through
``nn.fused_conv_bn_relu`` (the conv_affine kernel on the card), the
other convs through cuDNN.  That is 16 kernel segments per ResNet-50
forward (each bottleneck's mid conv) and, on ResNet-18/34, every basic
block's 3×3 head at stride 1 and every 3×3 tail (with the residual).
"""
from __future__ import annotations

from ..gluon import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BottleneckV1",
           "BasicBlockV2", "BottleneckV2",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


class BasicBlockV1(nn.HybridBlock):
    def __init__(self, channels, stride, downsample=False, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential()
        self.body.add(
            nn.Conv2D(channels, 3, strides=stride, padding=1, use_bias=False),
            nn.BatchNorm(),
            nn.Activation("relu"),
            nn.Conv2D(channels, 3, strides=1, padding=1, use_bias=False),
            nn.BatchNorm(),
        )
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(
                nn.Conv2D(channels, 1, strides=stride, use_bias=False),
                nn.BatchNorm(),
            )
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        # the stride-s head is fused where it is 3x3/s1; the tail always
        out = nn.fused_conv_bn_relu(self.body[0], self.body[1], x)
        return nn.fused_conv_bn_relu(self.body[3], self.body[4], out,
                                     residual=residual)


class BottleneckV1(nn.HybridBlock):
    def __init__(self, channels, stride, downsample=False, **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.body = nn.HybridSequential()
        self.body.add(
            nn.Conv2D(mid, 1, strides=stride, use_bias=False),
            nn.BatchNorm(),
            nn.Activation("relu"),
            nn.Conv2D(mid, 3, strides=1, padding=1, use_bias=False),
            nn.BatchNorm(),
            nn.Activation("relu"),
            nn.Conv2D(channels, 1, strides=1, use_bias=False),
            nn.BatchNorm(),
        )
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(
                nn.Conv2D(channels, 1, strides=stride, use_bias=False),
                nn.BatchNorm(),
            )
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        # only the 3x3/s1 mid conv is fused; the 1x1 convs go to cuDNN
        out = self.body[2](self.body[1](self.body[0](x)))
        out = nn.fused_conv_bn_relu(self.body[3], self.body[4], out)
        out = self.body[7](self.body[6](out))
        return (out + residual).relu()


class BasicBlockV2(nn.HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels, 3, strides=stride, padding=1,
                               use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = nn.Conv2D(channels, 3, strides=1, padding=1,
                               use_bias=False)
        self.downsample = nn.Conv2D(channels, 1, strides=stride,
                                    use_bias=False) if downsample else None

    def forward(self, x):
        pre = self.bn1(x).relu()
        residual = x if self.downsample is None else self.downsample(pre)
        out = self.conv1(pre)
        out = self.conv2(self.bn2(out).relu())
        return out + residual


class BottleneckV2(nn.HybridBlock):
    def __init__(self, channels, stride, downsample=False, **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(mid, 1, strides=1, use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = nn.Conv2D(mid, 3, strides=stride, padding=1,
                               use_bias=False)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, 1, strides=1, use_bias=False)
        self.downsample = nn.Conv2D(channels, 1, strides=stride,
                                    use_bias=False) if downsample else None

    def forward(self, x):
        pre = self.bn1(x).relu()
        residual = x if self.downsample is None else self.downsample(pre)
        out = self.conv1(pre)
        out = self.conv2(self.bn2(out).relu())
        out = self.conv3(self.bn3(out).relu())
        return out + residual


_SPECS = {
    18: ("basic", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottleneck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottleneck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottleneck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


class ResNetV1(nn.HybridBlock):
    def __init__(self, num_layers=50, classes=1000, **kwargs):
        super().__init__(**kwargs)
        block_kind, layers, channels = _SPECS[num_layers]
        block = BasicBlockV1 if block_kind == "basic" else BottleneckV1
        self.features = nn.HybridSequential()
        self.features.add(
            nn.Conv2D(channels[0], 7, strides=2, padding=3, use_bias=False),
            nn.BatchNorm(),
            nn.Activation("relu"),
            nn.MaxPool2D(3, 2, 1),
        )
        for i, num_blocks in enumerate(layers):
            stride = 1 if i == 0 else 2
            stage = nn.HybridSequential()
            stage.add(block(channels[i + 1], stride, downsample=True))
            for _ in range(num_blocks - 1):
                stage.add(block(channels[i + 1], 1))
            self.features.add(stage)
        self.features.add(nn.GlobalAvgPool2D(), nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(nn.HybridBlock):
    def __init__(self, num_layers=50, classes=1000, **kwargs):
        super().__init__(**kwargs)
        block_kind, layers, channels = _SPECS[num_layers]
        block = BasicBlockV2 if block_kind == "basic" else BottleneckV2
        self.features = nn.HybridSequential()
        self.features.add(
            nn.BatchNorm(scale=False, center=False),
            nn.Conv2D(channels[0], 7, strides=2, padding=3, use_bias=False),
            nn.BatchNorm(),
            nn.Activation("relu"),
            nn.MaxPool2D(3, 2, 1),
        )
        for i, num_blocks in enumerate(layers):
            stride = 1 if i == 0 else 2
            stage = nn.HybridSequential()
            stage.add(block(channels[i + 1], stride, downsample=True))
            for _ in range(num_blocks - 1):
                stage.add(block(channels[i + 1], 1))
            self.features.add(stage)
        self.features.add(nn.BatchNorm(), nn.Activation("relu"),
                          nn.GlobalAvgPool2D(), nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def _make(cls, n):
    def ctor(classes=1000, **kwargs):
        return cls(num_layers=n, classes=classes, **kwargs)
    ctor.__name__ = f"resnet{n}_{'v1' if cls is ResNetV1 else 'v2'}"
    return ctor


resnet18_v1 = _make(ResNetV1, 18)
resnet34_v1 = _make(ResNetV1, 34)
resnet50_v1 = _make(ResNetV1, 50)
resnet101_v1 = _make(ResNetV1, 101)
resnet152_v1 = _make(ResNetV1, 152)
resnet18_v2 = _make(ResNetV2, 18)
resnet34_v2 = _make(ResNetV2, 34)
resnet50_v2 = _make(ResNetV2, 50)
resnet101_v2 = _make(ResNetV2, 101)
resnet152_v2 = _make(ResNetV2, 152)
