"""``gluon.model_zoo.vision`` (≙ ``mxnet_tpu/gluon/model_zoo/vision``):
the zoo of ``models``, re-exported."""
from ....models import (  # noqa: F401
    get_model, LeNet, AlexNet, alexnet, VGG, vgg11, vgg13, vgg16, vgg19,
    vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn,
    ResNetV1, ResNetV2, resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
    resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2,
    resnet152_v2, MobileNet, MobileNetV2,
    mobilenet1_0, mobilenet0_75, mobilenet0_5, mobilenet0_25,
    mobilenet_v2_1_0, mobilenet_v2_0_75, mobilenet_v2_0_5,
    mobilenet_v2_0_25,
    SqueezeNet, squeezenet1_0, squeezenet1_1, DenseNet, densenet121,
    densenet161, densenet169, densenet201, Inception3, inception_v3)
