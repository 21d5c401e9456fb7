"""Models of the port and ``get_model`` for the vision zoo
(≙ ``mxnet_tpu/models/__init__.py``): every name of the reference's
``_MODELS``, under the reference's keys.  The Gluon BERT
(``models.bert_gluon``) is built by its own constructors, as in the
reference, whose ``get_model`` does not list it either."""
from . import (bert, bert_gluon, densenet, gpt, inception, lenet, mobilenet,
               resnet, squeezenet, vgg)
from .alexnet import AlexNet, alexnet
from .bert import BertConfig, BertModel
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201)
from .gpt import GPTConfig, GPTModel
from .inception import Inception3, inception_v3
from .lenet import LeNet
from .mobilenet import (MobileNet, MobileNetV2, mobilenet0_25, mobilenet0_5,
                        mobilenet0_75, mobilenet1_0, mobilenet_v2_0_25,
                        mobilenet_v2_0_5, mobilenet_v2_0_75,
                        mobilenet_v2_1_0)
from .resnet import (ResNetV1, ResNetV2, resnet18_v1, resnet34_v1,
                     resnet50_v1, resnet101_v1, resnet152_v1, resnet18_v2,
                     resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import (VGG, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16, vgg16_bn,
                  vgg19, vgg19_bn)

__all__ = ["bert", "bert_gluon", "densenet", "gpt", "inception", "lenet",
           "mobilenet", "resnet", "squeezenet", "vgg", "model_store",
           "alexnet", "AlexNet",
           "BertConfig", "BertModel", "DenseNet", "GPTConfig", "GPTModel",
           "Inception3", "LeNet", "MobileNet", "MobileNetV2", "ResNetV1",
           "ResNetV2", "SqueezeNet", "VGG", "get_model"]


def _ssd_300_lite(**kwargs):
    raise NotImplementedError(
        "ssd_300_lite needs ops/boxes.py and ops/vision.py, which are not "
        "ported yet (ROADMAP Queue 1 item 8)")


_MODELS = {
    "lenet": LeNet,
    "alexnet": alexnet,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn,
    "vgg16_bn": vgg16_bn, "vgg19_bn": vgg19_bn,
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
    "ssd_300_lite": _ssd_300_lite,
}


def get_model(name, pretrained=False, root=None, **kwargs):
    """≙ ``gluon.model_zoo.vision.get_model``: the net registered under
    ``name`` (the reference's keys), built with ``kwargs``.
    ``ssd_300_lite`` raises ``NotImplementedError`` until its box ops are
    ported.  ``pretrained=True`` loads the weights that
    :func:`model_store.get_model_file` resolves (the local store under
    ``root``, else the ``MXNET_GLUON_REPO`` mirror); they load on the
    CPU, as ``load_parameters`` without ``ctx`` does."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(f"unknown model {name}; available: "
                         f"{sorted(_MODELS)}")
    net = _MODELS[name](**kwargs)
    if pretrained:
        path = model_store.get_model_file(name, root=root)
        net.load_parameters(path)
    return net


from . import model_store  # noqa: E402
