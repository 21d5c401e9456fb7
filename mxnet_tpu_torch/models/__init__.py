"""Models of the port, and ``get_model`` for the ResNet zoo
(≙ ``mxnet_tpu/models/__init__.py``).  The Gluon BERT
(``models.bert_gluon``) is built by its own constructors, as in the
reference, whose ``get_model`` does not list it either."""
from . import bert, bert_gluon, gpt, resnet
from .bert import BertConfig, BertModel
from .gpt import GPTConfig, GPTModel
from .resnet import (ResNetV1, ResNetV2, resnet18_v1, resnet34_v1,
                     resnet50_v1, resnet101_v1, resnet152_v1, resnet18_v2,
                     resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2)

__all__ = ["bert", "bert_gluon", "gpt", "resnet", "BertConfig", "BertModel", "GPTConfig",
           "GPTModel", "ResNetV1", "ResNetV2", "get_model"]

_MODELS = {f.__name__: f for f in (
    resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1, resnet152_v1,
    resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2)}


def get_model(name, pretrained=False, **kwargs):
    """≙ ``gluon.model_zoo.vision.get_model`` for the ported zoo (the
    ResNets).  ``pretrained=True`` raises: the model store is not
    ported; load weights with ``load_parameters`` instead."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(f"unknown model {name}; available: "
                         f"{sorted(_MODELS)}")
    if pretrained:
        raise NotImplementedError(
            "pretrained weights come from the model store "
            "(models/model_store.py), which is not ported; build the net "
            "and call load_parameters(path)")
    return _MODELS[name](**kwargs)
