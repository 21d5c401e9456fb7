"""Gluon for the port: blocks as ``torch.nn.Module``s with the
reference's parameter names and ``.params`` format, the layers of the
image slices, the model zoo, the losses, the metrics and the ``Trainer`` (≙
``mxnet_tpu/gluon``)."""
from . import loss, metric, nn
from .block import (Block, HybridBlock, HybridSequential, Sequential,
                    SymbolBlock)
from .parameter import DeferredInitializationError, ParameterDict, load_numpy
from .trainer import Trainer
from . import model_zoo
from . import data

__all__ = ["nn", "loss", "metric", "model_zoo", "data", "Block", "HybridBlock", "Sequential",
           "HybridSequential", "SymbolBlock", "DeferredInitializationError",
           "ParameterDict", "load_numpy", "Trainer"]
