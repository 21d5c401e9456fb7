"""Gluon for the port: blocks as ``torch.nn.Module``s with the
reference's parameter names and ``.params`` format, the layers of the
image slices, the losses and the ``Trainer`` (≙ ``mxnet_tpu/gluon``)."""
from . import loss, nn
from .block import Block, HybridBlock, HybridSequential, Sequential
from .parameter import DeferredInitializationError, ParameterDict, load_numpy
from .trainer import Trainer

__all__ = ["nn", "loss", "Block", "HybridBlock", "Sequential",
           "HybridSequential", "DeferredInitializationError",
           "ParameterDict", "load_numpy", "Trainer"]
