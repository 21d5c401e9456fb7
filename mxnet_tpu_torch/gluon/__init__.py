"""Gluon for the port: blocks as ``torch.nn.Module``s with the
reference's parameter names and ``.params`` format, and the layers of
the image-serving slice (≙ ``mxnet_tpu/gluon``)."""
from . import nn
from .block import Block, HybridBlock, HybridSequential, Sequential
from .parameter import DeferredInitializationError, ParameterDict, load_numpy

__all__ = ["nn", "Block", "HybridBlock", "Sequential", "HybridSequential",
           "DeferredInitializationError", "ParameterDict", "load_numpy"]
