"""``gluon.model_zoo`` (≙ ``mxnet_tpu/gluon/model_zoo``)."""
from . import vision

__all__ = ["vision"]
