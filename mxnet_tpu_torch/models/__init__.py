"""Models of the port."""
from . import bert, gpt
from .bert import BertConfig, BertModel
from .gpt import GPTConfig, GPTModel

__all__ = ["bert", "gpt", "BertConfig", "BertModel", "GPTConfig",
           "GPTModel"]
