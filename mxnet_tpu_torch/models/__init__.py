"""Models of the port."""
from . import gpt
from .gpt import GPTConfig, GPTModel

__all__ = ["gpt", "GPTConfig", "GPTModel"]
