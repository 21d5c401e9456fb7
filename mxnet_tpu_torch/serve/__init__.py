"""Serving of the port: token-level continuous batching."""
from .batcher import DecodeBatcher, QueueFull, RequestError

__all__ = ["DecodeBatcher", "QueueFull", "RequestError"]
