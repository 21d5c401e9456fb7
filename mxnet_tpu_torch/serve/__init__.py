"""Serving of the port: request-level batching over an
``InferenceEngine`` with a ``ModelRegistry`` in front (image serving),
and token-level continuous batching over a decode engine."""
from .batcher import Batcher, DecodeBatcher, QueueFull, RequestError
from .engine import (DEFAULT_BUCKETS, InferenceEngine, bucket_ladder,
                     resolve_precision)
from .registry import ModelEntry, ModelRegistry

__all__ = ["Batcher", "DecodeBatcher", "QueueFull", "RequestError",
           "InferenceEngine", "DEFAULT_BUCKETS", "bucket_ladder",
           "resolve_precision", "ModelRegistry", "ModelEntry"]
