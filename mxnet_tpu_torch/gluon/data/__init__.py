"""gluon.data for the port — datasets, samplers and the ``DataLoader``
(≙ ``mxnet_tpu/gluon/data``).  Batches are host ``torch`` tensors;
``DataLoader(pipeline=True)`` stages them to the card through
``io.DataFeed``."""
from .dataset import Dataset, ArrayDataset, SimpleDataset  # noqa: F401
from .sampler import (Sampler, SequentialSampler, RandomSampler,  # noqa: F401
                      BatchSampler, FilterSampler, IntervalSampler)
from .dataloader import DataLoader  # noqa: F401
from . import vision  # noqa: F401
