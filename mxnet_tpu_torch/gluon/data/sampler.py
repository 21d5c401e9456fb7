"""Samplers (≙ ``gluon/data/sampler.py``)."""
from __future__ import annotations

import numpy as onp

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A permutation from numpy's global generator, as the reference's."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(onp.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Batches of ``batch_size`` indices; the last one kept, discarded or
    rolled over into the next epoch (``last_batch``)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(f"last_batch must be keep/discard/rollover, "
                                 f"got {self._last_batch}")

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // \
                self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._sampler) + len(self._prev)) // self._batch_size


class FilterSampler(Sampler):
    """The indices where ``fn(dataset[i])`` is true."""

    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class IntervalSampler(Sampler):
    """Strided interleave: 0, interval, 2*interval, ..., then 1,
    interval+1, ... (``rollover``), or the first pass alone."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise ValueError("interval must not exceed length")
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        starts = range(self._interval) if self._rollover else [0]
        for start in starts:
            for i in range(start, self._length, self._interval):
                yield i

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
