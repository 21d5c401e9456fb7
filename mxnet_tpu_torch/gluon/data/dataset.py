"""Datasets (≙ ``gluon/data/dataset.py``)."""
from __future__ import annotations

import torch

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        return _LazyTransformDataset(self, _First(fn), unpack=True)

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])


class _First:
    """Apply ``fn`` to a sample's first field (picklable, for worker
    processes)."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, *args):
        if len(args) == 1:
            return self._fn(args[0])
        return (self._fn(args[0]),) + args[1:]


class _LazyTransformDataset(Dataset):
    def __init__(self, base, fn, unpack=False):
        self._base = base
        self._fn = fn
        self._unpack = unpack

    def __len__(self):
        return len(self._base)

    def __getitem__(self, idx):
        item = self._base[idx]
        if self._unpack and isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """A zip of equally long arrays or datasets (≙
    ``gluon.data.ArrayDataset``); tensors are held as numpy arrays."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for a in args:
            if len(a) != self._length:
                raise ValueError("all arrays must have same length")
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]
