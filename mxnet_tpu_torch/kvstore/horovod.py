"""Horovod KVStore backend (≙ ``mxnet_tpu/kvstore/horovod.py``; reference
``python/mxnet/kvstore/horovod.py:27``).

A KVStoreBase plugin delegating broadcast / pushpull to horovod's torch
bindings when ``horovod`` is importable; otherwise creating it raises the
ImportError the reference raises without the package.  Registered under
``horovod`` so ``mx.kv.create('horovod')`` keeps the reference's plugin
contract (base.py:74 registry)."""
from __future__ import annotations

from . import KVStoreBase, _dense, _listify, _sum_list, _write, register

__all__ = ["Horovod"]


@register("horovod")
class Horovod(KVStoreBase):
    def __init__(self, name="horovod", **kwargs):
        super().__init__(name, **kwargs)
        try:
            import horovod.torch as hvd
        except ImportError as e:
            raise ImportError(
                "kvstore 'horovod' requires the horovod package "
                "(reference kvstore/horovod.py has the same hard "
                "dependency)") from e
        self._hvd = hvd
        hvd.init()

    @property
    def rank(self):
        return self._hvd.rank()

    @property
    def num_workers(self):
        return self._hvd.size()

    def broadcast(self, key, value, out, priority=0):
        val = _listify(value)[0]
        res = self._hvd.broadcast(val, root_rank=0, name=str(key))
        _write(_listify(out), res)
        return out

    def pushpull(self, key, value, out=None, priority=0):
        vals = _listify(value)
        agg = _sum_list([_dense(v) for v in vals])
        res = self._hvd.allreduce(agg, op=self._hvd.Sum, name=str(key))
        _write(vals if out is None else _listify(out), res)
        return out

    def is_capable(self, capability):
        # horovod backend: no server-side optimizer (horovod.py:142-145)
        return capability != KVStoreBase.OPTIMIZER
