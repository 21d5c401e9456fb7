"""BytePS KVStore backend (≙ ``mxnet_tpu/kvstore/byteps.py``; reference
``python/mxnet/kvstore/byteps.py:29``): pushpull only, over byteps' torch
bindings; creating it without the package raises the reference's
ImportError."""
from __future__ import annotations

from . import KVStoreBase, _dense, _listify, _sum_list, _write, register

__all__ = ["BytePS"]


@register("byteps")
class BytePS(KVStoreBase):
    def __init__(self, name="byteps", **kwargs):
        super().__init__(name, **kwargs)
        try:
            import byteps.torch as bps
        except ImportError as e:
            raise ImportError(
                "kvstore 'byteps' requires the byteps package "
                "(reference kvstore/byteps.py has the same hard "
                "dependency)") from e
        self._bps = bps
        bps.init()

    @property
    def rank(self):
        return self._bps.rank()

    @property
    def num_workers(self):
        return self._bps.size()

    def pushpull(self, key, value, out=None, priority=0):
        vals = _listify(value)
        agg = _sum_list([_dense(v) for v in vals]).clone()
        self._bps.byteps_declare_tensor(str(key))
        self._bps.byteps_push_pull(agg, name=str(key), average=False)
        _write(vals if out is None else _listify(out), agg)
        return out

    def is_capable(self, capability):
        # byteps: pushpull only (byteps.py capability flags)
        return capability == KVStoreBase.PUSHPULL
