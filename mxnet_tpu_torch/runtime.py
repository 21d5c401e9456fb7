"""``mx.runtime``: feature detection (≙ ``mxnet_tpu/runtime.py``, itself
≙ ``python/mxnet/runtime.py`` over ``src/libinfo.cc``).

Reports what this build can run, under the reference's feature names:
``GPU`` is a CUDA card that torch sees; ``TPU``, ``XLA`` and ``PALLAS``
(the JAX package's compiler and kernel language) and ``JIT`` (its traced
compilation: the port runs eager torch, with CUDA graphs in the fused
step) are false; the CPU, bf16 and int8 paths, the distributed KVStore
(``kvstore``: ``dist_sync`` over ``torch.distributed``, ``dist_async``
over the parameter server) and autograd are there.  The ``_ffi``
function ``runtime.Features`` keeps its own, torch-specific keys.
"""
from __future__ import annotations

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def feature_list():
    import torch
    feats = {
        "TPU": False,
        "GPU": torch.cuda.is_available(),
        "CPU": True,
        "XLA": False,
        "PALLAS": False,
        "BF16": True,
        "INT8": True,
        "DIST_KVSTORE": True,
        "JIT": False,
        "AUTOGRAD": True,
    }
    return [Feature(k, v) for k, v in feats.items()]


class Features(dict):
    def __init__(self):
        super().__init__({f.name: f for f in feature_list()})

    def is_enabled(self, name):
        return self[name.upper()].enabled
