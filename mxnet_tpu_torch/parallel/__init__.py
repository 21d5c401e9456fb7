"""The fused training step and the multi-process contract (≙
``mxnet_tpu/parallel``): ``FusedTrainStep`` and the executor behind
``Trainer.fuse_step``, each training step one captured CUDA graph, and
``dist`` (``initialize``, ``rank``, ``size``, ``barrier`` over
``torch.distributed``; the dist KVStore's rendezvous).  The mesh,
sharding and tensor-parallel parts of the reference are not ported."""
from . import dist
from .train import FusedTrainStep, TrainerFusedStep

__all__ = ["FusedTrainStep", "TrainerFusedStep", "dist"]
