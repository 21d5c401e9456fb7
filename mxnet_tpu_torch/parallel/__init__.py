"""The fused training step (≙ ``mxnet_tpu/parallel``, one device):
``FusedTrainStep`` and the executor behind ``Trainer.fuse_step``, each
training step one captured CUDA graph.  The mesh, sharding and
collective parts of the reference are not ported."""
from .train import FusedTrainStep, TrainerFusedStep

__all__ = ["FusedTrainStep", "TrainerFusedStep"]
