"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, ported slice by slice.  This slice
is GPT generative serving: ``models.gpt`` → ``generate.DecodeEngine`` →
``serve.DecodeBatcher``, with hand-written CUDA kernels for LayerNorm
and causal flash attention (``csrc/``), built with ``nvcc`` at their
first launch.  Entry points run on the GPU unless ``device="cpu"`` is
passed.  Importing the package builds nothing.
"""
from . import context, telemetry
from .context import cpu, gpu, num_gpus
from .generate import DecodeEngine
from .models.gpt import GPTConfig, GPTModel, init_params, params_from_numpy
from .serve.batcher import DecodeBatcher

__all__ = ["context", "telemetry", "cpu", "gpu", "num_gpus", "DecodeEngine",
           "DecodeBatcher", "GPTConfig", "GPTModel", "init_params",
           "params_from_numpy"]
