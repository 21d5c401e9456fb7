"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, ported slice by slice.  Slice 1 is
GPT generative serving: ``models.gpt`` → ``generate.DecodeEngine`` →
``serve.DecodeBatcher``, with hand-written CUDA kernels for LayerNorm
and causal flash attention.  Slice 2 is BERT masked-LM pretraining:
``models.bert`` + ``optimizer.AdamW``, driven by
``examples.bert_pretrain``, with hand-written CUDA kernels for the
non-causal flash-attention forward and its dq and dk/dv backward passes,
and a differentiable LayerNorm.  Slice 3 is image serving: the Gluon
stack (``gluon``: blocks as ``nn.Module``s with the reference's
parameter names and ``.params`` files) and ``models.resnet`` served by
``serve.ModelRegistry`` → ``InferenceEngine`` → ``Batcher``, with a
hand-written CUDA kernel for the fused 3×3 conv + folded frozen BN
(+ add) (+ ReLU).  Slice 4 is ResNet training: training-mode
BatchNorm, ``gluon.loss``, ``optimizer.SGD`` and ``gluon.Trainer``,
driven by ``examples.image_classification``, with hand-written CUDA
kernels for the fused block's training forward (conv + batch
statistics, the BN affine pass) and backward (dgrad, wgrad).  The
kernels (``csrc/``) are built with
``nvcc`` at their first launch.  Entry points run on the GPU unless
``device="cpu"`` is passed.  Importing the package builds nothing.
"""
from . import context, gluon, initializer, optimizer, telemetry
from .context import cpu, gpu, num_gpus
from .generate import DecodeEngine
from .models.bert import BertConfig, BertModel
from .models.gpt import GPTConfig, GPTModel, init_params, params_from_numpy
from .models import get_model
from .serve import (Batcher, DecodeBatcher, InferenceEngine,
                    ModelRegistry)

__all__ = ["context", "gluon", "initializer", "optimizer", "telemetry",
           "cpu", "gpu", "num_gpus", "DecodeEngine", "DecodeBatcher",
           "BertConfig", "BertModel", "GPTConfig", "GPTModel",
           "init_params", "params_from_numpy", "get_model", "Batcher",
           "InferenceEngine", "ModelRegistry"]
