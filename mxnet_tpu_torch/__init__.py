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
statistics, the BN affine pass) and backward (dgrad, wgrad).  Slice 5
is Gluon BERT serving (``models.bert_gluon`` on token items), with a
hand-written row-softmax kernel.  Slice 6 is int8 serving:
``quantization.quantize_net`` behind ``InferenceEngine(precision=
"int8")``, with a hand-written int8 tensor-core kernel for the 3×3 conv
+ dequantization (+ add) (+ ReLU).  Slice 7 is the extension surface:
runtime-compiled CUDA kernels (``rtc.CudaModule`` over NVRTC,
``_nvrtc``), the generated-op registry (``tvmop``, its kernels made from
the hand-written template ``csrc/tvmop_elementwise.cuh``; stock
``tvm_vadd``, ``tvm_vmul``, ``tvm_sigmoid``), Python custom ops
(``operator.CustomOp`` on ``autograd.Function``), ops from a user's
shared library (``library``) and the function registry (``_ffi``), all
joining the ``nd`` namespace.  The kernels of ``csrc/*.cu`` are built
with ``nvcc`` at their first launch, the generated and rtc kernels by
NVRTC at theirs.  The rest of the training surface is
``gluon.loss`` (all of the reference's losses but CTC), ``gluon.metric``,
``random`` (``mx.random``, seeded with ``mx.seed``), ``lr_scheduler``,
the ``Trainer``'s ``allreduce_grads`` / ``update`` / ``shard_batch``, and
the lone 3×3/s1 conv of ``ops.pallas_conv`` (ResNet v2's convs) on the
conv3x3 and conv_wgrad kernels.  bf16: ``amp`` and
``InferenceEngine(precision="bf16")`` serve, and
``parallel.FusedTrainStep(dtype="bfloat16")`` trains (fp32 masters, the
step in bf16), on the kernels' bf16 instances.  The host planes:
``checkpoint`` (durable async checkpoints of a Trainer, the reference's
format), ``serve.InferenceServer`` / ``serve.Router`` (serving over
HTTP), ``telemetry``, ``profiler``, ``faults`` and ``lockwatch``
(``MXNET_LOCK_CHECK``, installed here before any submodule builds a
lock).  The observed fleet: ``models.model_store`` (pretrained weights),
int8 thresholds calibrated from telemetry, ``io.data_service`` (decode
workers and the resilient ``FeedClient``), ``obs`` (the recorder,
signals and watchdog, imported here only when ``MXNET_OBS_INTERVAL_MS``
is set) and ``tracecheck``.  Entry points run on the GPU unless
``device="cpu"`` is passed.  Importing the package builds and compiles
nothing.
"""
# MXNET_LOCK_CHECK=1|warn: wrap threading.Lock/RLock/Condition with the
# order-recording watchdog before any submodule constructs its locks
# (lockwatch is stdlib only: nothing is added to import cost when off)
from . import lockwatch as _lockwatch
_lockwatch.install()

from . import (context, gluon, initializer, lr_scheduler, optimizer,
               random, telemetry)
from .context import (cpu, current_context, current_device, gpu, num_gpus,
                      waitall)
from .optimizer import Optimizer
from .generate import DecodeEngine
from .models.bert import BertConfig, BertModel
from .models.gpt import GPTConfig, GPTModel, init_params, params_from_numpy
from .models import get_model
from .serve import (Batcher, DecodeBatcher, InferenceEngine,
                    ModelRegistry)
from . import autograd, nd, operator, library, rtc, tvmop, _ffi, amp, sparse
from . import image, io, recordio, storage
from . import checkpoint, faults, lockwatch, profiler
from ._ffi import get_global_func, register_func

# the obs recorder: imported only when its sampling knob is set (its
# import starts the sampler thread), so the off path costs one env read
import os as _os
if _os.environ.get("MXNET_OBS_INTERVAL_MS", ""):
    from . import obs  # noqa: F401
del _os

init = initializer   # ≙ mx.init


def seed(s):
    """≙ ``mx.seed``: seed every randomness source the package draws
    from: ``random``'s per-device generators, Python's ``random`` and
    numpy's global state.  (A Block's ``initialize`` and a ``Dropout``
    keep their own explicitly seeded generators.)"""
    import random as _pyrandom

    import numpy as _onp
    random.seed(s)
    _pyrandom.seed(s)
    _onp.random.seed(int(s) % (2 ** 32))


__all__ = ["context", "gluon", "initializer", "init", "lr_scheduler",
           "optimizer", "Optimizer", "random", "seed", "telemetry", "cpu",
           "gpu", "num_gpus", "current_context", "current_device",
           "waitall", "DecodeEngine", "DecodeBatcher",
           "BertConfig", "BertModel", "GPTConfig", "GPTModel",
           "init_params", "params_from_numpy", "get_model", "Batcher",
           "InferenceEngine", "ModelRegistry", "autograd", "nd", "operator",
           "library", "rtc", "tvmop", "_ffi", "get_global_func",
           "register_func", "amp", "image", "io", "recordio", "storage",
           "checkpoint", "faults", "lockwatch", "profiler"]
