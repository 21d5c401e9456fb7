"""fp16 training in the PyTorch port against the JAX package's on the
CPU: two SGD steps of ResNet-18 v1 at 48x48 through
``parallel.FusedTrainStep(dtype="float16", grad_scale=)`` (the reference's
fused blocks on their Pallas route in interpret mode), and the eager
``amp.init("float16")`` Trainer with ``amp.init_trainer``'s dynamic loss
scale from 2^16 on a small ResNet.  On the card the fused step is one
captured CUDA graph a step on the fp16 kernels, which ``chip_smoke.py
fp16_train`` drives at full width.

The oracle is ``test_torch_bf16_train``'s, whose helpers these tests
share: the reference's fp16 step run op by op (``jax.disable_jit()``;
its jitted step keeps some intermediates in fp32), and the rule that the
port's fp16 run lies no farther from the reference's fp16 run than that
lies from the reference's fp32 run, in the losses and in every master
weight and running statistic after the steps.

The loss scale.  An fp16 step's small gradients fall into fp16's
subnormals or to zero; the reference's ``FusedTrainStep`` takes one
static ``grad_scale``, which multiplies the loss before the backward and
divides the gradients after it.  ``SCALE`` = 1024 is one a user of it
sets on ResNet: well above 1, well below the scale at which fp16's
largest gradients overflow."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import amp as jamp  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu.gluon import loss as jloss  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.models.resnet import BasicBlockV1 as JBasic  # noqa: E402
from mxnet_tpu_torch import amp, autograd, gluon  # noqa: E402
from mxnet_tpu_torch.gluon import loss as tloss  # noqa: E402
from mxnet_tpu_torch.gluon import nn  # noqa: E402
from mxnet_tpu_torch.models.resnet import BasicBlockV1 as TBasic  # noqa
from mxnet_tpu_torch.ops import conv_block  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402
from test_torch_bf16_train import (FORCED, SGD, _assert_within_reference_spread,  # noqa
                                   _port_run, _reference_run, _resnet_arrays,
                                   _resnet_batches)
from test_torch_resnet import TRAIN_ITEM, weights_for  # noqa: E402

torch.set_num_threads(1)

SCALE = 1024.0          # the fp16 step's static loss scale (module note)
AMP_STEPS = 6           # eager amp steps from the scale 2^16
AMP_ITEM = (8, 8, 3)


def test_resnet18_fp16_fused_step_matches_reference(monkeypatch):
    """Two SGD steps (momentum 0.9, wd 1e-4) of ResNet-18 v1 at 48x48,
    batch 2, through ``FusedTrainStep(dtype="float16", grad_scale=1024)``
    on both sides: the port's losses and fp32 masters within the
    reference's own fp16-vs-fp32 distance of the reference's fp16 step;
    the masters and the running statistics stay fp32."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
    monkeypatch.setenv("MXNET_TPU_PALLAS_STAGES", FORCED)
    from mxnet_tpu import models as jmodels
    from mxnet_tpu_torch import models as tmodels
    arrays = _resnet_arrays()
    batches = _resnet_batches()

    def jmake():
        net = jmodels.get_model("resnet18_v1", classes=10)
        net.initialize()
        net(mx.np.array(np.zeros((1,) + TRAIN_ITEM, np.float32)))
        return net
    ref16 = _reference_run(jmake, arrays, batches, "sgd", SGD, "float16",
                           SCALE)
    ref32 = _reference_run(jmake, arrays, batches, "sgd", SGD, None)
    *port, tnet = _port_run(lambda: tmodels.get_model("resnet18_v1",
                                                      classes=10),
                            arrays, batches, "sgd", SGD, "float16", SCALE)
    assert all(t.dtype == torch.float32
               for t in tnet.collect_params().values())
    _assert_within_reference_spread(tuple(port), ref16, ref32, arrays)


# ------------------------------------------------- amp's dynamic scale
def _tiny(gnn, basic):
    """A small ResNet: a 3x3 conv stem + BN + ReLU, one basic residual
    block (two fused 3x3/s1 segments), pooling and a dense head."""
    net = gnn.HybridSequential()
    net.add(gnn.Conv2D(8, 3, padding=1, use_bias=False), gnn.BatchNorm(),
            gnn.Activation("relu"), basic(8, 1), gnn.GlobalAvgPool2D(),
            gnn.Flatten(), gnn.Dense(4))
    return net


def _amp_batches():
    rs = np.random.RandomState(8)
    return [(rs.randn(2, *AMP_ITEM).astype(np.float32),
             rs.randint(0, 4, (2,)).astype(np.int32))
            for _ in range(AMP_STEPS)]


def _reference_amp(arrays, batches, dtype):
    """The reference's eager Trainer (SGD lr 0.1, momentum 0.9) over
    ``batches``, under ``amp.init(dtype)`` with ``amp.init_trainer`` and
    ``amp.scale_loss`` when ``dtype`` is set: → (losses, scales used,
    scales after, {name: array after})."""
    jnet = _tiny(jgnn, JBasic)
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1,) + AMP_ITEM, np.float32)))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.np.array(arrays[k])._data)
    if dtype:
        jamp.init(dtype)
    try:
        tr = jgluon.Trainer(jnet.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
        if dtype:
            jamp.init_trainer(tr)
        losses, used, after = [], [], []
        for x, y in batches:
            with mx.autograd.record():
                jl = jloss.SoftmaxCrossEntropyLoss()(jnet(mx.np.array(x)),
                                                     mx.np.array(y))
            if dtype:
                used.append(tr._amp_loss_scaler.loss_scale)
                with jamp.scale_loss(jl, tr) as scaled:
                    scaled.backward()
            else:
                jl.backward()
            tr.step(x.shape[0])
            if dtype:
                after.append(tr._amp_loss_scaler.loss_scale)
            losses.append(float(np.asarray(jl._data).mean()))
    finally:
        jamp.deinit()
    return losses, used, after, {
        k: np.asarray(p.data()._data).astype(np.float32)
        for k, p in jnet.collect_params().items()}


def _port_amp(arrays, batches):
    """The same on the port under ``amp.init("float16")``."""
    tnet = _tiny(nn, TBasic)
    gluon.load_numpy(tnet, arrays)
    amp.init("float16")
    try:
        tr = gluon.Trainer(tnet.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
        amp.init_trainer(tr)
        losses, used, after = [], [], []
        for x, y in batches:
            with autograd.record():
                tl = tloss.SoftmaxCrossEntropyLoss()(
                    tnet(torch.from_numpy(x)), torch.from_numpy(y))
            used.append(tr._amp_loss_scaler.loss_scale)
            with amp.scale_loss(tl, tr) as scaled:
                scaled.backward(torch.ones_like(scaled))
            tr.step(x.shape[0])
            after.append(tr._amp_loss_scaler.loss_scale)
            losses.append(float(tl.detach().mean()))
    finally:
        amp.deinit()
    return losses, used, after, {
        k: t.detach().numpy().copy()
        for k, t in tnet.collect_params().items()}


def test_amp_fp16_trainer_scale_follows_reference(monkeypatch):
    """``amp.init("float16")`` + ``amp.init_trainer`` + ``amp.scale_loss``
    on a small ResNet for six SGD steps from the scale 2^16: the scale
    each step used and the scale after it (a skipped step halves it) are
    the reference's, step for step; the losses and the weights after lie
    no farther from the reference's amp run than that lies from its fp32
    run; the 3x3/s1 convs of the residual block went through the fp16
    route (``Conv3x3Fn``: rows 7 and 11), and after ``amp.deinit()``
    nothing stays patched."""
    jnet = _tiny(jgnn, JBasic)
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1,) + AMP_ITEM, np.float32)))
    arrays = weights_for([(k, p.shape) for k, p in
                          jnet.collect_params().items()], 9)
    batches = _amp_batches()
    seen = []
    real = conv_block.conv3x3

    def counted(x, w):
        seen.append(x.dtype)
        return real(x, w)
    monkeypatch.setattr(conv_block, "conv3x3", counted)
    port = _port_amp(arrays, batches)
    ref16 = _reference_amp(arrays, batches, "float16")
    ref32 = _reference_amp(arrays, batches, None)
    assert port[1][0] == ref16[1][0] == 2.0 ** 16
    assert port[1] == ref16[1] and port[2] == ref16[2], (port[1:3],
                                                         ref16[1:3])
    assert any(b < a for a, b in zip(port[1], port[2]))     # a skip
    assert any(b == a for a, b in zip(port[1], port[2]))    # a step
    # a step: the stem's forward (its input needs no gradient), forward
    # and dgrad of the block's two segments, all in fp16
    assert seen == [torch.float16] * (5 * AMP_STEPS)
    assert not [n for n in dir(tnn)
                if hasattr(getattr(tnn, n), "__wrapped__")]
    _assert_within_reference_spread((port[0], port[3]), (ref16[0], ref16[3]),
                                    (ref32[0], ref32[3]), arrays)
