"""bf16 training of ``bert_small`` through
``parallel.FusedTrainStep(dtype="bfloat16")`` in the PyTorch port
against the JAX package's on the CPU, held as
``test_torch_bf16_train.py`` holds ResNet-18 (its module note gives the
oracle: the reference's bf16 step run op by op, and the reference's own
bf16-vs-fp32 distance as the cap); the loss scaling of ``grad_scale``;
``FusedTrainStep``'s arguments; and one legacy ``amp`` training step of
ResNet-18 v1 (``amp.init`` + ``Trainer`` + ``amp.init_trainer`` +
``amp.scale_loss``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import amp as jamp  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu.models import bert_gluon as jbert  # noqa: E402
from mxnet_tpu_torch import amp, autograd, gluon  # noqa: E402
from mxnet_tpu_torch import optimizer as topt  # noqa: E402
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss  # noqa
from mxnet_tpu_torch.models import bert_gluon as tbert  # noqa: E402
from mxnet_tpu_torch.parallel import FusedTrainStep  # noqa: E402
from test_torch_bert_gluon import bert_weights  # noqa: E402
from test_torch_bf16_train import (SGD, _assert_within_reference_spread,  # noqa
                                   _dist, _port_run, _reference_run,
                                   _resnet_arrays, _resnet_batches)
from test_torch_resnet import port_net, reference_net  # noqa: E402

torch.set_num_threads(1)


def _bert_setup():
    rs = np.random.RandomState(9)
    batches = [(rs.randint(0, 1000, (2, 16)).astype(np.int32),
                rs.randint(0, 1000, (2, 16)).astype(np.int32))
               for _ in range(2)]

    def jmake():
        net = jbert.bert_small()
        net.initialize()
        net(mx.np.array(batches[0][0]))
        return net
    params = jmake().collect_params()
    arrays = bert_weights([(k, p.shape) for k, p in params.items()], 31)
    return jmake, arrays, batches


def test_bert_small_bf16_fused_step_matches_reference():
    """Two SGD steps (lr 0.05, momentum 0.9) of ``bert_small`` on (2, 16)
    tokens through ``FusedTrainStep(dtype="bfloat16")`` on both sides
    (the token ids cast to bf16 inside the step, as the reference casts
    an integer batch): the port within the reference's own bf16-vs-fp32
    distance of the reference's bf16 step.  SGD, not Adam, for the
    reason ``test_torch_fused_step``'s bert_small case gives."""
    jmake, arrays, batches = _bert_setup()
    kw = {"learning_rate": 0.05, "momentum": 0.9}
    ref16 = _reference_run(jmake, arrays, batches, "sgd", kw, "bfloat16")
    ref32 = _reference_run(jmake, arrays, batches, "sgd", kw, None)
    *port, _ = _port_run(tbert.bert_small, arrays, batches, "sgd", kw,
                         "bfloat16")
    _assert_within_reference_spread(tuple(port), ref16, ref32, arrays)


def test_grad_scale_is_bitwise_the_unscaled_step_and_matches_reference():
    """``grad_scale=1024`` (a power of two, far from overflow): the port's
    scaled bf16 steps equal its unscaled ones bit for bit, losses and
    weights, and lie within the reference's own bf16-vs-fp32 distance of
    the reference's scaled bf16 steps on ``bert_small``."""
    jmake, arrays, batches = _bert_setup()
    kw = {"learning_rate": 0.05, "momentum": 0.9}
    plain = _port_run(tbert.bert_small, arrays, batches, "sgd", kw,
                      "bfloat16")
    scaled = _port_run(tbert.bert_small, arrays, batches, "sgd", kw,
                       "bfloat16", grad_scale=1024.0)
    assert plain[0] == scaled[0]
    for k in plain[1]:
        np.testing.assert_array_equal(plain[1][k], scaled[1][k], err_msg=k)
    ref16 = _reference_run(jmake, arrays, batches, "sgd", kw, "bfloat16",
                           grad_scale=1024.0)
    ref32 = _reference_run(jmake, arrays, batches, "sgd", kw, None)
    _assert_within_reference_spread(scaled[:2], ref16, ref32, arrays)


def test_fused_step_dtype_arguments():
    """``dtype`` takes a name or a torch dtype and refuses a non-float
    one; ``batch_axis`` is the reference's keyword; ``mesh=`` still
    raises naming its queue item."""
    net = tbert.bert_small()
    opt = topt.create("sgd")
    assert FusedTrainStep(net, SoftmaxCrossEntropyLoss(), opt,
                          dtype=torch.bfloat16)._dtype == torch.bfloat16
    assert FusedTrainStep(net, SoftmaxCrossEntropyLoss(), opt,
                          batch_axis="dp", dtype="bfloat16")._dtype == \
        torch.bfloat16
    with pytest.raises(TypeError):
        FusedTrainStep(net, SoftmaxCrossEntropyLoss(), opt, dtype="int32")
    with pytest.raises(NotImplementedError, match="item 7"):
        FusedTrainStep(net, SoftmaxCrossEntropyLoss(), opt, mesh=object())


def _amp_step(pkg, arrays, x, y):
    """One legacy SGD step of ResNet-18 v1 (10 classes) from ``arrays``
    through ``pkg`` ("jax" or "torch"), under its ``amp`` when ``amp`` is
    initialized: → (per-sample losses, {name: array after})."""
    if pkg == "jax":
        net, _ = reference_net("resnet18_v1", seed=5, classes=10)
        for k, p in net.collect_params().items():
            p.set_data(mx.np.array(arrays[k])._data)
        tr = jgluon.Trainer(net.collect_params(), "sgd", dict(SGD))
        if jamp._state["initialized"]:
            jamp.init_trainer(tr)
        with mx.autograd.record():
            loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
                net(mx.np.array(x)), mx.np.array(y))
        if jamp._state["initialized"]:
            with jamp.scale_loss(loss, tr) as scaled:
                scaled.backward()
        else:
            loss.backward()
        tr.step(x.shape[0])
        return np.asarray(loss._data), {
            k: np.asarray(p.data()._data)
            for k, p in net.collect_params().items()}
    net = port_net("resnet18_v1", arrays, classes=10)
    net.train()
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    amp.init_trainer(tr)
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(torch.from_numpy(x)),
                                         torch.from_numpy(y))
    with amp.scale_loss(loss, tr) as scaled:
        scaled.backward(torch.ones_like(scaled))
    tr.step(x.shape[0])
    return loss.detach().numpy(), {k: t.detach().numpy() for k, t in
                                   net.collect_params().items()}


def test_legacy_amp_step_of_resnet18_matches_reference():
    """One SGD step (momentum 0.9, wd 1e-4) of ResNet-18 v1 at 48x48,
    batch 2, under ``amp.init("bfloat16")`` with ``init_trainer`` and
    ``scale_loss`` on both sides: the patched convs and dense take bf16
    operands and return fp32 (the 3x3/s1 convs on the lone conv route,
    now open to bf16), so the BatchNorms normalize fp32 activations.
    The port's weights and running statistics after the step within the
    reference's own distance between its amp step and its fp32 step; its
    per-sample losses within that distance or one bf16 step of the loss,
    whichever is larger: the logits leave the patched dense rounded to
    bf16, and the two packages' roundings fall on fp32 sums taken in
    another order, so their logits differ by a step or two (at this seed
    the losses 0.0071 apart, the reference's amp and fp32 losses 0.0035,
    one step of the loss 0.0156; the weights 0.0021 apart against the
    reference's 0.0038)."""
    arrays = _resnet_arrays()
    x, y = _resnet_batches()[0]
    ref32 = _amp_step("jax", arrays, x, y)
    jamp.init("bfloat16")
    amp.init("bfloat16")
    try:
        ref16 = _amp_step("jax", arrays, x, y)
        port = _amp_step("torch", arrays, x, y)
    finally:
        amp.deinit()
        jamp.deinit()
    assert all(a.dtype == np.float32 and np.isfinite(a).all()
               for a in port[1].values())
    assert np.isfinite(port[0]).all()
    d_port, d_ref = _dist(port, ref16), _dist(ref16, ref32)
    assert max(np.abs(port[1][k] - arrays[k]).max() for k in arrays) > 0
    assert d_port[1] <= d_ref[1], ("weights", d_port, d_ref)
    loss_step = 2.0 ** (np.floor(np.log2(np.abs(ref16[0]).max())) - 7)
    assert d_port[0] <= max(d_ref[0], loss_step), ("losses", d_port, d_ref)
