"""One DenseNet-121 training step of the port against the JAX package's
on the CPU: SGD (lr 0.1, momentum 0.9, wd 1e-4) at batch 2, 64x64x3,
10 classes, from the same seeded numpy weights and batch, the forward in
training mode (BatchNorm on batch statistics) under ``record()``.  Its 58
3x3 growth convs run on the port's standalone conv route (``Conv3x3Fn``:
58 ``conv3x3`` forward, 58 dgrad, 58 ``conv_wgrad``).  The reference's
step is hybridized: one compiled forward and backward.

The inputs are standard normal and the stem BatchNorm's γ and each
dense layer's first BatchNorm γ (``body.0.gamma``) are scaled by 0.1,
as ``test_torch_resnet`` damps each residual branch: undamped at batch
2, the port's own float32 and float64 steps lie up to 1% of the largest
update apart (the reference's float32 step up to 3% from the port's
float64 one, on other tensors); damped, the port's two steps agree
within 2.4e-4.

Gates: per-sample losses within ``LOSS_RTOL`` of the largest; running
statistics (every BatchNorm's batch statistics) within ``STATS_RTOL``
of each one's largest magnitude; the port's float32 step within
``PARAM_TOL`` of the largest update from its float64 step on every
parameter; and every parameter's update within ``PARAM_TOL`` of the
reference's, except on tensors (at most ``EXCUSED_SHARE`` of them) where
the reference's own float32 step lies more than ``PARAM_TOL / 2`` from
the float64 step and farther than the port's (the stem conv, the
damped γs: the reference's float32 step lands up to 2e-3 of the largest
update away from the float64 step there)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu import models as jmodels  # noqa: E402
from mxnet_tpu_torch import autograd as tautograd  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import models as tmodels  # noqa: E402
from mxnet_tpu_torch.ops import conv_block  # noqa: E402
from test_torch_resnet import compiled_backward, weights_for  # noqa: E402

torch.set_num_threads(1)

ITEM = (64, 64, 3)
BATCH = 2
CLASSES = 10
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
LOSS_RTOL = 1e-4
STATS_RTOL = 1e-4
PARAM_TOL = 1e-3
DAMP = 0.1
EXCUSED_SHARE = 0.1


def _damped(k):
    return k == "features.1.gamma" or k.endswith(".body.0.gamma")


def _reference_step(x, y):
    net = jmodels.get_model("densenet121", classes=CLASSES)
    net.initialize(init=mx.init.Zero())
    net.hybridize()     # the shape-inferring forward: one program
    net(mx.np.array(np.zeros((BATCH,) + ITEM, np.float32)))
    params = net.collect_params()
    arrays = weights_for([(k, p.shape) for k, p in params.items()], 4)
    for k, p in params.items():
        if _damped(k):
            arrays[k] = (DAMP * arrays[k]).astype(np.float32)
        p.set_data(jnp.asarray(arrays[k]))
    net.hybridize()
    trainer = jgluon.Trainer(params, "sgd", SGD)
    with mx.autograd.record():
        loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
            net(mx.np.array(x)), mx.np.array(y))
    loss.backward()
    trainer.step(BATCH)
    return arrays, np.asarray(loss._data), {
        k: np.asarray(p.data()._data).astype(np.float64)
        for k, p in params.items()}


def _port_step(arrays, x, y, dtype):
    net = tmodels.get_model("densenet121", classes=CLASSES)
    tgluon.load_numpy(net, arrays)
    net.to(dtype)
    net.train()
    trainer = tgluon.Trainer(net.collect_params(), "sgd", SGD)
    with tautograd.record():
        loss = tgluon.loss.SoftmaxCrossEntropyLoss()(
            net(torch.from_numpy(x).to(dtype)), torch.from_numpy(y))
    loss.backward(torch.ones_like(loss))
    trainer.allreduce_grads()
    trainer.update(BATCH)
    return loss.detach().double().numpy(), {
        k: t.detach().double().numpy()
        for k, t in net.collect_params().items()}


def test_one_sgd_step_of_densenet121_matches_reference(monkeypatch):
    compiled_backward(monkeypatch)
    calls = {"conv3x3": 0, "conv_wgrad": 0}
    for name in calls:
        real = getattr(conv_block, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(conv_block, name, counted)
    rs = np.random.RandomState(5)
    x = rs.randn(BATCH, *ITEM).astype(np.float32)
    y = rs.randint(0, CLASSES, (BATCH,))
    arrays, jloss, ref = _reference_step(x, y)
    tloss, got = _port_step(arrays, x, y, torch.float32)
    assert calls == {"conv3x3": 116, "conv_wgrad": 58}
    _, exact = _port_step(arrays, x, y, torch.float64)
    assert list(got) == list(ref)
    assert np.abs(tloss - jloss).max() <= LOSS_RTOL * np.abs(jloss).max()
    keys = [k for k in ref if "running_" not in k]
    upd = max(np.abs(ref[k] - arrays[k]).max() for k in keys)
    tol = PARAM_TOL * upd
    bad = [k for k in ref if "running_" in k and np.abs(
        got[k] - ref[k]).max() > STATS_RTOL * np.abs(ref[k]).max()]
    excused = []
    for k in keys:
        ours = np.abs(got[k] - exact[k]).max()
        theirs = np.abs(ref[k] - exact[k]).max()
        if ours > tol:
            bad.append(k)
        elif np.abs(got[k] - ref[k]).max() > tol:
            if theirs > tol / 2 and ours < theirs:
                excused.append(k)
            else:
                bad.append(k)
    assert not bad, bad
    assert len(excused) <= EXCUSED_SHARE * len(keys), excused
