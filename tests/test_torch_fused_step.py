"""The port's fused training step (``Trainer.fuse_step``,
``parallel.FusedTrainStep``) on the CPU, where the step function runs
directly (on the card it is one captured CUDA graph; ``chip_smoke.py``
holds replay against eager there).  The port of
``tests/test_fused_step.py``: the fused step equals the legacy
record/backward/step path bit for bit for every optimizer and under an
lr schedule, interleaves with it, consumes the gradients, falls back
with the reference's reasons and counters, rebuilds on a new batch size,
keeps the ``fused.*`` telemetry, resyncs its step count on
``load_states`` and gives an unused parameter a zero gradient.  Then
the port's ``fuse_step`` against the JAX package's on the same numpy
weights: a hybridized Dense net, ResNet-18 v1 at 48x48 batch 2 (the
damped-residual init of ``test_torch_resnet``) and ``bert_small``, each
with its tolerance stated where it is checked."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu_torch import autograd, telemetry  # noqa: E402
from mxnet_tpu_torch import lr_scheduler as tsched  # noqa: E402
from mxnet_tpu_torch import optimizer as topt  # noqa: E402
from mxnet_tpu_torch.gluon import Trainer, load_numpy, nn  # noqa: E402
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss  # noqa
from mxnet_tpu_torch.parallel import FusedTrainStep  # noqa: E402

torch.set_num_threads(1)

B, D, C = 8, 6, 4

# every registered rule (RMSProp plain and centered, SGD with and
# without momentum): 20 cases over the 18 names, then LAMB under a
# PolyScheduler
OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-2, "wd": 1e-3}),
    ("adamw", {"learning_rate": 1e-2, "wd": 1e-2}),
    ("adamax", {}),
    ("nadam", {"learning_rate": 1e-2}),
    ("adagrad", {"wd": 1e-3}),
    ("adadelta", {}),
    ("adabelief", {"learning_rate": 1e-2}),
    ("rmsprop", {}),
    ("rmsprop", {"centered": True, "clip_gradient": 0.5}),
    ("ftrl", {}),
    ("ftml", {}),
    ("lamb", {"wd": 1e-2}),
    ("lars", {"wd": 1e-3}),
    ("lans", {}),
    ("signum", {"wd_lh": 1e-3}),
    ("sgld", {"learning_rate": 1e-3}),
    ("dcasgd", {"momentum": 0.9}),
    ("lamb", {"lr_scheduler": tsched.PolyScheduler(max_update=10,
                                                   base_lr=0.02),
              "wd": 1e-2}),
]


def _case_id(v):
    """A case's id, the same in every worker (a scheduler by its name)."""
    if isinstance(v, dict):
        return str({k: type(x).__name__ if isinstance(x, tsched.LRScheduler)
                    else x for k, x in v.items()})
    return str(v)


def _net(seed=0):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(C))
    net.initialize(ctx="cpu", seed=seed)
    net.hybridize()
    return net


def _batch(seed=0, n=B):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(n, D).astype(np.float32)),
            torch.from_numpy(rs.randint(0, C, (n,))))


def _twins():
    """Two nets holding the same weights (deferred shapes resolved)."""
    x, _ = _batch()
    a, b = _net(0), _net(1)
    a(x)
    b(x)
    load_numpy(b, {k: t.detach().numpy()
                   for k, t in a.collect_params().items()})
    return a, b


def _weights(net):
    return [t.detach().numpy().copy() for t in net.collect_params().values()]


def _legacy(net, trainer, loss_fn, x, y):
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward(torch.ones_like(loss))
    trainer.step(int(x.shape[0]))
    return loss.detach().mean()


def _counter(name):
    return telemetry.raw_snapshot()["counters"].get(name, 0)


# ---------------------------------------------------------- bit for bit
@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=_case_id)
def test_fused_matches_legacy_bitwise(name, kw):
    """Losses and every weight after 5 steps equal bit for bit: the same
    rule reads the same control numbers, and the gradients of the summed
    loss are the legacy backward's."""
    loss_fn = SoftmaxCrossEntropyLoss()
    net_l, net_f = _twins()
    tr_l = Trainer(net_l.collect_params(), name, dict(kw))
    tr_f = Trainer(net_f.collect_params(), name, dict(kw))
    step = tr_f.fuse_step(loss_fn)
    for i in range(5):
        x, y = _batch(seed=i)
        ll = _legacy(net_l, tr_l, loss_fn, x, y)
        lf = step(x, y)
        assert torch.equal(ll, lf), (i, ll, lf)
    assert step.fused, step.fallback_reason
    for a, b in zip(_weights(net_l), _weights(net_f)):
        np.testing.assert_array_equal(a, b)
    for k, st in tr_l._states.items():
        for s in st:
            assert torch.equal(st[s], tr_f._states[k][s]), (k, s)
    assert tr_l.optimizer.num_update == tr_f.optimizer.num_update == 5


def test_fused_with_lr_scheduler_matches_legacy():
    """The schedule is read after num_update advances, on both paths;
    the learning rate reaches the rule through the control tensor, so a
    changing schedule needs no new program."""
    loss_fn = SoftmaxCrossEntropyLoss()
    net_l, net_f = _twins()

    def mk():
        return {"lr_scheduler": tsched.FactorScheduler(step=2, factor=0.5,
                                                       base_lr=0.1),
                "momentum": 0.9}
    tr_l = Trainer(net_l.collect_params(), "sgd", mk())
    tr_f = Trainer(net_f.collect_params(), "sgd", mk())
    step = tr_f.fuse_step(loss_fn)
    r0 = _counter("fused.rebuilds")
    for i in range(6):
        x, y = _batch(seed=i)
        _legacy(net_l, tr_l, loss_fn, x, y)
        step(x, y)
    assert step.fused and _counter("fused.rebuilds") == r0
    assert step.programs == 1
    assert tr_l.learning_rate == tr_f.learning_rate == 0.0125
    for a, b in zip(_weights(net_l), _weights(net_f)):
        np.testing.assert_array_equal(a, b)


def test_fused_interleaves_with_legacy_steps():
    """Fused and legacy steps share num_update, states and weights: the
    run equals an all-legacy run bit for bit."""
    loss_fn = SoftmaxCrossEntropyLoss()
    net_l, net_f = _twins()
    kw = {"learning_rate": 0.05, "momentum": 0.9}
    tr_l = Trainer(net_l.collect_params(), "sgd", kw)
    tr_f = Trainer(net_f.collect_params(), "sgd", kw)
    step = tr_f.fuse_step(loss_fn)
    for i, fused in enumerate((True, False, True, True, False)):
        x, y = _batch(seed=i)
        _legacy(net_l, tr_l, loss_fn, x, y)
        if fused:
            step(x, y)
        else:
            _legacy(net_f, tr_f, loss_fn, x, y)
        assert tr_f.optimizer.num_update == i + 1
    for a, b in zip(_weights(net_l), _weights(net_f)):
        np.testing.assert_array_equal(a, b)


def test_fused_step_consumes_grads():
    """A fused step counts as backward + step: gradients a legacy
    backward left are consumed, so a following trainer.step raises the
    stale-gradient warning instead of applying them again."""
    loss_fn = SoftmaxCrossEntropyLoss()
    net, _ = _twins()
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    step = tr.fuse_step(loss_fn)
    x, y = _batch()
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward(torch.ones_like(loss))
    step(x, y)
    assert all(p.grad is None for _, p in tr._trainable)
    with pytest.raises(UserWarning):
        tr.step(B)
    tr.step(B, ignore_stale_grad=True)


def test_fused_train_step_matches_a_mean_loss_step():
    """``FusedTrainStep`` takes the gradients of the MEAN loss (the
    optimizer's rescale_grad left at 1), as the reference's does."""
    loss_fn = SoftmaxCrossEntropyLoss()
    net_l, net_f = _twins()
    opt_l = topt.create("adam", learning_rate=1e-2)
    opt_f = topt.create("adam", learning_rate=1e-2)
    step = FusedTrainStep(net_f, loss_fn, opt_f)
    params = [p for p in net_l.collect_params().values()]
    states = [opt_l.create_state(i, p) for i, p in enumerate(params)]
    for i in range(3):
        x, y = _batch(seed=i)
        with autograd.record():
            loss = loss_fn(net_l(x), y).mean()
        grads = torch.autograd.grad(loss, params)
        opt_l.update_multi(list(range(len(params))),
                           [p.data for p in params], grads, states)
        assert torch.equal(step(x, y), loss.detach())
    for a, b in zip(_weights(net_l), _weights(net_f)):
        np.testing.assert_array_equal(a, b)
    assert opt_f.num_update == 3 and opt_f.rescale_grad == 1.0


@pytest.mark.parametrize("kw,what", [({"dtype": "bfloat16"}, None),
                                     ({"mesh": object()}, "item 7")])
def test_fused_train_step_refuses_what_later_items_bring(kw, what):
    """``mesh=`` (Queue 1 item 7) still raises; ``dtype="bfloat16"`` (item
    3b, once refused here) now builds a mixed-precision step whose loss is
    finite and whose fp32 master weights move."""
    if what is not None:
        with pytest.raises(NotImplementedError, match=what):
            FusedTrainStep(_net(), SoftmaxCrossEntropyLoss(),
                           topt.create("sgd"), **kw)
        return
    net = _net()
    x, y = _batch()
    net(x)
    before = _weights(net)
    step = FusedTrainStep(net, SoftmaxCrossEntropyLoss(),
                          topt.create("sgd", learning_rate=0.1), **kw)
    assert np.isfinite(float(step(x, y)))
    after = _weights(net)
    assert all(a.dtype == np.float32 for a in after)
    assert any((a != b).any() for a, b in zip(after, before))


# ------------------------------------------------------------ fallbacks
def _fallback_run(tr, reason):
    step = tr.fuse_step(SoftmaxCrossEntropyLoss())
    assert not step.fused and step.fallback_reason == reason
    f0, r0 = _counter("fused.fallbacks"), _counter(f"fused.fallback.{reason}")
    x, y = _batch()
    loss = step(x, y)
    assert torch.isfinite(loss) and tr.optimizer.num_update == 1
    assert _counter("fused.fallbacks") == f0 + 1
    assert _counter(f"fused.fallback.{reason}") == r0 + 1
    return step


def test_fallback_env_disabled(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    net, _ = _twins()
    _fallback_run(Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}), "disabled")


def test_fallback_not_hybridized_and_the_switch_that_forces(monkeypatch):
    monkeypatch.delenv("MXNET_FUSED_STEP", raising=False)
    net, _ = _twins()
    net.hybridize(False)
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    _fallback_run(tr, "not_hybridized")
    monkeypatch.setenv("MXNET_FUSED_STEP", "1")
    step = tr.fuse_step(SoftmaxCrossEntropyLoss())
    assert step.fused, step.fallback_reason
    w0 = _weights(net)
    step(*_batch())
    assert any(not np.array_equal(a, b) for a, b in zip(w0, _weights(net)))


def test_fallback_update_on_kvstore():
    """The port's Trainer refuses ``update_on_kvstore=True`` when it is
    built; a Trainer whose flag is set after construction routes every
    fused call through the legacy step."""
    net, _ = _twins()
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    tr._update_on_kvstore = True
    _fallback_run(tr, "update_on_kvstore")


def test_fallback_no_net_counts_then_raises():
    net, _ = _twins()
    tr = Trainer(list(net.collect_params().values()), "sgd",
                 {"learning_rate": 0.1})
    step = tr.fuse_step(SoftmaxCrossEntropyLoss())
    assert step.fallback_reason == "no_net"
    r0 = _counter("fused.fallback.no_net")
    with pytest.raises(ValueError, match="net="):
        step(*_batch())
    assert _counter("fused.fallback.no_net") == r0 + 1
    assert tr.fuse_step(SoftmaxCrossEntropyLoss(), net=net).fused


def test_fallback_not_hybrid_block_and_params_mismatch():
    class Plain(nn.Block):
        def __init__(self):
            super().__init__()
            self.dense = nn.Dense(C)

        def forward(self, x):
            return self.dense(x)

    plain = Plain()
    plain.initialize(ctx="cpu")
    plain(_batch()[0])
    tr = Trainer(plain.collect_params(), "sgd", {"learning_rate": 0.1})
    _fallback_run(tr, "not_hybrid_block")

    net, other = _twins()
    params = dict(net.collect_params())
    params["extra.weight"] = other.collect_params()["0.weight"]
    tr = Trainer(params, "sgd", {"learning_rate": 0.1})
    step = tr.fuse_step(SoftmaxCrossEntropyLoss(), net=net)
    assert step.fused
    with pytest.raises(UserWarning):          # the legacy path's stale rule
        step(*_batch())
    assert step.fallback_reason == "params_mismatch"


def test_fallback_sparse_param():
    net, _ = _twins()
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    tr._trainable[0][1].grad_stype = "row_sparse"
    try:
        step = tr.fuse_step(SoftmaxCrossEntropyLoss())
        assert step.fallback_reason == "sparse_param"
    finally:
        del tr._trainable[0][1].grad_stype


# ---------------------------------------------------- rebuilds, telemetry
def test_batch_size_change_rebuilds_program():
    """``rescale_grad`` is a constant of the captured rule: a new batch
    size is a new program (counted), and going back reuses the first."""
    net, _ = _twins()
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    step = tr.fuse_step(SoftmaxCrossEntropyLoss())
    step(*_batch())
    r0 = _counter("fused.rebuilds")
    step(*_batch(seed=7, n=B // 2))
    assert _counter("fused.rebuilds") == r0 + 1
    step(*_batch(seed=8))
    assert _counter("fused.rebuilds") == r0 + 1 and step.programs == 2


def test_telemetry_fused_section():
    net, _ = _twins()
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    step = tr.fuse_step(SoftmaxCrossEntropyLoss())
    s0, d0 = _counter("fused.steps"), _counter("fused.dispatches")
    g0 = telemetry.raw_snapshot()["gauges"].get("fused.programs", 0)
    h0 = telemetry.raw_snapshot()["histograms"].get(
        "fused.step_us", {}).get("count", 0)
    step(*_batch())
    step(*_batch(seed=1))
    snap = telemetry.raw_snapshot()
    assert _counter("fused.steps") == s0 + 2
    assert _counter("fused.dispatches") == d0 + 2
    assert snap["gauges"]["fused.programs"] == g0 + 1
    assert snap["histograms"]["fused.step_us"]["count"] == h0 + 2


def test_load_states_resyncs_the_step_count(tmp_path):
    """Adam's bias correction follows the restored count: after loading
    the states and weights of step 1, the next fused step lands where
    step 2 first did, bit for bit."""
    loss_fn = SoftmaxCrossEntropyLoss()
    net, _ = _twins()
    tr = Trainer(net.collect_params(), "adam", {"learning_rate": 1e-2})
    step = tr.fuse_step(loss_fn)
    step(*_batch(seed=0))
    path = str(tmp_path / "t.states")
    tr.save_states(path)
    w1 = {k: t.detach().numpy().copy()
          for k, t in net.collect_params().items()}
    step(*_batch(seed=1))
    w2 = _weights(net)
    step(*_batch(seed=2))
    tr.load_states(path)
    load_numpy(net, w1)
    assert tr.optimizer.num_update == 1
    step(*_batch(seed=1))
    assert tr.optimizer.num_update == 2
    for a, b in zip(w2, _weights(net)):
        np.testing.assert_array_equal(a, b)


def test_unused_parameter_gets_a_zero_gradient():
    """A trainable parameter the forward does not use takes the rule with
    a zero gradient (weight decay still applies); the legacy path raises
    for it."""
    class Half(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.used = nn.Dense(C, in_units=D)
            self.unused = nn.Dense(C, in_units=D)

        def forward(self, x):
            return self.used(x)

    net = Half()
    net.initialize(ctx="cpu")
    net.hybridize()
    tr = Trainer(net.collect_params(), "sgd",
                 {"learning_rate": 0.1, "wd": 0.5})
    w0 = net.unused.weight.detach().clone()
    tr.fuse_step(SoftmaxCrossEntropyLoss())(*_batch())
    lr, wd = np.float32(0.1), np.float32(0.5)
    want = w0.numpy() - lr * (np.float32(0) + wd * w0.numpy())
    np.testing.assert_array_equal(net.unused.weight.detach().numpy(), want)
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(_batch()[0]), _batch()[1])
    loss.backward(torch.ones_like(loss))
    with pytest.raises(UserWarning, match="unused"):
        tr.step(B)


def test_collect_params_carries_its_block():
    net = _net()
    pd = net.collect_params()
    assert pd._block_ref() is net
    assert Trainer(pd, "sgd")._net() is net
    assert net.collect_params("0.*")._block_ref() is net


# ------------------------------------------------- against the JAX package
def _jax_dense(arrays):
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(16, activation="relu"), jnn.Dense(C))
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1, D), np.float32)))
    for k, p in jnet.collect_params().items():
        p.set_data(jnp.asarray(arrays[k]))
    jnet.hybridize()
    return jnet


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 1e-2}),
    ("lamb", {"learning_rate": 1e-2, "wd": 1e-2}),
])
def test_dense_fuse_step_matches_the_jax_package(name, kw):
    """Three fused steps of each package from the same numpy weights and
    batches: losses within 1e-6 relative, weights within 1e-6 absolute
    (fp32 values of order 1; the reference's one XLA program contracts
    multiplies and adds, the port rounds each operation)."""
    net, _ = _twins()
    arrays = {k: t.detach().numpy().copy()
              for k, t in net.collect_params().items()}
    jnet = _jax_dense(arrays)
    jstep = jgluon.Trainer(jnet.collect_params(), name, dict(kw)).fuse_step(
        jgluon.loss.SoftmaxCrossEntropyLoss())
    step = Trainer(net.collect_params(), name, dict(kw)).fuse_step(
        SoftmaxCrossEntropyLoss())
    for i in range(3):
        x, y = _batch(seed=i)
        jl = float(jstep(mx.np.array(x.numpy()), mx.np.array(y.numpy())))
        tl = float(step(x, y))
        assert abs(tl - jl) <= 1e-6 * abs(jl), (i, tl, jl)
    assert jstep.fused and step.fused
    for k, p in jnet.collect_params().items():
        np.testing.assert_allclose(
            net.collect_params()[k].detach().numpy(),
            np.asarray(p.data()._data), rtol=0, atol=1e-6, err_msg=k)


def test_resnet18_fuse_step_matches_the_jax_package():
    """ResNet-18 v1 at 48x48 (``test_torch_resnet``'s training item),
    batch 2, SGD (momentum 0.9, wd 1e-4), two fused steps of each package
    from the same weights (each residual branch's last BN γ damped by
    0.1, as ``test_torch_resnet`` damps it): losses within 1e-4 relative,
    each parameter's two-step update within 1e-2 of the largest update in
    the net, running statistics within 1e-4
    (``test_torch_resnet.assert_two_steps_match``).  Not at 32x32: there
    the last stage is 1x1, its BatchNorms normalize two values each, and
    the JAX package's own legacy and fused steps give second-step losses
    1.4% apart (2.4297 and 2.4638), so no fp32 pair can be held
    there."""
    from test_torch_resnet import (TRAIN_ITEM, TRAIN_LR,
                                   assert_two_steps_match, port_net,
                                   reference_net)
    jnet, arrays = reference_net("resnet18_v1", seed=5, classes=10)
    params = jnet.collect_params()
    for k, p in params.items():
        if k.endswith(".body.4.gamma"):
            arrays[k] = (0.1 * arrays[k]).astype(np.float32)
            p.set_data(jnp.asarray(arrays[k]))
    jnet.hybridize()
    tnet = port_net("resnet18_v1", arrays, classes=10)
    tnet.hybridize()
    kw = {"learning_rate": TRAIN_LR, "momentum": 0.9, "wd": 1e-4}
    jstep = jgluon.Trainer(params, "sgd", kw).fuse_step(
        jgluon.loss.SoftmaxCrossEntropyLoss())
    step = Trainer(tnet.collect_params(), "sgd", kw).fuse_step(
        SoftmaxCrossEntropyLoss())
    rs = np.random.RandomState(6)
    jl, tl = [], []
    for _ in range(2):
        x = rs.rand(2, *TRAIN_ITEM).astype(np.float32)
        y = rs.randint(0, 10, (2,))
        jl.append(np.asarray(jstep(mx.np.array(x), mx.np.array(y))._data))
        tl.append(step(torch.from_numpy(x), torch.from_numpy(y)).numpy())
    assert jstep.fused and step.fused
    jafter = {k: np.asarray(p.data()._data) for k, p in params.items()}
    tafter = {k: t.detach().numpy()
              for k, t in tnet.collect_params().items()}
    assert_two_steps_match(jl, tl, arrays, jafter, tafter)


def test_bert_small_fuse_step_matches_the_jax_package():
    """``bert_small`` masked-LM training, SGD (lr 0.05, momentum 0.9), two
    fused steps of each package on (2, 16) tokens from the same weights:
    losses within 1e-5 relative, each parameter after the steps within
    1e-3 of the largest update in the net of the reference's.  SGD, not
    the BERT row's Adam: the key projection's bias has a gradient of
    zero up to rounding (the softmax ignores a constant added to a row
    of scores), which Adam scales up to ±lr whatever its sign, so no two
    fp32 implementations agree there; Adam's rule is held by
    ``test_torch_optimizer_zoo`` and the Dense case above."""
    from mxnet_tpu.models import bert_gluon as jbert
    from mxnet_tpu_torch.models import bert_gluon as tbert
    from test_torch_bert_gluon import bert_weights
    rs = np.random.RandomState(9)
    tokens = [rs.randint(0, 1000, (2, 16)).astype(np.int32)
              for _ in range(2)]
    labels = [rs.randint(0, 1000, (2, 16)).astype(np.int32)
              for _ in range(2)]
    jnet = jbert.bert_small()
    jnet.initialize()
    jnet(mx.np.array(tokens[0]))
    params = jnet.collect_params()
    arrays = bert_weights([(k, p.shape) for k, p in params.items()], 31)
    for k, p in params.items():
        p.set_data(jnp.asarray(arrays[k]))
    jnet.hybridize()
    tnet = tbert.bert_small()
    load_numpy(tnet, arrays)
    tnet.hybridize()
    kw = {"learning_rate": 0.05, "momentum": 0.9}
    jstep = jgluon.Trainer(params, "sgd", kw).fuse_step(
        jgluon.loss.SoftmaxCrossEntropyLoss())
    step = Trainer(tnet.collect_params(), "sgd", kw).fuse_step(
        SoftmaxCrossEntropyLoss())
    for t, lab in zip(tokens, labels):
        jl = float(jstep(mx.np.array(t), mx.np.array(lab)))
        tl = float(step(torch.from_numpy(t), torch.from_numpy(lab)))
        assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert jstep.fused and step.fused
    jafter = {k: np.asarray(p.data()._data) for k, p in params.items()}
    scale = max(np.abs(jafter[k] - arrays[k]).max() for k in jafter)
    for k, t in tnet.collect_params().items():
        err = np.abs(t.detach().numpy() - jafter[k]).max()
        assert err <= 1e-3 * scale, (k, err, scale)
