"""``mxnet_tpu_torch.amp`` against the JAX package's ``mx.amp`` on the CPU:
the cases of ``tests/test_amp_estimator.py``'s ``TestAMP`` (op patching,
an AMP training step, the loss scaler's dynamics, the overflow skip,
``convert_model``), each also held against the reference's numbers where
both compute: the patched Dense forward, one scaled SGD step, and a conv
net's forward under ``amp.init`` (the reference's layer route, its conv in
bf16)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import amp as jamp  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu.gluon import loss as jloss  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.models.resnet import BasicBlockV1 as JBasic  # noqa: E402
from mxnet_tpu_torch import amp  # noqa: E402
from mxnet_tpu_torch import autograd, gluon  # noqa: E402
from mxnet_tpu_torch.gluon import loss as tloss  # noqa: E402
from mxnet_tpu_torch.gluon import nn  # noqa: E402
from mxnet_tpu_torch.models.resnet import BasicBlockV1 as TBasic  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402
from test_torch_resnet import weights_for  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _deinit():
    yield
    amp.deinit()
    jamp.deinit()


def _make(gnn):
    net = gnn.HybridSequential()
    net.add(gnn.Dense(16, activation="relu"), gnn.Dense(4))
    return net


def _nets(seed=0):
    """The reference's two-layer Dense net and the port's, on the same
    weights."""
    jnet = _make(jgnn)
    jnet.initialize()
    jnet(mx.np.array(np.zeros((2, 6), np.float32)))
    rs = np.random.RandomState(seed)
    arrays = {k: (rs.randn(*p.shape) * 0.5).astype(np.float32)
              for k, p in jnet.collect_params().items()}
    for k, p in jnet.collect_params().items():
        p.set_data(mx.np.array(arrays[k])._data)
    tnet = _make(nn)
    gluon.load_numpy(tnet, arrays)
    return jnet, tnet


def _batch(seed=0, batch=8):
    rs = np.random.RandomState(seed)
    return (rs.rand(batch, 6).astype(np.float32),
            rs.randint(0, 4, (batch,)).astype(np.int32))


def test_init_casts_matmul_ops():
    amp.init("bfloat16")
    out = tnn.fully_connected(torch.ones(2, 4), torch.ones(3, 4))
    assert out.dtype == torch.float32
    assert hasattr(tnn.fully_connected, "__wrapped__")
    amp.init("float16")                     # a second call does nothing
    assert amp._state["target_dtype"] == torch.bfloat16
    amp.deinit()
    assert not hasattr(tnn.fully_connected, "__wrapped__")
    with pytest.raises(ValueError):
        amp.init("float32")


def test_init_forward_matches_reference():
    """The patched Dense ops compute in bf16 (product rounded, bias added
    in bf16) and hand back fp32, as the reference's do: equal."""
    jnet, tnet = _nets()
    x, _ = _batch()
    jamp.init("bfloat16")
    amp.init("bfloat16")
    ref = np.asarray(jnet(mx.np.array(x))._data)
    out = tnet(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.detach().numpy(), ref)


def test_training_with_amp_matches_reference():
    """One SGD step through ``init_trainer`` and ``scale_loss`` updates
    the parameters, and the reference's step on the same weights and
    batch gives the same update: within 1e-2 of its largest element (the
    backward's bf16 products round in another order in the two
    frameworks; an update of the wrong sign or size is 100% off)."""
    jnet, tnet = _nets(1)
    x, y = _batch(1)
    jamp.init("bfloat16")
    amp.init("bfloat16")
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         {"learning_rate": 0.1})
    ttr = gluon.Trainer(tnet.collect_params(), "sgd",
                        {"learning_rate": 0.1})
    jamp.init_trainer(jtr)
    amp.init_trainer(ttr)
    j0 = {k: np.asarray(p.data()._data).copy()
          for k, p in jnet.collect_params().items()}
    with mx.autograd.record():
        jl = jloss.SoftmaxCrossEntropyLoss()(jnet(mx.np.array(x)),
                                             mx.np.array(y))
    with jamp.scale_loss(jl, jtr) as scaled:
        scaled.backward()
    jtr.step(x.shape[0])
    # the port's per-sample loss: backward of its sum over the batch, as
    # the reference's loss.backward() does
    with autograd.record():
        tl = tloss.SoftmaxCrossEntropyLoss()(tnet(torch.from_numpy(x)),
                                             torch.from_numpy(y))
    with amp.scale_loss(tl, ttr) as scaled:
        scaled.backward(torch.ones_like(scaled))
    ttr.step(x.shape[0])
    for k, p in jnet.collect_params().items():
        ref = np.asarray(p.data()._data) - j0[k]
        got = tnet.collect_params()[k].detach().numpy() - j0[k]
        assert np.abs(ref).max() > 0 and np.abs(got).max() > 0
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max(), k


def test_loss_scaler_dynamics():
    s = amp.LossScaler(init_scale=1024.0, scale_window=2)
    assert not s.has_overflow([torch.ones(3)])
    assert s.has_overflow([torch.tensor([1.0, float("inf")])])
    assert s.has_overflow([torch.ones(2), torch.tensor([float("nan")])])
    assert not s.has_overflow([])
    s.update_scale(True)
    assert s.loss_scale == 512.0
    s.update_scale(False)
    s.update_scale(False)
    assert s.loss_scale == 1024.0
    floor = amp.LossScaler(init_scale=1.0)
    floor.update_scale(True)
    assert floor.loss_scale == 1.0


def test_overflow_skips_step():
    amp.init("float16")
    _, net = _nets(2)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    amp.init_trainer(tr)
    assert tr._amp_loss_scaler.loss_scale == 2.0 ** 16
    x = torch.from_numpy(_batch(2)[0])
    before = [t.detach().clone() for t in net.collect_params().values()]
    with autograd.record():
        bad = net(x) * float("inf")
    bad.sum().backward()
    scale = tr._amp_loss_scaler.loss_scale
    tr.step(x.shape[0])                     # must skip: grads are inf
    for b, t in zip(before, net.collect_params().values()):
        assert torch.equal(b, t) and t.grad is None
    assert tr._amp_loss_scaler.loss_scale < scale
    assert amp.init_trainer(tr) is tr       # a second call changes nothing


def test_scale_loss_and_unscale():
    """``scale_loss`` multiplies by the scale and sets the trainer's
    rescale to its inverse; ``unscale`` divides the gradients instead."""
    amp.init("bfloat16")
    _, net = _nets(3)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    amp.init_trainer(tr)
    assert tr._amp_loss_scaler.loss_scale == 1.0
    tr._amp_loss_scaler.loss_scale = 8.0
    x = torch.from_numpy(_batch(3)[0])
    with autograd.record():
        out = net(x).sum()
    with amp.scale_loss([out, out * 2], tr) as scaled:
        assert len(scaled) == 2
        assert float(scaled[0]) == float(out) * 8.0
        scaled[0].backward()
    assert tr._scale == 0.125
    g = net[1].weight.grad.clone()
    amp.unscale(tr)
    assert tr._scale == 1.0
    torch.testing.assert_close(net[1].weight.grad, g * 0.125)


def test_convert_model():
    _, net = _nets(4)
    net(torch.zeros(2, 6))
    assert amp.convert_model(net, "bfloat16") is net
    assert amp.convert_hybrid_block is amp.convert_model
    for t in net.collect_params().values():
        assert t.dtype == torch.bfloat16


def test_conv_net_under_init_matches_reference():
    """Under ``amp.init`` the patched conv reaches the fused segments
    too: the reference's ``residual_block`` takes its layer route, whose
    conv is the patched one (bf16 in, fp32 out) followed by an fp32
    BatchNorm; the port's does the same.  Logits within 1e-5 of the
    largest (fp32 sums in another order; equal in practice), where the
    port's fused fp32 segment without the patched conv is 1.7-2.3e-3
    away."""
    def tiny(gnn, basic):
        net = gnn.HybridSequential()
        net.add(gnn.Conv2D(8, 3, padding=1, use_bias=False),
                gnn.BatchNorm(), gnn.Activation("relu"), basic(8, 1),
                gnn.GlobalAvgPool2D(), gnn.Flatten(), gnn.Dense(4))
        return net

    jnet = tiny(jgnn, JBasic)
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1, 8, 8, 3), np.float32)))
    params = jnet.collect_params()
    arrays = weights_for([(k, p.shape) for k, p in params.items()], 5)
    for k, p in params.items():
        p.set_data(mx.np.array(arrays[k])._data)
    tnet = tiny(nn, TBasic)
    gluon.load_numpy(tnet, arrays)
    x = np.random.RandomState(5).randn(2, 8, 8, 3).astype(np.float32)
    jamp.init("bfloat16")
    amp.init("bfloat16")
    ref = np.asarray(jnet(mx.np.array(x))._data)
    with torch.inference_mode():
        out = tnet(torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    assert (out.argmax(-1) == ref.argmax(-1)).all()
