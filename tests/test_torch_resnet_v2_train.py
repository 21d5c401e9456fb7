"""The standalone 3x3/s1 conv route (``ops/pallas_conv.py``) and ResNet v2
training through it, against the JAX package on the CPU.

``Conv3x3Fn`` (the plain versions of ``conv3x3`` and ``conv_wgrad`` on
the CPU) against the reference's ``pallas_conv.conv3x3_s1`` run as
``tests/test_pallas_conv.py`` runs it (its Pallas kernels in interpret
mode), forward and both gradients; the eligibility rule; which convs
``ops.nn.convolution`` sends to the route (ResNet-50 v2: 13 a forward,
13 dgrad and 13 wgrad a step, the counts ``chip_smoke.py v2_train``
gates on the card); and two SGD-momentum steps of ResNet-18 v2 against
the reference with ``MXNET_TPU_PALLAS_CONV=1``, which routes its
eligible convs through ``conv3x3_s1``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu.ops import pallas_conv as jpc  # noqa: E402
from mxnet_tpu_torch import autograd as tautograd  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import models as tmodels  # noqa: E402
from mxnet_tpu_torch.ops import conv_block  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402
from mxnet_tpu_torch.ops import pallas_conv as tpc  # noqa: E402
from test_torch_resnet import port_net, reference_net  # noqa: E402

torch.set_num_threads(1)

CONV_RTOL = 1e-4    # of each tensor's largest magnitude: 9·C sums in
                    # another order


def _close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert np.isfinite(out).all(), what
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())


@pytest.mark.parametrize("shape,cout", [((2, 8, 8, 16), 16),
                                        ((1, 14, 14, 32), 16),
                                        ((2, 7, 9, 8), 24)])
def test_conv3x3_fn_matches_reference_pallas_conv(shape, cout):
    """Forward, dx and dW of ``Conv3x3Fn`` against the reference's
    custom-VJP ``conv3x3_s1`` (interpret mode) under one random
    cotangent."""
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    w = rs.randn(3, 3, shape[-1], cout).astype(np.float32)
    g = rs.randn(*shape[:3], cout).astype(np.float32)
    ref, vjp = jax.vjp(jpc.conv3x3_s1, jnp.asarray(x), jnp.asarray(w))
    rdx, rdw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tpc.conv3x3_s1(xt, wt)
    out.backward(torch.from_numpy(g))
    _close(out.detach().numpy(), ref, CONV_RTOL, "out")
    _close(xt.grad.numpy(), rdx, CONV_RTOL, "dx")
    _close(wt.grad.numpy(), rdw, CONV_RTOL, "dw")


def test_conv3x3_fn_takes_a_channels_last_view_and_one_gradient(
        monkeypatch):
    """A non-contiguous input (an NHWC view of NCHW memory) is made
    contiguous before the kernel; with only dW wanted no dgrad runs."""
    rs = np.random.RandomState(1)
    xc = torch.from_numpy(rs.randn(2, 4, 6, 6).astype(np.float32))
    x = xc.permute(0, 2, 3, 1)
    assert not x.is_contiguous()
    w = torch.from_numpy(rs.randn(3, 3, 4, 5).astype(np.float32))
    w.requires_grad_()
    out = tpc.conv3x3_s1(x, w)
    torch.testing.assert_close(out, conv_block.conv3x3_plain(
        x.contiguous(), w.detach()), rtol=0, atol=0)
    calls = _count_route(monkeypatch)
    out.sum().backward()
    assert calls == {"conv3x3": 0, "conv_wgrad": 1}
    torch.testing.assert_close(w.grad, conv_block.conv_wgrad_plain(
        x.contiguous(), torch.ones_like(out)), rtol=0, atol=0)


@pytest.mark.parametrize("x_shape,w_shape,kw,dtype,ok", [
    ((2, 8, 8, 16), (3, 3, 16, 8), {}, torch.float32, True),
    ((2, 8, 8, 16), (3, 3, 16, 8), {"stride": 2}, torch.float32, False),
    ((2, 8, 8, 16), (3, 3, 16, 8), {"pad": 0}, torch.float32, False),
    ((2, 8, 8, 16), (3, 3, 16, 8), {"dilate": 2}, torch.float32, False),
    ((2, 8, 8, 16), (3, 3, 8, 8), {"groups": 2}, torch.float32, False),
    ((2, 8, 8, 16), (5, 5, 16, 8), {}, torch.float32, False),
    ((2, 8, 8, 16), (3, 3, 16, 8), {}, torch.bfloat16, False),
    ((2, 8, 8, 16), (1, 1, 16, 8), {}, torch.float32, False),
])
def test_eligible_takes_only_the_kernels_geometry(x_shape, w_shape, kw,
                                                  dtype, ok):
    args = dict(stride=1, pad=1, dilate=1, groups=1)
    args.update(kw)
    assert tpc.eligible(x_shape, w_shape, args["stride"], args["pad"],
                        args["dilate"], args["groups"], dtype) is ok


def _count_route(monkeypatch):
    """Count the calls ``pallas_conv`` makes to the two kernels'
    wrappers (on the CPU they take their plain versions)."""
    calls = {"conv3x3": 0, "conv_wgrad": 0}
    for name in calls:
        real = getattr(conv_block, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(conv_block, name, counted)
    return calls


def test_convolution_routes_eligible_convs_and_adds_the_bias(monkeypatch):
    calls = _count_route(monkeypatch)
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(2, 6, 5, 4).astype(np.float32))
    w = torch.from_numpy(rs.randn(3, 3, 4, 6).astype(np.float32))
    b = torch.from_numpy(rs.randn(6).astype(np.float32))
    out = tnn.convolution(x, w, b, stride=1, pad=1)
    assert calls["conv3x3"] == 1
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                      w.permute(3, 2, 0, 1), b, padding=1)
    torch.testing.assert_close(out, want.permute(0, 2, 3, 1), rtol=1e-5,
                               atol=1e-5)
    tnn.convolution(x, w, b, stride=2, pad=1)
    tnn.convolution(x.double(), w.double(), b.double(), stride=1, pad=1)
    assert calls["conv3x3"] == 1


@pytest.mark.parametrize("arch,convs", [("resnet50_v2", 13),
                                        ("resnet18_v2", 13)])
def test_resnet_v2_step_takes_the_route(arch, convs, monkeypatch):
    """One training step: every stride-1 3x3 conv goes through the route
    (ResNet-50 v2: 3, 3, 5 and 2 bottleneck convs at stages 1-4; the
    three strided ones stay on ``F.conv2d``), with a dgrad and a wgrad
    each in the backward."""
    calls = _count_route(monkeypatch)
    net = tmodels.get_model(arch, classes=10)
    net.initialize(ctx="cpu", seed=0)
    net.train()
    x = torch.from_numpy(np.random.RandomState(3).rand(
        1, 32, 32, 3).astype(np.float32))
    with tautograd.record():
        loss = tgluon.loss.SoftmaxCrossEntropyLoss()(net(x),
                                                     torch.tensor([1]))
    assert calls == {"conv3x3": convs, "conv_wgrad": 0}
    loss.backward(torch.ones_like(loss))
    assert calls == {"conv3x3": 2 * convs, "conv_wgrad": convs}


# ------------------------------------------------------ two SGD steps
V2_ITEM = (48, 48, 3)
V2_BATCH = 2
V2_LR = 0.01
V2_LOSS_RTOL = 1e-4     # of the step's largest per-sample loss
V2_PARAM_TOL = 1e-4     # of the largest two-step update in the net
V2_STATS_TOL = 1e-4     # of each running statistic's largest magnitude


def test_two_sgd_steps_of_resnet18_v2_match_reference_pallas_conv(
        monkeypatch):
    """Two steps of SGD (momentum 0.9, wd 1e-4, lr 0.01) on ResNet-18 v2
    at 48x48, batch 2, from the same numpy weights and batches: the
    reference routes its 13 stride-1 3x3 convs through ``conv3x3_s1``
    (``MXNET_TPU_PALLAS_CONV=1``, interpret mode), the port through
    ``Conv3x3Fn``.  Each residual branch's last BatchNorm γ (``bn2``)
    is scaled by 0.1, the damped-residual init ``test_torch_resnet``
    gives v1: undamped, the reference's own two routes (layer and
    ``conv3x3_s1``) land 0.7% and 1% of the largest update away from the
    port's float64 step while the port's float32 step is within 7.3e-6
    of it, so the comparison would measure the reference's rounding.
    Damped, the port is within 1.2e-5 of the reference."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_CONV", "1")
    routed = []
    real = jpc.conv3x3_s1
    monkeypatch.setattr(jpc, "conv3x3_s1",
                        lambda x, w: routed.append(x.shape) or real(x, w))
    calls = _count_route(monkeypatch)
    jnet, arrays = reference_net("resnet18_v2", seed=6, classes=10)
    params = jnet.collect_params()
    for k, p in params.items():
        if k.endswith(".bn2.gamma"):
            arrays[k] = (0.1 * arrays[k]).astype(np.float32)
            p.set_data(jnp.asarray(arrays[k]))
    tnet = port_net("resnet18_v2", arrays, classes=10)
    tnet.train()
    kw = {"learning_rate": V2_LR, "momentum": 0.9, "wd": 1e-4}
    jtr = jgluon.Trainer(params, "sgd", kw)
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", kw)
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss = tgluon.loss.SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(7)
    for _ in range(2):
        x = rs.rand(V2_BATCH, *V2_ITEM).astype(np.float32)
        y = rs.randint(0, 10, (V2_BATCH,))
        with mx.autograd.record():
            jl = jloss(jnet(mx.np.array(x)), mx.np.array(y))
        jl.backward()
        jtr.step(V2_BATCH)
        with tautograd.record():
            tl = tloss(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        tl.backward(torch.ones_like(tl))
        ttr.allreduce_grads()
        ttr.update(V2_BATCH)
        jl = np.asarray(jl._data)
        assert np.abs(tl.detach().numpy() - jl).max() <= \
            V2_LOSS_RTOL * np.abs(jl).max()
    assert len(routed) >= 13 and calls["conv_wgrad"] == 26
    jafter = {k: np.asarray(p.data()._data) for k, p in params.items()}
    tafter = {k: t.detach().numpy()
              for k, t in tnet.collect_params().items()}
    assert list(tafter) == list(jafter)
    keys = [k for k in jafter if "running_" not in k]
    scale = max(np.abs(jafter[k] - arrays[k]).max() for k in keys)
    for k, b in jafter.items():
        a = tafter[k]
        if "running_" in k:
            err, tol = np.abs(a - b).max(), V2_STATS_TOL * np.abs(b).max()
        else:
            err = np.abs((a - arrays[k]) - (b - arrays[k])).max()
            tol = V2_PARAM_TOL * scale
        assert err <= tol, (k, err, tol)
