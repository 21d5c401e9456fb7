"""The PyTorch port's Gluon stack and ResNet zoo against the JAX package
on the CPU: parameter names, the ``.params`` format, the image ops, and
ResNet-18/50 logits on shared numpy weights — on the reference's default
(layer-by-layer) route and on its forced-Pallas route, whose fused
segments run the Pallas kernel in interpret mode.  On the CPU the
port's fused segments take ``conv_affine_plain``."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import models as jmodels  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.ops import nn as jnn  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import models as tmodels  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tgnn  # noqa: E402
from mxnet_tpu_torch.ops import conv_block  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402

torch.set_num_threads(1)

ITEM = (32, 32, 3)
TOL = 1e-4        # of the largest |logit|: fp32 sums in another order


def weights_for(names_shapes, seed):
    """Seeded numpy weights by name: He-scaled conv/dense weights,
    plausible frozen BN statistics (γ near 1, β and μ small, σ² in
    [0.5, 1.5]) that keep activations finite through deep nets."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in names_shapes:
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight":
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 \
                else shape[1]
            a = rs.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif leaf == "gamma":
            a = 1 + 0.1 * rs.randn(*shape)
        elif leaf == "running_var":
            a = rs.uniform(0.5, 1.5, shape)
        else:                           # beta, running_mean, bias
            a = 0.1 * rs.randn(*shape)
        out[name] = a.astype(np.float32)
    return out


def reference_net(arch, seed=0, hybridize=False, **kw):
    """The JAX package's net with seeded numpy weights, and the arrays;
    hybridized (before its shape-inferring forward) with ``hybridize``."""
    net = jmodels.get_model(arch, **kw)
    net.initialize()
    if hybridize:
        net.hybridize()
    net(mx.np.array(np.zeros((1,) + ITEM, np.float32)))   # deferred shapes
    params = net.collect_params()
    arrays = weights_for([(k, p.shape) for k, p in params.items()], seed)
    for k, p in params.items():
        p.set_data(jnp.asarray(arrays[k]))
    return net, arrays


def compiled_backward(monkeypatch):
    """Apply each vjp closure the reference's tape records as one
    compiled program, built once per closure structure and shapes,
    rather than transposing it op by op with a program a primitive and
    shape.  In fp32 the gradients are the same up to rounding."""
    from mxnet_tpu import tape
    apply = jax.jit(lambda vjp_fn, ct: vjp_fn(ct))
    real = tape.TapeNode.__init__

    def init(self, vjp_fn, *args, **kw):
        real(self, functools.partial(apply, vjp_fn), *args, **kw)
    monkeypatch.setattr(tape.TapeNode, "__init__", init)


def port_net(arch, arrays, **kw):
    net = tmodels.get_model(arch, **kw)
    tgluon.load_numpy(net, arrays)
    return net


def reference_logits(net, x):
    return np.asarray(net(mx.np.array(x))._data)


def _close(out, ref, tol=TOL):
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(3).randn(2, *ITEM).astype(np.float32)


# ----------------------------------------------------------------- names
@pytest.mark.parametrize("arch,count", [("resnet18_v1", 107),
                                        ("resnet50_v1", 267),
                                        ("resnet18_v2", None)])
def test_param_names_and_shapes_match_reference(arch, count):
    jnet, arrays = reference_net(arch, classes=10)
    tnet = port_net(arch, arrays, classes=10)
    got = {k: tuple(t.shape) for k, t in tnet.collect_params().items()}
    want = {k: tuple(p.shape) for k, p in jnet.collect_params().items()}
    assert got == want
    assert list(got) == list(want)          # same order too
    if count is not None:
        assert len(got) == count
    assert "output.weight" in got
    if arch == "resnet50_v1":
        assert "features.4.0.body.1.running_var" in got


# ----------------------------------------------------------------- logits
@pytest.mark.parametrize("arch", ["resnet18_v1", "resnet50_v1",
                                  "resnet18_v2"])
def test_logits_match_reference_layer_route(arch, image):
    jnet, arrays = reference_net(arch, seed=1, classes=10)
    tnet = port_net(arch, arrays, classes=10)
    with torch.inference_mode():
        out = tnet(torch.from_numpy(image)).numpy()
    ref = reference_logits(jnet, image)
    _close(out, ref)
    assert (out.argmax(-1) == ref.argmax(-1)).all()


def test_logits_match_reference_forced_pallas_route(image, monkeypatch):
    """ResNet-18 with every stage routed to the reference's fused Pallas
    pipeline (interpret mode; the 1x1x512 stage falls back on the TPU's
    VMEM gate, which computes the same function)."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
    monkeypatch.setenv(
        "MXNET_TPU_PALLAS_STAGES",
        "8x8x64=pallas,4x4x128=pallas,2x2x256=pallas,1x1x512=pallas")
    assert jgnn.fused_block_active()
    jnet, arrays = reference_net("resnet18_v1", seed=2, classes=10)
    tnet = port_net("resnet18_v1", arrays, classes=10)
    with torch.inference_mode():
        out = tnet(torch.from_numpy(image)).numpy()
    _close(out, reference_logits(jnet, image))


@pytest.mark.parametrize("arch,segments", [("resnet50_v1", 16),
                                           ("resnet18_v1", 13)])
def test_fused_segments_per_forward(arch, segments, monkeypatch):
    """ResNet-50: every bottleneck's 3x3 mid conv; ResNet-18: each 3x3
    tail, and each head but the three at stride 2."""
    calls = []
    real = conv_block.conv_affine

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(conv_block, "conv_affine", counted)
    net = tmodels.get_model(arch, classes=10)
    net.initialize(seed=0, ctx="cpu")
    with torch.inference_mode():
        net(torch.zeros((1,) + ITEM))
    assert len(calls) == segments


# ------------------------------------------------------- .params format
def test_reference_params_file_loads_into_port_and_back(image, tmp_path):
    jnet, _ = reference_net("resnet18_v1", seed=4, classes=10)
    path = str(tmp_path / "net.params")        # no ".npz" appended
    jnet.save_parameters(path)
    tnet = tmodels.get_model("resnet18_v1", classes=10)
    tnet.load_parameters(path)
    with torch.inference_mode():
        out = tnet(torch.from_numpy(image)).numpy()
    ref = reference_logits(jnet, image)
    _close(out, ref)
    # and what the port writes loads into the reference unchanged
    back = str(tmp_path / "port.params")
    tnet.save_parameters(back)
    jnet2 = jmodels.get_model("resnet18_v1", classes=10)
    jnet2.initialize()
    jnet2.load_parameters(back)
    np.testing.assert_array_equal(reference_logits(jnet2, image), ref)


def test_load_numpy_checks_names_and_shapes():
    arrays = weights_for([("weight", (4, 6)), ("bias", (4,))], 0)
    net = tgnn.Dense(4)                       # in_units deferred
    tgluon.load_numpy(net, arrays)
    assert tuple(net.weight.shape) == (4, 6)
    with pytest.raises(KeyError):
        tgluon.load_numpy(tgnn.Dense(4), {"weight": arrays["weight"]})
    with pytest.raises(KeyError):
        tgluon.load_numpy(tgnn.Dense(4), dict(arrays, extra=arrays["bias"]))
    with pytest.raises(ValueError):
        tgluon.load_numpy(tgnn.Dense(5), arrays)
    with pytest.raises(ValueError):
        tgluon.load_numpy(net, dict(arrays, weight=np.zeros((4, 7),
                                                            np.float32)))


def test_deferred_init_and_initializer():
    net = tgnn.HybridSequential()
    net.add(tgnn.Conv2D(4, 3, padding=1), tgnn.BatchNorm(), tgnn.Dense(3))
    with pytest.raises(tgluon.DeferredInitializationError):
        net(torch.zeros(1, 5, 5, 2))
    net.initialize(seed=3, ctx="cpu")
    y = net(torch.zeros(1, 5, 5, 2))
    assert y.shape == (1, 3)
    p = net.collect_params()
    assert tuple(p["0.weight"].shape) == (3, 3, 2, 4)      # HWIO
    assert tuple(p["2.weight"].shape) == (3, 100)
    assert torch.equal(p["1.running_var"], torch.ones(4))
    assert torch.equal(p["0.bias"], torch.zeros(4))
    # the same seed draws the same weights
    net2 = tgnn.HybridSequential()
    net2.add(tgnn.Conv2D(4, 3, padding=1), tgnn.BatchNorm(), tgnn.Dense(3))
    net2.initialize(seed=3, ctx="cpu")
    net2(torch.zeros(1, 5, 5, 2))
    for k, t in net2.collect_params().items():
        assert torch.equal(t, p[k]), k


# ----------------------------------------------------------- training
# Two SGD steps of a zoo net in training mode, in both packages, from the
# same weights on the same batches.  The residual branches' last BN γ is
# scaled by 0.1 (the damped-residual init large-batch ResNet training
# uses, Goyal et al. 2017), and lr is 0.01: with γ ≈ 1 at batch 2, or at
# lr 0.1 on ResNet-50, the second step's loss rises several-fold and fp32
# rounding differences grow to the size of the update between any two
# fp32 runs (the JAX package's own layer and Pallas routes among them),
# so the comparison would measure that, not the port.  48x48 images keep
# the last stage's BatchNorms at 8 values a channel (at 32x32 and batch 2
# they see 2, and the exact gradient through them is 0).
TRAIN_ITEM = (48, 48, 3)
TRAIN_BATCH = 2
TRAIN_LR = 0.01
LOSS_RTOL = 1e-4        # of the step's largest per-sample loss
UPDATE_TOL = 1e-2       # of the largest two-step update in the net
STATS_TOL = 1e-4        # of each running statistic's largest magnitude


def two_sgd_steps(arch, seed=5, hybridize=False):
    """→ (reference losses, port losses, initial arrays, reference
    arrays after, port arrays after): two steps of forward in training
    mode, backward of the per-sample loss, ``trainer.step(batch)`` with
    SGD (momentum 0.9, wd 1e-4), through ``autograd.record`` /
    ``backward`` / ``gluon.Trainer`` in the JAX package (its net
    hybridized, one compiled program a forward, with ``hybridize``) and
    ``examples.image_classification.forward_backward`` / the port's
    ``gluon.Trainer``."""
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu_torch.examples import image_classification as ic
    jnet, arrays = reference_net(arch, seed=seed, classes=10,
                                 hybridize=hybridize)
    last = ".body.7.gamma" if arch.startswith("resnet50") else \
        ".body.4.gamma"
    params = jnet.collect_params()
    for k, p in params.items():
        if k.endswith(last):
            arrays[k] = (0.1 * arrays[k]).astype(np.float32)
            p.set_data(jnp.asarray(arrays[k]))
    tnet = port_net(arch, arrays, classes=10)
    tnet.train()
    kw = {"learning_rate": TRAIN_LR, "momentum": 0.9, "wd": 1e-4}
    jtr = jgluon.Trainer(params, "sgd", kw)
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd", kw)
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss = tgluon.loss.SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(seed + 1)
    jl, tl = [], []
    for _ in range(2):
        x = rs.rand(TRAIN_BATCH, *TRAIN_ITEM).astype(np.float32)
        y = rs.randint(0, 10, (TRAIN_BATCH,))
        with mx.autograd.record():
            loss = jloss(jnet(mx.np.array(x)), mx.np.array(y))
        loss.backward()
        jtr.step(TRAIN_BATCH)
        jl.append(np.asarray(loss._data))
        tl.append(ic.forward_backward(tnet, tloss, torch.from_numpy(x),
                                      torch.from_numpy(y)).numpy())
        ttr.step(TRAIN_BATCH)
    jafter = {k: np.asarray(p.data()._data) for k, p in params.items()}
    tafter = {k: t.detach().numpy()
              for k, t in tnet.collect_params().items()}
    return jl, tl, arrays, jafter, tafter


def assert_two_steps_match(jl, tl, before, jafter, tafter):
    """Per-step losses; each parameter's two-step update (the weight
    minus its start) against the reference's, within UPDATE_TOL of the
    largest update in the net: a gradient that is small by cancellation
    carries rounding of the net's gradient scale, not of its own; each
    running statistic within STATS_TOL of its largest magnitude."""
    for a, b in zip(tl, jl):
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= LOSS_RTOL * np.abs(b).max(), (a, b)
    assert list(tafter) == list(jafter)
    params = [k for k in jafter if "running_" not in k]
    scale = max(np.abs(jafter[k] - before[k]).max() for k in params)
    assert scale > 0
    for k, b in jafter.items():
        a = tafter[k]
        assert np.isfinite(a).all(), k
        if "running_" in k:
            err, tol = np.abs(a - b).max(), STATS_TOL * np.abs(b).max()
        else:
            err = np.abs((a - before[k]) - (b - before[k])).max()
            tol = UPDATE_TOL * scale
        assert err <= tol, (k, err, tol)


def test_training_mode_raises_and_names_the_slice():
    """Training mode used to be refused here (before the ResNet-training
    slice); it now trains: ResNet-18 v1, two SGD steps against the JAX
    package on its default (layer-by-layer) route."""
    assert_two_steps_match(*two_sgd_steps("resnet18_v1"))


def test_hybridize_changes_nothing(image):
    net = tmodels.get_model("resnet18_v1", classes=10)
    net.initialize(seed=5, ctx="cpu")
    x = torch.from_numpy(image)
    with torch.inference_mode():
        a = net(x)
        net.hybridize()
        b = net(x)
    assert torch.equal(a, b)


def test_get_model_refuses_pretrained_and_unknown_names(tmp_path,
                                                        monkeypatch):
    # pretrained weights come from the model store: an empty store and no
    # weight repository refuse with the reference's error
    monkeypatch.delenv("MXNET_GLUON_REPO", raising=False)
    monkeypatch.delenv("MXNET_TPU_REPO", raising=False)
    with pytest.raises(FileNotFoundError):
        tmodels.get_model("resnet50_v1", pretrained=True,
                          root=str(tmp_path))
    with pytest.raises(ValueError):
        tmodels.get_model("vgg17")


# -------------------------------------------------------------- image ops
def _nhwc(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("kw,wshape", [
    (dict(stride=2, pad=3), (7, 7, 3, 8)),          # the ResNet stem
    (dict(stride=2, pad=0), (1, 1, 6, 10)),          # a downsample
    (dict(stride=1, pad=1), (3, 3, 6, 6)),
    (dict(stride=1, pad=1, groups=2), (3, 3, 3, 4)),
    (dict(stride=1, pad=2, dilate=2), (3, 3, 6, 5)),
])
def test_convolution_matches_reference(kw, wshape):
    rs = np.random.RandomState(11)
    cin = wshape[2] * kw.get("groups", 1)
    x = _nhwc(rs, 2, 13, 11, cin)
    w = _nhwc(rs, *wshape)
    b = _nhwc(rs, wshape[3])
    ref = np.asarray(jnn.convolution(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), **kw))
    out = tnn.convolution(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), **kw).numpy()
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("kw", [
    dict(kernel=3, stride=2, pad=1, pool_type="max"),
    dict(kernel=2, stride=2, pool_type="avg"),
    dict(kernel=3, stride=1, pad=1, pool_type="avg",
         count_include_pad=False),
    dict(global_pool=True, pool_type="avg"),
])
def test_pooling_matches_reference(kw):
    x = _nhwc(np.random.RandomState(12), 2, 9, 8, 5)
    ref = np.asarray(jnn.pooling(jnp.asarray(x), **kw))
    out = tnn.pooling(torch.from_numpy(x), **kw).numpy()
    _close(out, ref, 1e-6)


def test_frozen_batch_norm_dense_and_activation_match_reference():
    rs = np.random.RandomState(13)
    x = _nhwc(rs, 2, 4, 3, 6)
    g, b, m = (_nhwc(rs, 6) for _ in range(3))
    v = rs.uniform(0.5, 1.5, 6).astype(np.float32)
    ref = jnn.batch_norm(*(jnp.asarray(a) for a in (x, g, b, m, v)),
                         training=False)
    out = tnn.batch_norm(*(torch.from_numpy(a) for a in (x, g, b, m, v)),
                         training=False)
    _close(out[0].numpy(), np.asarray(ref[0]), 1e-6)
    # training mode: batch statistics (shifted one-pass sums) and the
    # running averages under MXNet's momentum convention
    ref = jnn.batch_norm(*(jnp.asarray(a) for a in (x, g, b, m, v)),
                         momentum=0.9, training=True)
    out = tnn.batch_norm(*(torch.from_numpy(a) for a in (x, g, b, m, v)),
                         momentum=0.9, training=True)
    for o, r in zip(out, ref):
        _close(o.numpy(), np.asarray(r), 1e-5)
    w, bias = _nhwc(rs, 7, 72), _nhwc(rs, 7)
    ref = np.asarray(jnn.fully_connected(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(bias)))
    out = tnn.fully_connected(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(bias)).numpy()
    _close(out, ref, 1e-5)
    for act in ("relu", "sigmoid", "tanh", "softrelu"):
        ref = np.asarray(jnn.activation(jnp.asarray(x), act_type=act))
        out = tnn.activation(torch.from_numpy(x), act).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
