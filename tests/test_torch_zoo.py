"""The port's model zoo (``mxnet_tpu_torch.models``, re-exported by
``gluon.model_zoo.vision``) against the JAX package's on the CPU.

For each of the reference's 35 registry names the port's
``collect_params()`` names, order and shapes equal the reference's after
a deferred-shape forward; logits on shared seeded numpy weights equal
the reference's within ``TOL`` of the largest logit with the top-1
class equal.  This file holds LeNet, AlexNet, VGG, SqueezeNet and the
ResNets (their logits are ``test_torch_resnet.py``'s); DenseNet,
Inception-v3 and MobileNet have files of their own, so that the
reference's per-shape compiles spread over the test workers.  Inputs
are small (LeNet 28x28x1, AlexNet and SqueezeNet 64x64x3, the rest
32x32x3, Inception 75x75x3) at batch 2 and 10 classes."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import models as jmodels  # noqa: E402
from mxnet_tpu.ops import pallas_conv as jpc  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import models as tmodels  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision  # noqa: E402
from mxnet_tpu_torch.ops import conv_block  # noqa: E402
from test_torch_resnet import weights_for  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4          # of the largest |logit|: fp32 sums in another order
BATCH = 2
CLASSES = 10
SIZE = {"lenet": (28, 1), "alexnet": (64, 3), "squeezenet1.0": (64, 3),
        "squeezenet1.1": (64, 3), "inceptionv3": (75, 3)}


def item(name):
    s, c = SIZE.get(name, (32, 3))
    return (s, s, c)


def images(name, seed=3):
    return np.random.RandomState(seed).rand(BATCH, *item(name)).astype(
        np.float32)


@functools.lru_cache(maxsize=1)     # a test's names, then its logits
def reference(name):
    """The JAX package's ``name`` (10 classes) after a deferred-shape
    forward at the test's batch and input, every parameter then replaced
    by seeded numpy weights → (net, {name: array}).  Zero init before
    the forward: the shapes are all it is for, and it skips the
    reference's random draws."""
    net = jmodels.get_model(name, classes=CLASSES)
    net.initialize(init=mx.init.Zero())
    net(mx.np.array(np.zeros((BATCH,) + item(name), np.float32)))
    params = net.collect_params()
    arrays = weights_for([(k, p.shape) for k, p in params.items()], 1)
    for k, p in params.items():
        p.set_data(jnp.asarray(arrays[k]))
    return net, arrays


def check_names(name):
    """The port's own deferred-shape forward gives the reference's
    parameter names, order and shapes."""
    net = tmodels.get_model(name, classes=CLASSES)
    net.initialize(ctx="cpu", seed=0)
    with torch.no_grad():
        net(torch.zeros((BATCH,) + item(name)))
    got = [(k, tuple(t.shape)) for k, t in net.collect_params().items()]
    jnet, _ = reference(name)
    want = [(k, tuple(p.shape)) for k, p in jnet.collect_params().items()]
    assert got == want


def port(name, arrays):
    net = tmodels.get_model(name, classes=CLASSES)
    tgluon.load_numpy(net, arrays)
    return net


def check_logits(name, jnet=None, arrays=None):
    if jnet is None:
        jnet, arrays = reference(name)
    x = images(name)
    with torch.inference_mode():
        out = port(name, arrays)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jnet(mx.np.array(x))._data)
    assert out.shape == ref.shape == (BATCH, CLASSES)
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max()
    assert err <= TOL * np.abs(ref).max(), (name, err, np.abs(ref).max())
    assert (out.argmax(-1) == ref.argmax(-1)).all()
    return out


# ----------------------------------------------------------------- names
LIGHT = ["lenet", "alexnet", "vgg11", "vgg13", "vgg16", "vgg19",
         "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "squeezenet1.0",
         "squeezenet1.1", "resnet18_v1", "resnet34_v1", "resnet50_v1",
         "resnet101_v1", "resnet152_v1", "resnet18_v2", "resnet34_v2",
         "resnet50_v2", "resnet101_v2", "resnet152_v2"]


@pytest.mark.parametrize("name", LIGHT)
def test_param_names_and_shapes_match_reference(name):
    check_names(name)


def test_registry_has_the_references_names():
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    assert sorted(tmodels._MODELS) == sorted(jmodels._MODELS)
    assert len(tmodels._MODELS) == 36
    public = {n for n in dir(jvision) if not n.startswith("_")}
    assert public <= set(dir(tvision))
    assert tvision.get_model is tmodels.get_model
    assert tvision.Inception3 is tmodels.Inception3
    assert tvision.alexnet is tmodels.alexnet
    assert isinstance(tgluon.model_zoo.vision.densenet121(),
                      tmodels.DenseNet)


def test_ssd_raises_naming_its_queue_item():
    with pytest.raises(NotImplementedError, match="item 8"):
        tmodels.get_model("ssd_300_lite")
    with pytest.raises(ValueError, match="unknown model"):
        tmodels.get_model("resnet1000")


# ----------------------------------------------------------------- logits
@pytest.mark.parametrize("name", ["lenet", "alexnet", "vgg11", "vgg11_bn",
                                  "squeezenet1.0", "squeezenet1.1"])
def test_logits_match_reference(name):
    check_logits(name)


def test_squeezenet_ignores_ceil_mode_as_the_reference():
    """The pools pass ``ceil_mode=True``; the reference ignores it, so a
    224x224 SqueezeNet 1.0 sees planes of 54, 26 and 12 after its three
    pools (ceil mode would give 55, 27, 13)."""
    net = tmodels.get_model("squeezenet1.0", classes=CLASSES)
    net.initialize(ctx="cpu", seed=0)
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.append(tuple(o.shape[1:3])))
        for m in net.features if isinstance(m, tgluon.nn.MaxPool2D)]
    with torch.no_grad():
        net(torch.zeros(1, 224, 224, 3))
    for h in hooks:
        h.remove()
    assert seen == [(54, 54), (26, 26), (12, 12)]


def test_vgg_logits_match_reference_forced_pallas_route(monkeypatch):
    """VGG-11 with the reference's eligible convs forced through its
    Pallas ``conv3x3_s1`` (``MXNET_TPU_PALLAS_CONV=1``, interpret mode),
    the port's through ``Conv3x3Fn`` (the plain ``conv3x3`` on the CPU):
    all eight 3x3/s1 convs, the 3-channel stem included (the reference
    takes those its TPU VMEM gate admits, the stem among them)."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_CONV", "1")
    routed = []
    real = jpc.conv3x3_s1
    monkeypatch.setattr(jpc, "conv3x3_s1",
                        lambda x, w: routed.append(x.shape) or real(x, w))
    calls = []
    real_t = conv_block.conv3x3
    monkeypatch.setattr(conv_block, "conv3x3",
                        lambda x, w: calls.append(x.shape) or real_t(x, w))
    jnet = jmodels.get_model("vgg11", classes=CLASSES)
    jnet.initialize(init=mx.init.Zero())
    jnet(mx.np.array(np.zeros((BATCH,) + item("vgg11"), np.float32)))
    params = jnet.collect_params()
    arrays = weights_for([(k, p.shape) for k, p in params.items()], 2)
    for k, p in params.items():
        p.set_data(jnp.asarray(arrays[k]))
    # traced at the first (deferred) forward: the shapes its VMEM gate
    # takes, the 3-channel stem first
    assert routed[0] == (BATCH, 32, 32, 3) and len(routed) >= 5
    check_logits("vgg11", jnet, arrays)
    assert len(calls) == 8 and calls[0] == (BATCH, 32, 32, 3)
