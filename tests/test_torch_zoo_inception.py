"""Inception-v3 of the port against the JAX package on the CPU at
75x75x3 (the least input its strided stages take): parameter names
(``b0…``, ``base``/``head{i}``), order and shapes after a deferred-shape
forward, logits on shared seeded weights, and the ten 3x3/s1 convs that
take the standalone conv route (helpers and tolerance in
``test_torch_zoo.py``)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import models as tmodels  # noqa: E402
from mxnet_tpu_torch.ops import conv_block  # noqa: E402
from mxnet_tpu_torch.serve import ModelRegistry  # noqa: E402
from test_torch_zoo import (CLASSES, TOL, check_logits,  # noqa: E402
                            check_names, item, reference)


def test_param_names_and_shapes_match_reference():
    check_names("inceptionv3")


def test_logits_match_reference():
    check_logits("inceptionv3")


def test_ten_convs_take_the_route_a_forward(monkeypatch):
    """The stem's 32→64 at 147², two in each A block (64→96, 96→96 at
    35²), one in B (64→96 at 35²) and one in each E block (448→384 at
    8²): 10 ``conv3x3`` calls a forward at 299x299."""
    calls = []
    real = conv_block.conv3x3
    monkeypatch.setattr(conv_block, "conv3x3",
                        lambda x, w: calls.append(
                            (tuple(x.shape[1:]), w.shape[-1])) or real(x, w))
    net = tmodels.get_model("inceptionv3", classes=CLASSES)
    net.initialize(ctx="cpu", seed=0)
    with torch.no_grad():
        net(torch.zeros(1, 299, 299, 3))
    assert calls == [((147, 147, 32), 64)] + [((35, 35, 64), 96),
                                              ((35, 35, 96), 96)] * 3 + \
        [((35, 35, 64), 96)] + [((8, 8, 448), 384)] * 2


def test_registry_serves_inception_as_its_forward(tmp_path):
    """``ModelRegistry.load(..., arch="inceptionv3")`` on the CPU at
    buckets (1, 2): a response equals the net's forward of its image
    alone within ``TOL`` of the largest logit, the top-1 class equal."""
    _, arrays = reference("inceptionv3")
    net = tmodels.get_model("inceptionv3", classes=CLASSES)
    tgluon.load_numpy(net, arrays)
    path = str(tmp_path / "inception.params")
    net.save_parameters(path)
    x = np.random.RandomState(4).rand(*item("inceptionv3")).astype(
        np.float32)
    with torch.inference_mode():
        want = net(torch.from_numpy(x)[None]).numpy()[0]
    with ModelRegistry(device="cpu") as reg:
        reg.load("inc", path, arch="inceptionv3",
                 item_shape=item("inceptionv3"), buckets=(1, 2),
                 classes=CLASSES)
        got = np.asarray(reg.predict("inc", x, timeout=60)).reshape(-1)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert got.argmax() == want.argmax()
