"""``mx.seed`` reaches ``Block.initialize()`` and ``gluon.nn.Dropout``, as
the reference's seed reaches the key chain both draw from
(``mxnet_tpu/__init__.py seed``): with no ``seed=`` / ``generator=``
they draw from ``mx.random``'s generators.  An explicit seed or
generator keeps its own stream."""
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import autograd as tautograd  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tgnn  # noqa: E402


def _net():
    net = tgnn.HybridSequential()
    net.add(tgnn.Dense(8, in_units=4), tgnn.Conv2D(3, 3, in_channels=2),
            tgnn.Dense(5))
    return net


def _weights(s=None, **kw):
    if s is not None:
        tmx.seed(s)
    net = _net()
    net.initialize(ctx="cpu", **kw)
    net[2](torch.zeros(1, 6))                      # a deferred shape
    return [t.detach().clone() for t in net.collect_params().values()]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_seed_reaches_initialize():
    assert _same(_weights(3), _weights(3))
    assert not _same(_weights(1), _weights(2))


@pytest.mark.parametrize("kw", [{"seed": 5},
                                {"generator": "explicit"}])
def test_explicit_seed_or_generator_ignores_mx_seed(kw):
    def make(s):
        if "generator" in kw:
            return _weights(s, generator=torch.Generator().manual_seed(5))
        return _weights(s, **kw)
    a, b = make(1), make(2)
    assert _same(a, b)
    gen = torch.Generator().manual_seed(5)
    want = _net()
    want.initialize(ctx="cpu", generator=gen)
    assert torch.equal(a[0], want[0].weight)


def _mask(s, **kw):
    tmx.seed(s)
    d = tgnn.Dropout(0.5, **kw)
    with tautograd.train_mode():
        return d(torch.ones(64, 32)) != 0


def test_seed_reaches_dropout():
    assert torch.equal(_mask(7), _mask(7))
    assert not torch.equal(_mask(1), _mask(2))
    with tautograd.predict_mode():
        x = torch.ones(4)
        assert tgnn.Dropout(0.5)(x) is x


def test_dropout_with_a_generator_ignores_mx_seed():
    a = _mask(1, generator=torch.Generator().manual_seed(9))
    b = _mask(2, generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
