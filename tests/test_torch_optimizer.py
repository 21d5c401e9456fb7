"""The PyTorch port's optimizers (``mxnet_tpu_torch.optimizer``) against
``mxnet_tpu.optimizer`` on identical numpy weights and gradients: the
same rule, the same per-key step counts.  Tolerance 1e-6 absolute on the
weights and states after 3 steps (fp32, the same operations in the same
order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu.ndarray import NDArray  # noqa: E402
from mxnet_tpu_torch import optimizer as topt  # noqa: E402

torch.set_num_threads(1)

# key 1 sits out step 1, so its bias correction lags key 0's by one
SCHEDULE = [(0, 1), (0,), (0, 1), (1,)]


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(learning_rate=1e-2, wd=0.01)),
    ("adam", dict(learning_rate=1e-2, wd=0.01)),
    ("AdamW", dict(learning_rate=3e-3, wd=0.1, rescale_grad=0.5,
                   clip_gradient=0.8, beta1=0.8, epsilon=1e-6)),
])
def test_matches_reference_with_per_key_counts(name, kw):
    rs = np.random.RandomState(0)
    shapes = [(4, 5), (7,)]
    ws = [rs.randn(*s).astype(np.float32) for s in shapes]
    jo, to = jopt.create(name, **kw), topt.create(name, **kw)
    jw = [NDArray(jnp.asarray(w)) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    js = [jo.create_state(i, w) for i, w in enumerate(jw)]
    ts = [to.create_state(i, w) for i, w in enumerate(tw)]
    for keys in SCHEDULE:
        for i in keys:
            g = (2 * rs.randn(*shapes[i])).astype(np.float32)
            g.flat[0] = 0.0                         # a zero gradient too
            js[i] = jo.update(i, jw[i], NDArray(jnp.asarray(g)), js[i])
            to.update(i, tw[i], torch.from_numpy(g), ts[i])
    assert to._index_update_count == jo._index_update_count == \
        {"0": 3, "1": 3}
    assert to.num_update == jo.num_update == 3
    for i in range(2):
        np.testing.assert_allclose(tw[i].numpy(), np.asarray(jw[i]._data),
                                   atol=1e-6, rtol=0)
        for k in ("mean", "var"):
            np.testing.assert_allclose(ts[i][k].numpy(),
                                       np.asarray(js[i][k]), atol=1e-6,
                                       rtol=0)


def test_update_multi_equals_one_key_at_a_time():
    rs = np.random.RandomState(1)
    ws = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    gs = [rs.randn(*w.shape).astype(np.float32) for w in ws]
    a, b = topt.create("adamw", learning_rate=1e-3, wd=0.01), \
        topt.create("adamw", learning_rate=1e-3, wd=0.01)
    wa = [torch.from_numpy(w.copy()) for w in ws]
    wb = [torch.from_numpy(w.copy()) for w in ws]
    sa = [a.create_state(i, w) for i, w in enumerate(wa)]
    sb = [b.create_state(i, w) for i, w in enumerate(wb)]
    for _ in range(2):
        a.update_multi([0, 1], wa, [torch.from_numpy(g) for g in gs], sa)
        for i in range(2):
            b.update(i, wb[i], torch.from_numpy(gs[i]), sb[i])
    for x, y in zip(wa, wb):
        assert torch.equal(x, y)


def test_weight_decay_reaches_a_parameter_with_zero_gradient():
    """The reference decays every parameter, an unused one included."""
    w = torch.ones(3)
    opt = topt.create("adamw", learning_rate=0.1, wd=0.5)
    opt.update(0, w, torch.zeros(3), opt.create_state(0, w))
    torch.testing.assert_close(w, torch.full((3,), 1 - 0.1 * 0.5))


def test_updates_leaf_that_requires_grad_in_place():
    w = torch.ones(3, requires_grad=True)
    ref = w
    opt = topt.create("adam", learning_rate=0.1)
    opt.update(0, w, torch.ones(3), opt.create_state(0, w))
    assert ref is w and w.requires_grad and w.grad_fn is None
    torch.testing.assert_close(w.detach(), torch.full((3,), 0.9))


def test_create_unknown_name_raises_keyerror():
    with pytest.raises(KeyError):
        topt.create("nope")
    o = topt.AdamW()
    assert topt.create(o) is o


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4)),
    ("sgd", dict(learning_rate=0.05, wd=1e-3, rescale_grad=0.5,
                 clip_gradient=0.8)),                  # no momentum
    ("sgd", dict(learning_rate=0.1, momentum=0.9, nesterov=True, wd=1e-4,
                 rescale_grad=1 / 64, clip_gradient=0.01)),
    ("nag", dict(learning_rate=0.1, momentum=0.8, wd=1e-4,
                 rescale_grad=0.25, clip_gradient=0.5)),
])
def test_sgd_and_nag_match_reference(name, kw):
    """Three steps of each key with wd, rescale and clip: the weights and
    the momentum within 1e-6."""
    rs = np.random.RandomState(2)
    shapes = [(3, 4), (6,)]
    ws = [rs.randn(*s).astype(np.float32) for s in shapes]
    jo, to = jopt.create(name, **kw), topt.create(name, **kw)
    jw = [NDArray(jnp.asarray(w)) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    js = [jo.create_state(i, w) for i, w in enumerate(jw)]
    ts = [to.create_state(i, w) for i, w in enumerate(tw)]
    assert sorted(ts[0]) == sorted(js[0])
    for _ in range(3):
        gs = [(2 * rs.randn(*s)).astype(np.float32) for s in shapes]
        for i in range(2):
            js[i] = jo.update(i, jw[i], NDArray(jnp.asarray(gs[i])), js[i])
        to.update_multi([0, 1], tw, [torch.from_numpy(g) for g in gs], ts)
    for i in range(2):
        np.testing.assert_allclose(tw[i].numpy(), np.asarray(jw[i]._data),
                                   atol=1e-6, rtol=0)
        for k in ts[i]:
            np.testing.assert_allclose(ts[i][k].numpy(),
                                       np.asarray(js[i][k]), atol=1e-6,
                                       rtol=0)


def test_learning_rate_is_settable():
    opt = topt.create("sgd", learning_rate=0.1, momentum=0.9)
    assert opt.learning_rate == 0.1
    opt.set_learning_rate(0.01)
    w = torch.ones(2)
    opt.update(0, w, torch.ones(2), opt.create_state(0, w))
    torch.testing.assert_close(w, torch.full((2,), 1 - 0.01))
