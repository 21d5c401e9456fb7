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


# ---------------------------------------------------------------- Trainer
def _two_dense(ws):
    """Two bias-free Dense layers (4x3, 2x3) of each package holding the
    same numpy weights."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch import gluon as tgluon
    from mxnet_tpu_torch.gluon import nn as tnn
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(4, in_units=3, use_bias=False),
             jnn.Dense(2, in_units=3, use_bias=False))
    jnet.initialize()
    for p, w in zip(jnet.collect_params().values(), ws):
        p.set_data(jnp.asarray(w))
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(4, in_units=3, use_bias=False),
             tnn.Dense(2, in_units=3, use_bias=False))
    tgluon.load_numpy(tnet, {"0.weight": ws[0], "1.weight": ws[1]})
    return jnet, tnet


def _loss_j(jnet, x, layers):
    import mxnet_tpu as mx
    with mx.autograd.record():
        loss = sum((jnet[i](mx.np.array(x)) ** 2).sum() for i in layers)
    loss.backward()


def _loss_t(tnet, x, layers):
    sum((tnet[i](torch.from_numpy(x)) ** 2).sum() for i in layers).backward()


def test_trainer_adam_step_count_matches_reference():
    """A parameter that sits out step 1 takes step 2 with t = 2, the
    Trainer's one global count (the reference's ``update_multi``), not
    with its own count of 1.  Within 1e-6 of the reference."""
    import mxnet_tpu as mx
    from mxnet_tpu_torch import gluon as tgluon
    rs = np.random.RandomState(0)
    ws = [rs.randn(4, 3).astype(np.float32),
          rs.randn(2, 3).astype(np.float32)]
    xs = [rs.randn(5, 3).astype(np.float32) for _ in range(2)]
    jnet, tnet = _two_dense(ws)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adam",
                           {"learning_rate": 0.1})
    ttr = tgluon.Trainer(tnet.collect_params(), "adam",
                         {"learning_rate": 0.1})
    for x, layers in zip(xs, [(0,), (0, 1)]):
        _loss_j(jnet, x, layers)
        jtr.step(5, ignore_stale_grad=True)
        _loss_t(tnet, x, layers)
        ttr.step(5, ignore_stale_grad=True)
    assert ttr.optimizer.num_update == jtr._optimizer.num_update == 2
    for (k, p), t in zip(jnet.collect_params().items(),
                         tnet.collect_params().values()):
        np.testing.assert_allclose(t.detach().numpy(),
                                   np.asarray(p.data()._data), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_trainer_loads_the_reference_states_file(tmp_path):
    """The JAX package's ``save_states`` pickle loads into the port's
    Trainer: the same states and step count, and the next step lands
    where the reference's does (within 1e-6)."""
    import mxnet_tpu as mx
    from mxnet_tpu_torch import gluon as tgluon
    rs = np.random.RandomState(1)
    ws = [rs.randn(4, 3).astype(np.float32),
          rs.randn(2, 3).astype(np.float32)]
    xs = [rs.randn(5, 3).astype(np.float32) for _ in range(3)]
    jnet, tnet = _two_dense(ws)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adam",
                           {"learning_rate": 0.05})
    for x in xs[:2]:
        _loss_j(jnet, x, (0, 1))
        jtr.step(5)
    path = str(tmp_path / "reference.states")
    jtr.save_states(path)
    tgluon.load_numpy(tnet, {k: np.array(p.data()._data)
                             for k, p in jnet.collect_params().items()})
    ttr = tgluon.Trainer(tnet.collect_params(), "adam",
                         {"learning_rate": 0.05})
    ttr.load_states(path)
    assert ttr.optimizer.num_update == 2
    assert set(ttr._states) == {"0.weight", "1.weight"}
    for name, st in ttr._states.items():
        for k in ("mean", "var"):
            np.testing.assert_array_equal(
                st[k].numpy(), np.asarray(jtr._states[name][k]))
    _loss_j(jnet, xs[2], (0, 1))
    jtr.step(5)
    _loss_t(tnet, xs[2], (0, 1))
    ttr.step(5)
    for p, t in zip(jnet.collect_params().values(),
                    tnet.collect_params().values()):
        np.testing.assert_allclose(t.detach().numpy(),
                                   np.asarray(p.data()._data), atol=1e-6,
                                   rtol=0)


class _Smuggled:
    pass


def test_trainer_refuses_a_states_pickle_that_is_not_arrays(tmp_path):
    """Only numpy arrays and plain containers unpickle; anything else is
    refused with a message naming the expected format."""
    import pickle
    from mxnet_tpu_torch import gluon as tgluon
    from mxnet_tpu_torch.gluon import nn as tnn
    net = tnn.Dense(2, in_units=3)
    net.initialize(ctx="cpu")
    tr = tgluon.Trainer(net.collect_params(), "adam")
    bad = tmp_path / "bad.states"
    bad.write_bytes(pickle.dumps({"num_update": 1,
                                  "states": {"weight": _Smuggled()}}))
    with pytest.raises(ValueError, match="num_update"):
        tr.load_states(str(bad))
    junk = tmp_path / "junk.states"
    junk.write_bytes(b"not a states file")
    with pytest.raises(ValueError, match="num_update"):
        tr.load_states(str(junk))
