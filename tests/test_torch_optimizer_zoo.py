"""The port's optimizer zoo and learning-rate schedules
(``mxnet_tpu_torch.optimizer``, ``mxnet_tpu_torch.lr_scheduler``)
against ``mxnet_tpu.optimizer`` and ``mxnet_tpu.lr_scheduler`` on the
CPU, from the same ``RandomState`` weights and gradients: 3 steps of
``update_multi`` and 3 per-key ``update`` steps (key 1 sitting out a
step, so its count lags), with and without ``wd`` and
``clip_gradient``.

Tolerance per rule.  Against the reference's per-key ``update``, which
runs op by op, the weights and states bit for bit where the port does
the same operations in the same order (Adamax, Signum, SGLD, DCASGD);
``rtol`` 1e-6 with ``atol`` 1e-7 where a rule takes a square root
(torch's vectorised CPU ``sqrt`` is within 0.5001 ulp, not correctly
rounded as XLA's is, so an element may differ by one ulp) or a
per-tensor norm (LAMB, LARS, LANS: ``torch._foreach_norm`` sums in
another order than the reference's ``sqrt(sum(x**2))``).  Against the
reference's ``update_multi``, one jitted XLA program whose fusions
contract multiplies and adds, ``rtol`` 1e-6 with ``atol`` 1e-7 for
every rule.  SGLD's noise cannot agree between the two packages
(a JAX key against a ``torch.Generator``), so both sides are given the
same noise: ``jax.random.normal`` and the port's ``SGLD._noise`` are
replaced by one function of the weight's shape (``_fixed_noise``)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu import lr_scheduler as jsched  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu.ndarray import NDArray  # noqa: E402
from mxnet_tpu_torch import lr_scheduler as tsched  # noqa: E402
from mxnet_tpu_torch import optimizer as topt  # noqa: E402

torch.set_num_threads(1)

EXACT = ("adamax", "signum", "sgld", "dcasgd")
RTOL, ATOL = 1e-6, 1e-7

# the fourteen rules this file holds, each with its reference defaults
# overridden only where noted
ZOO = [
    ("adamax", {}),
    ("nadam", {}),
    ("adagrad", {}),
    ("adadelta", {}),
    ("adabelief", {}),
    ("rmsprop", {}),
    ("rmsprop", {"centered": True}),
    ("ftrl", {}),
    ("ftml", {}),
    ("lamb", {}),
    ("lamb", {"lower_bound": 0.5, "upper_bound": 2.0,
              "bias_correction": False}),
    ("lars", {}),
    ("lans", {}),
    ("signum", {"wd_lh": 0.01}),
    ("signum", {"momentum": 0.0}),
    ("sgld", {}),
    ("dcasgd", {"momentum": 0.9}),
]
EXTRA = [
    {},
    {"wd": 0.01},
    {"wd": 0.01, "clip_gradient": 0.5, "rescale_grad": 0.5},
]
SHAPES = [(4, 5), (7,)]
SCHEDULE = [(0, 1), (0,), (0, 1)]       # per-key: key 1 sits out step 2


def _fixed_noise(shape):
    n = int(np.prod(shape))
    return (np.sin(np.arange(n, dtype=np.float64) * 0.37 + 0.1) * 1.3
            ).astype(np.float32).reshape(shape)


@pytest.fixture
def same_noise(monkeypatch):
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(_fixed_noise(shape)))
    monkeypatch.setattr(topt.SGLD, "_noise",
                        lambda self, w: torch.from_numpy(
                            _fixed_noise(tuple(w.shape))))


def _lr(name):
    return {"adadelta": 1.0, "ftrl": 0.1, "lars": 0.1}.get(name, 0.01)


def _assert(exact, got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)


def _start(name, kw, seed):
    rs = np.random.RandomState(seed)
    ws = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    args = dict(learning_rate=_lr(name), **kw)
    jo, to = jopt.create(name, **args), topt.create(name, **args)
    jw = [NDArray(jnp.asarray(w)) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    # each state array a buffer of its own: DCASGD's ``prev`` starts as
    # the weight array itself, which the reference's jitted update_multi
    # would be handed twice to donate
    js = [{k: jnp.array(v, copy=True) for k, v in
           jo.create_state(i, w).items()} for i, w in enumerate(jw)]
    ts = [to.create_state(i, w) for i, w in enumerate(tw)]
    return rs, jo, to, jw, tw, js, ts


def _grads(rs):
    gs = [(2 * rs.randn(*s)).astype(np.float32) for s in SHAPES]
    gs[0].flat[0] = 0.0                 # a zero gradient too
    return gs


def _compare(exact, jw, tw, js, ts):
    for i in range(len(SHAPES)):
        _assert(exact, tw[i].numpy(), jw[i]._data, f"weight {i}")
        jst = {k: v for k, v in js[i].items() if k != "key"}
        assert sorted(ts[i]) == sorted(jst), (ts[i].keys(), jst.keys())
        for k in ts[i]:
            _assert(exact, ts[i][k].numpy(), jst[k], f"state {i} {k}")


@pytest.mark.parametrize("extra", EXTRA, ids=str)
@pytest.mark.parametrize("name,kw", ZOO, ids=lambda v: str(v))
def test_update_multi_matches_reference(name, kw, extra, same_noise):
    rs, jo, to, jw, tw, js, ts = _start(name, dict(kw, **extra), 3)
    for _ in range(3):
        gs = _grads(rs)
        jout = jo.update_multi(
            {i: w._data for i, w in enumerate(jw)},
            {i: jnp.asarray(g) for i, g in enumerate(gs)},
            {i: s for i, s in enumerate(js)})
        for i in range(len(SHAPES)):
            jw[i] = NDArray(jout[0][i])
            js[i] = jout[1][i]
        to.update_multi([0, 1], tw, [torch.from_numpy(g) for g in gs], ts)
    assert to.num_update == jo.num_update == 3
    _compare(False, jw, tw, js, ts)


@pytest.mark.parametrize("extra", EXTRA, ids=str)
@pytest.mark.parametrize("name,kw", ZOO, ids=lambda v: str(v))
def test_per_key_update_matches_reference(name, kw, extra, same_noise):
    rs, jo, to, jw, tw, js, ts = _start(name, dict(kw, **extra), 4)
    for keys in SCHEDULE:
        gs = _grads(rs)
        for i in keys:
            js[i] = jo.update(i, jw[i], NDArray(jnp.asarray(gs[i])), js[i])
            to.update(i, tw[i], torch.from_numpy(gs[i]), ts[i])
    assert to._index_update_count == jo._index_update_count == \
        {"0": 3, "1": 2}
    _compare(name in EXACT, jw, tw, js, ts)


def test_registry_holds_the_reference_names():
    assert sorted(topt._REGISTRY) == sorted(jopt._REGISTRY)
    for name, cls in topt._REGISTRY.items():
        ref = jopt._REGISTRY[name]
        assert cls.__name__ == ref.__name__
        assert topt.create(name).lr == jopt.create(name).lr, name


def test_dcasgd_state_starts_at_the_weight():
    w = torch.arange(6.0).reshape(2, 3)
    st = topt.create("dcasgd").create_state(0, w)
    assert torch.equal(st["prev"], w) and st["prev"] is not w


def test_sgld_draws_from_its_own_generator_on_the_weights_device():
    a, b = topt.create("sgld", seed=7), topt.create("sgld", seed=7)
    wa, wb = torch.zeros(5), torch.zeros(5)
    for opt, w in ((a, wa), (b, wb)):
        opt.update(0, w, torch.zeros(5), opt.create_state(0, w))
    assert torch.equal(wa, wb) and wa.abs().sum() > 0
    assert a.generator("cpu").device.type == "cpu"


# ------------------------------------------------------------ schedules
SCHEDULERS = [
    ("FactorScheduler", dict(step=5, factor=0.5, base_lr=0.1)),
    ("FactorScheduler", dict(step=3, factor=0.3, base_lr=0.1,
                             stop_factor_lr=1e-3)),
    ("MultiFactorScheduler", dict(step=[20, 7, 30], factor=0.5,
                                  base_lr=0.2)),
    ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=2,
                           final_lr=0.001)),
    ("CosineScheduler", dict(max_update=40, base_lr=0.1, final_lr=0.01)),
]
WARMUPS = [{}, dict(warmup_steps=6, warmup_begin_lr=0.01),
           dict(warmup_steps=6, warmup_mode="constant")]


@pytest.mark.parametrize("warmup", WARMUPS, ids=str)
@pytest.mark.parametrize("cls,kw", SCHEDULERS, ids=lambda v: str(v))
def test_scheduler_matches_reference(cls, kw, warmup):
    j = getattr(jsched, cls)(**kw, **warmup)
    t = getattr(tsched, cls)(**kw, **warmup)
    got = [t(n) for n in range(51)]
    want = [j(n) for n in range(51)]
    assert got == want
    assert all(math.isfinite(v) for v in got)


def test_optimizer_reads_its_scheduler_after_each_step():
    """``Optimizer(lr_scheduler=...)``: the learning rate the rule reads
    is the schedule at the count after the increment, as the
    reference's; the weights of 6 SGD steps bit for bit."""
    rs = np.random.RandomState(5)
    w0 = rs.randn(3, 4).astype(np.float32)
    mk = dict(step=2, factor=0.5, base_lr=0.1)
    jo = jopt.create("sgd", momentum=0.9,
                     lr_scheduler=jsched.FactorScheduler(**mk))
    to = topt.create("sgd", momentum=0.9,
                     lr_scheduler=tsched.FactorScheduler(**mk))
    jw, tw = {0: jnp.asarray(w0)}, torch.from_numpy(w0.copy())
    js, ts = {0: jo.init_state(jw[0])}, to.create_state(0, tw)
    lrs = []
    for _ in range(6):
        g = rs.randn(3, 4).astype(np.float32)
        jw, js = jo.update_multi(jw, {0: jnp.asarray(g)}, js)
        to.update_multi([0], [tw], [torch.from_numpy(g)], [ts])
        lrs.append((to.learning_rate, jo.learning_rate))
    assert [a for a, _ in lrs] == [b for _, b in lrs] == \
        [0.1, 0.05, 0.05, 0.025, 0.025, 0.0125]
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw[0]))


def test_begin_num_update_seeds_the_per_key_count():
    jo, to = jopt.create("adam"), topt.create("adam")
    jo.begin_num_update = to.begin_num_update = 10
    w = np.ones(3, np.float32)
    jw, tw = NDArray(jnp.asarray(w)), torch.from_numpy(w.copy())
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for _ in range(2):
        js = jo.update(0, jw, NDArray(jnp.full(3, 0.5, jnp.float32)), js)
        to.update(0, tw, torch.full((3,), 0.5), ts)
    assert to._index_update_count == jo._index_update_count == {"0": 12}
    assert to.num_update == jo.num_update == 12
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw._data))


def test_optimizer_takes_the_reference_arguments():
    sched = tsched.PolyScheduler(max_update=10, base_lr=0.3)
    o = topt.create("lamb", lr_scheduler=sched, aggregate_num=4,
                    multi_precision=True, lazy_update=False)
    assert o.lr_scheduler is sched and o.multi_precision
    assert o.lazy_update is False and o.learning_rate == 0.3
    assert o._fused_sig() == (1.0, None, 0.0)
