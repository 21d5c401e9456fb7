"""The rest of the port's training surface against the JAX package on the
CPU, with the same ``numpy.random.RandomState`` inputs fed to both:

- every Gluon loss but CTC, forward and the gradient of its first input
  (``jax.grad`` of the reference against torch autograd), with
  ``sample_weight``, ``weight`` and ``batch_axis=1``;
- every metric of ``gluon.metric`` on the same batches (counts exactly,
  values at rel 1e-6), ``create`` by name, and the device-held sums;
- ``Trainer.allreduce_grads(); update()`` against ``step()``, also beside
  a live ``fuse_step`` executor, and ``shard_batch``;
- the top-level names (``mx.lr_scheduler``, ``mx.init``, ``mx.seed``,
  ``mx.random``, ``mx.waitall``, ``mx.Optimizer``, ``mx.current_context``);
- the ``mx.random`` samplers: the reference's shapes and dtypes, moments
  at n = 10⁵ within six standard errors (mean) and 5% (variance), and the
  same stream after the same seed.
"""
import math
import random as pyrandom

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu.gluon import loss as jloss  # noqa: E402
from mxnet_tpu.gluon import metric as jmetric  # noqa: E402
from mxnet_tpu.ndarray import NDArray  # noqa: E402
from mxnet_tpu_torch import autograd as tautograd  # noqa: E402
from mxnet_tpu_torch.gluon import Trainer, load_numpy, nn  # noqa: E402
from mxnet_tpu_torch.gluon import loss as tloss  # noqa: E402
from mxnet_tpu_torch.gluon import metric as tmetric  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6       # fp32, forward and gradient
METRIC_REL = 1e-6


# ------------------------------------------------------------------ losses
def _inputs(kind, rs, shape=(6, 5)):
    """The loss's inputs as numpy: the differentiable first one, then the
    others."""
    p = rs.randn(*shape).astype(np.float32)
    q = rs.randn(*shape).astype(np.float32)
    sign = np.where(rs.rand(*shape) < 0.5, -1.0, 1.0).astype(np.float32)
    if kind == "regression":
        return [p, q]
    if kind == "signed":
        return [p, sign]
    if kind == "binary":
        return [p, (sign > 0).astype(np.float32)]
    if kind == "soft":
        return [p, rs.rand(*shape).astype(np.float32)]
    if kind == "prob":
        return [rs.uniform(0.05, 0.95, shape).astype(np.float32),
                rs.rand(*shape).astype(np.float32)]
    if kind == "kl_logp":
        e = np.exp(q)
        return [(p - np.log(np.exp(p).sum(-1, keepdims=True))).astype(
            np.float32), (e / e.sum(-1, keepdims=True)).astype(np.float32)]
    if kind == "kl_logits":
        e = np.exp(q)
        return [p, (e / e.sum(-1, keepdims=True)).astype(np.float32)]
    if kind == "triplet":
        return [p, q, rs.randn(*shape).astype(np.float32)]
    if kind == "cosine":
        return [p, q, sign[:, 0]]
    if kind == "poisson_rate":
        return [rs.uniform(0.5, 4.0, shape).astype(np.float32),
                rs.randint(0, 6, shape).astype(np.float32)]
    if kind == "poisson_log":
        return [p, rs.randint(0, 6, shape).astype(np.float32)]
    raise ValueError(kind)


LOSSES = [
    ("HuberLoss", {"rho": 0.7}, "regression"),
    ("HingeLoss", {"margin": 1.2}, "signed"),
    ("SquaredHingeLoss", {}, "signed"),
    ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", {"label_format": "binary"}, "binary"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "soft"),
    ("SigmoidBCELoss", {"from_sigmoid": True}, "prob"),
    ("KLDivLoss", {}, "kl_logp"),
    ("KLDivLoss", {"from_logits": False}, "kl_logits"),
    ("TripletLoss", {"margin": 0.5}, "triplet"),
    ("CosineEmbeddingLoss", {"margin": 0.1}, "cosine"),
    ("PoissonNLLLoss", {}, "poisson_log"),
    ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
     "poisson_rate"),
    ("SDMLLoss", {"smoothing_parameter": 0.2}, "regression"),
    # the weights and the kept axis
    ("HuberLoss", {"weight": 0.5}, "regression"),
    ("L1Loss", {"batch_axis": 1}, "regression"),
    ("HingeLoss", {"batch_axis": 1, "weight": 2.0}, "signed"),
    ("SigmoidBCELoss", {"weight": 3.0}, "soft"),
    ("TripletLoss", {"weight": 0.25}, "triplet"),
    ("CosineEmbeddingLoss", {"weight": 2.0}, "cosine"),
    ("PoissonNLLLoss", {"weight": 0.5}, "poisson_log"),
]


def _loss_id(case):
    name, kw, _ = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


def _sample_weight(name, kw, rs, shape):
    """A sample weight broadcast against the unreduced loss: one a row
    where that loss has one value a row, else one a row (or a column, with
    ``batch_axis=1``) broadcast over the other axis."""
    if name in ("SDMLLoss", "TripletLoss", "CosineEmbeddingLoss"):
        return rs.rand(shape[0]).astype(np.float32)
    if kw.get("batch_axis") == 1:
        return rs.rand(1, shape[1]).astype(np.float32)
    return rs.rand(shape[0], 1).astype(np.float32)


@pytest.mark.parametrize("with_sw", [False, True], ids=["plain", "sw"])
@pytest.mark.parametrize("case", LOSSES, ids=_loss_id)
def test_loss_and_its_gradient_match_reference(case, with_sw):
    name, kw, kind = case
    rs = np.random.RandomState(len(name) + 3 * with_sw)
    shape = (6, 5)
    xs = _inputs(kind, rs, shape)
    sw = _sample_weight(name, kw, rs, shape) if with_sw else None
    jl, tl = getattr(jloss, name)(**kw), getattr(tloss, name)(**kw)

    def ref(first):
        args = [NDArray(first)] + [NDArray(jnp.asarray(a)) for a in xs[1:]]
        if sw is not None:
            return jl(*args, sample_weight=NDArray(jnp.asarray(sw)))._data
        return jl(*args)._data

    want = np.asarray(ref(jnp.asarray(xs[0])))
    g = np.asarray(rs.randn(*want.shape), np.float32)
    want_grad = np.asarray(jax.grad(
        lambda f: jnp.vdot(jnp.asarray(g), ref(f)))(jnp.asarray(xs[0])))
    first = torch.from_numpy(xs[0]).requires_grad_()
    targs = [first] + [torch.from_numpy(a) for a in xs[1:]]
    out = tl(*targs, sample_weight=None if sw is None
             else torch.from_numpy(sw))
    out.backward(torch.from_numpy(g))
    assert tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(first.grad.numpy(), want_grad,
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_loss_names_match_reference_and_ctc_waits_for_its_op():
    assert set(tloss.__all__) == set(jloss.__all__)
    with pytest.raises(NotImplementedError, match="ops/ctc.py"):
        tloss.CTCLoss()
    assert tloss.SigmoidBCELoss is tloss.SigmoidBinaryCrossEntropyLoss


def test_sigmoid_bce_ignores_pos_weight_as_the_reference():
    rs = np.random.RandomState(4)
    p, l = _inputs("soft", rs)
    a = tloss.SigmoidBCELoss()(torch.from_numpy(p), torch.from_numpy(l))
    b = tloss.SigmoidBCELoss()(torch.from_numpy(p), torch.from_numpy(l),
                               torch.full((5,), 3.0))
    assert torch.equal(a, b)


# ----------------------------------------------------------------- metrics
def _metric_batches(kind, rs, n=3, b=16, k=5):
    """``n`` (labels, preds) numpy batches."""
    out = []
    for _ in range(n):
        if kind == "class":
            p = rs.rand(b, k).astype(np.float32)
            out.append((rs.randint(0, k, (b,)).astype(np.float32),
                        p / p.sum(-1, keepdims=True)))
        elif kind == "class_index":
            out.append((rs.randint(0, k, (b,)),
                        rs.randint(0, k, (b,)).astype(np.float32)))
        elif kind == "binary":
            p = rs.rand(b, 2).astype(np.float32)
            out.append((rs.randint(0, 2, (b,)).astype(np.float32), p))
        elif kind == "score":
            out.append((rs.randint(0, 2, (b,)).astype(np.float32),
                        rs.rand(b).astype(np.float32)))
        elif kind == "regression":
            out.append((rs.randn(b, 3).astype(np.float32),
                        rs.randn(b, 3).astype(np.float32)))
        elif kind == "loss":
            out.append((None, rs.rand(b).astype(np.float32)))
        else:
            raise ValueError(kind)
    return out


METRICS = [
    ("Accuracy", {}, "class"),
    ("Accuracy", {}, "class_index"),
    ("TopKAccuracy", {"top_k": 3}, "class"),
    ("MAE", {}, "regression"),
    ("MSE", {}, "regression"),
    ("RMSE", {}, "regression"),
    ("CrossEntropy", {}, "class"),
    ("Perplexity", {"ignore_label": 0}, "class"),
    ("NegativeLogLikelihood", {}, "class"),
    ("F1", {}, "binary"),
    ("Fbeta", {"beta": 2.0}, "binary"),
    ("MCC", {}, "binary"),
    ("PCC", {}, "binary"),
    ("PearsonCorrelation", {}, "regression"),
    ("Loss", {}, "loss"),
    ("BinaryAccuracy", {"threshold": 0.4}, "score"),
    ("MeanPairwiseDistance", {}, "regression"),
    ("MeanPairwiseDistance", {"p": 3}, "regression"),
    ("MeanCosineSimilarity", {}, "regression"),
]


def _metric_id(case):
    name, kw, kind = case
    return "-".join([name, kind] + [f"{k}={v}" for k, v in kw.items()])


def _same_value(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_value(a, b)
        return
    if math.isnan(want):
        assert math.isnan(got)
    else:
        assert abs(got - want) <= METRIC_REL * max(abs(want), 1e-30), \
            (got, want)


@pytest.mark.parametrize("feed", ["tensor", "numpy"])
@pytest.mark.parametrize("case", METRICS, ids=_metric_id)
def test_metric_matches_reference(case, feed):
    name, kw, kind = case
    rs = np.random.RandomState(len(name) + len(kind))
    jm, tm = getattr(jmetric, name)(**kw), getattr(tmetric, name)(**kw)
    assert tm.get()[0] == jm.get()[0]
    assert math.isnan(tm.get()[1]) == math.isnan(jm.get()[1])
    for l, p in _metric_batches(kind, rs):
        jm.update(l, p)
        if feed == "tensor":
            tm.update(None if l is None else torch.from_numpy(l),
                      torch.from_numpy(p))
        else:
            tm.update(l, p)
    assert tm.num_inst == jm.num_inst
    if hasattr(jm, "tp"):
        assert (tm.tp, tm.fp, tm.fn) == (jm.tp, jm.fp, jm.fn)
    if hasattr(jm, "tn"):
        assert tm.tn == jm.tn
    name_t, value_t = tm.get()
    name_j, value_j = jm.get()
    assert name_t == name_j
    _same_value(value_t, value_j)
    _same_value(tm.sum_metric, jm.sum_metric)
    assert tm.get_name_value() == [(name_t, value_t)]
    tm.reset()
    assert tm.num_inst == 0


def test_counting_metrics_keep_float64_sums_on_the_inputs_device():
    """The running sum is a float64 tensor (on the card, where the inputs
    are: no host read in ``update``), read once as a number."""
    rs = np.random.RandomState(0)
    (l, p), = _metric_batches("class", rs, n=1)
    for m in (tmetric.Accuracy(), tmetric.TopKAccuracy(2),
              tmetric.CrossEntropy(), tmetric.Loss()):
        m.update(torch.from_numpy(l), torch.from_numpy(p))
        assert isinstance(m._sum, torch.Tensor)
        assert m._sum.dtype == torch.float64
        assert isinstance(m.sum_metric, float)
    f1 = tmetric.F1()
    f1.update(torch.from_numpy(l), torch.from_numpy(p))
    assert f1._conf.dtype == torch.int64 and isinstance(f1.tp, int)


def test_composite_custom_and_np_metrics_match_reference():
    rs = np.random.RandomState(5)
    batches = _metric_batches("class", rs)
    names = ["accuracy", "crossentropy", "topkaccuracy"]
    jc = jmetric.CompositeEvalMetric(names)
    tc = tmetric.CompositeEvalMetric(names)
    jc.add(jmetric.Perplexity())
    tc.add("perplexity")

    def feval(label, pred):
        return float(np.abs(pred.argmax(-1) - label).sum()), label.size

    def plain(label, pred):
        return float((pred.max(-1)).mean())
    jcu, tcu = jmetric.CustomMetric(feval), tmetric.CustomMetric(feval)
    jnp_m, tnp_m = jmetric.np(plain), tmetric.np(plain)
    for l, p in batches:
        for j, t in ((jc, tc), (jcu, tcu), (jnp_m, tnp_m)):
            j.update([l], [p])
            t.update([torch.from_numpy(l)], [torch.from_numpy(p)])
    for j, t in ((jc, tc), (jcu, tcu), (jnp_m, tnp_m)):
        nj, vj = j.get()
        nt, vt = t.get()
        assert nt == nj
        _same_value(vt, vj)
    assert tc.get_name_value() == [(n, v) for n, v in zip(*tc.get())]


def test_metric_create_by_name_matches_reference():
    assert sorted(tmetric._REGISTRY) == sorted(jmetric._REGISTRY)
    for key, jcls in jmetric._REGISTRY.items():
        if key in ("compositeevalmetric", "custommetric"):
            continue
        m = tmetric.create(key.upper())
        assert type(m).__name__ == jcls.__name__
    m = tmetric.Accuracy()
    assert tmetric.create(m) is m
    assert tmetric.PCC is tmetric.MCC
    with pytest.raises(KeyError):
        tmetric.create("no_such_metric")
    assert set(tmetric.__all__) >= set(jmetric.__all__)


# ----------------------------------------------------------------- trainer
def _net(seed):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
    net.initialize(ctx="cpu", seed=seed)
    net.hybridize()
    return net


def _batch(seed):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(8, 6).astype(np.float32)),
            torch.from_numpy(rs.randint(0, 4, (8,))))


def _twins():
    x, _ = _batch(0)
    a, b = _net(0), _net(1)
    a(x)
    b(x)
    load_numpy(b, {k: t.detach().numpy()
                   for k, t in a.collect_params().items()})
    return a, b


def _grads(net, loss_fn, x, y):
    with tautograd.record():
        loss = loss_fn(net(x), y)
    loss.backward(torch.ones_like(loss))


def _weights(net):
    return [t.detach().clone() for t in net.collect_params().values()]


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_allreduce_grads_then_update_equals_step(fused):
    """``allreduce_grads(); update(bs)`` against ``step(bs)`` bit for bit
    over four SGD-momentum steps; with ``fused`` the second net's
    trainer also holds a live ``fuse_step`` executor that takes steps 2
    and 4, so the idiom's steps and the executor's share one state."""
    loss_fn = tloss.SoftmaxCrossEntropyLoss()
    net_s, net_u = _twins()
    kw = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}
    tr_s = Trainer(net_s.collect_params(), "sgd", kw)
    tr_u = Trainer(net_u.collect_params(), "sgd", kw)
    ex = tr_u.fuse_step(loss_fn) if fused else None
    for i in range(4):
        x, y = _batch(i)
        _grads(net_s, loss_fn, x, y)
        tr_s.step(8)
        if ex is not None and i % 2:
            ex(x, y)
        else:
            _grads(net_u, loss_fn, x, y)
            tr_u.allreduce_grads()
            tr_u.update(8)
    assert tr_u.optimizer.num_update == tr_s.optimizer.num_update == 4
    for a, b in zip(_weights(net_s), _weights(net_u)):
        assert torch.equal(a, b)
    if ex is not None:
        assert ex.fused


def test_shard_batch_without_a_mesh_returns_its_arguments():
    net, _ = _twins()
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    x, y = _batch(0)
    assert tr.shard_batch(x) is x
    xs = tr.shard_batch(x, y)
    assert isinstance(xs, tuple) and xs[0] is x and xs[1] is y
    with pytest.raises(NotImplementedError, match="item 7"):
        Trainer(net.collect_params(), "sgd", mesh=object())


# -------------------------------------------------------- top-level names
TOP_LEVEL = ["lr_scheduler", "init", "seed", "random", "waitall",
             "Optimizer", "current_context", "current_device"]


@pytest.mark.parametrize("name", TOP_LEVEL)
def test_top_level_name_exists_in_both_packages(name):
    assert hasattr(jmx, name) and hasattr(tmx, name)
    assert name in tmx.__all__


def test_top_level_names_behave():
    assert tmx.init is tmx.initializer
    assert tmx.lr_scheduler.FactorScheduler(step=2, factor=0.5,
                                            base_lr=0.1)(4) == \
        jmx.lr_scheduler.FactorScheduler(step=2, factor=0.5,
                                         base_lr=0.1)(4)
    assert issubclass(tmx.optimizer.SGD, tmx.Optimizer)
    assert tmx.waitall() is None
    if torch.cuda.is_available():
        assert tmx.current_context().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmx.current_context()
    assert tmx.gluon.metric is tmetric


def test_seed_reaches_numpy_stdlib_and_the_samplers():
    tmx.seed(11)
    a = (np.random.rand(3), pyrandom.random(),
         tmx.random.uniform(size=(4,), device="cpu"))
    tmx.seed(11)
    b = (np.random.rand(3), pyrandom.random(),
         tmx.random.uniform(size=(4,), device="cpu"))
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]
    assert torch.equal(a[2], b[2])
    np.random.seed(11)
    np.testing.assert_array_equal(np.random.rand(3), a[0])


# ------------------------------------------------------------------ random
N = 100_000
GUMBEL_MEAN = 0.5 + 2 * 0.5772156649015329
# (name, args, kwargs, mean, variance) of each sampler's law
MOMENTS = [
    ("uniform", (2.0, 5.0), {}, 3.5, 0.75),
    ("normal", (1.0, 2.0), {}, 1.0, 4.0),
    ("randint", (0, 10), {}, 4.5, 8.25),
    ("choice", (5,), {"p": np.array([0.1, 0.2, 0.3, 0.2, 0.2])}, 2.2,
     1.56),
    ("beta", (2.0, 3.0), {}, 0.4, 0.04),
    ("gamma", (2.0, 1.5), {}, 3.0, 4.5),
    ("exponential", (2.0,), {}, 2.0, 4.0),
    ("poisson", (3.0,), {}, 3.0, 3.0),
    ("laplace", (1.0, 2.0), {}, 1.0, 8.0),
    ("gumbel", (0.5, 2.0), {}, GUMBEL_MEAN, math.pi ** 2 / 6 * 4),
    ("logistic", (1.0, 2.0), {}, 1.0, math.pi ** 2 / 3 * 4),
    ("bernoulli", (0.3,), {}, 0.3, 0.21),
    ("lognormal", (0.1, 0.5), {}, math.exp(0.225),
     (math.exp(0.25) - 1) * math.exp(0.45)),
    ("chisquare", (4.0,), {}, 4.0, 8.0),
    ("weibull", (2.0,), {}, math.gamma(1.5), 1 - math.gamma(1.5) ** 2),
    ("pareto", (5.0,), {}, 0.25, 5 / (16 * 3)),
    ("rayleigh", (2.0,), {}, 2 * math.sqrt(math.pi / 2),
     (4 - math.pi) / 2 * 4),
    ("binomial", (10, 0.3), {}, 3.0, 2.1),
]


@pytest.mark.parametrize("name,args,kw,mean,var", MOMENTS,
                         ids=[m[0] for m in MOMENTS])
def test_sampler_shape_dtype_and_moments(name, args, kw, mean, var):
    ref = getattr(jmx.random, name)(*args, size=(2, 3), **kw)
    got = getattr(tmx.random, name)(*args, size=(2, 3), device="cpu", **kw)
    assert tuple(got.shape) == tuple(ref.shape)
    assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
    tmx.random.seed(3)
    x = getattr(tmx.random, name)(*args, size=(N,), device="cpu", **kw)
    x = x.double().numpy()
    assert abs(x.mean() - mean) <= 6 * math.sqrt(var / N), (x.mean(), mean)
    assert abs(x.var() - var) <= 0.05 * var, (x.var(), var)


def test_samplers_without_moments():
    dev = "cpu"
    r, j = tmx.random, jmx.random
    for got, ref in ((r.randn(2, 3, device=dev), j.randn(2, 3)),
                     (r.rand(4, device=dev), j.rand(4)),
                     (r.permutation(7, device=dev), j.permutation(7)),
                     (r.multinomial(10, [0.2, 0.3, 0.5], size=(4,),
                                    device=dev),
                      j.multinomial(10, [0.2, 0.3, 0.5], size=(4,))),
                     (r.categorical(torch.zeros(3, 4), size=(5, 3)),
                      j.categorical(jmx.np.zeros((3, 4)), size=(5, 3)))):
        assert tuple(got.shape) == tuple(ref.shape)
        assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
    p = r.permutation(7, device=dev)
    assert sorted(p.tolist()) == list(range(7))
    x = torch.arange(10.0)
    r.shuffle(x)
    assert sorted(x.tolist()) == list(range(10))
    counts = r.multinomial(10, [0.2, 0.3, 0.5], size=(1000,), device=dev)
    assert (counts.sum(-1) == 10).all()
    np.testing.assert_allclose(counts.double().mean(0).numpy(),
                               [2.0, 3.0, 5.0], atol=0.15)
    c = r.categorical(torch.log(torch.tensor([1.0, 2.0, 3.0])),
                      size=(N,)).double()
    assert abs(c.mean().item() - 8 / 6) <= 6 * math.sqrt(5 / 9 / N)
    drawn = r.choice(torch.arange(10, 20), size=(6,), replace=False)
    assert len(set(drawn.tolist())) == 6
    assert all(10 <= v < 20 for v in drawn.tolist())
    with pytest.raises(ValueError, match="leading axes"):
        r.categorical(torch.zeros(3, 4), size=(5, 2))


def test_same_seed_gives_the_same_stream():
    r = tmx.random

    def draws():
        return [r.normal(size=(5,), device="cpu"),
                r.randint(0, 100, size=(5,), device="cpu"),
                r.gamma(2.0, size=(5,), device="cpu"),
                r.poisson(4.0, size=(5,), device="cpu")]
    r.seed(21)
    a = draws()
    r.seed(21)
    b = draws()
    r.seed(22)
    c = draws()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_samplers_default_to_the_card():
    if torch.cuda.is_available():
        assert tmx.random.uniform(size=(2,)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmx.random.uniform(size=(2,))
