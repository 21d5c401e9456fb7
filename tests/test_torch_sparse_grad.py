"""Row-sparse gradients in the port: ``sparse.RowSparseNDArray``, the
optimizers' lazy update (``Optimizer.update`` on a row-sparse gradient),
``Embedding(sparse_grad=True)`` trained by ``gluon.Trainer`` (and by
``Trainer.fuse_step``, which falls back to the legacy step), and
``Dropout(axes=)``.  Held against the JAX package on the CPU from
``RandomState`` inputs.

Tolerances.  The lazy rules against the reference's ``update`` (op by
op): bit for bit where the port does the same operations in the same
order, else ``rtol`` 1e-6 with ``atol`` 1e-7 where a rule takes a square
root or a per-tensor norm (``test_torch_optimizer_zoo``'s reasons, its
tables reused).  SGLD's noise is made the same function of the shape on
both sides (``same_noise``), so its touched rows are held whole.
Trainer runs against the reference's: ``rtol`` 1e-5, ``atol`` 1e-6 on
every weight after each step (the embedding's scatter-add and the dense
products sum in another order; Adam's normalisation can bring a
last-bit difference up to a few ulps over 5 steps).  Rows and states the
lazy rule must not touch are held bit for bit, always."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import autograd as jautograd  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu import sparse as jsparse  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu.ndarray import NDArray  # noqa: E402
from mxnet_tpu_torch import autograd, telemetry  # noqa: E402
from mxnet_tpu_torch import optimizer as topt  # noqa: E402
from mxnet_tpu_torch.gluon import Trainer, load_numpy, nn  # noqa: E402
from mxnet_tpu_torch.gluon.loss import L2Loss  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402
from mxnet_tpu_torch.sparse import RowSparseNDArray  # noqa: E402
from test_torch_optimizer_zoo import (ATOL, EXACT, RTOL, _lr,  # noqa: E402
                                      same_noise)  # noqa: F401

torch.set_num_threads(1)

# the eighteen rules (two also with lazy_update off: the dense rule on
# the densified gradient)
LAZY = [("sgd", {"momentum": 0.9}), ("nag", {"momentum": 0.9}),
        ("adam", {}), ("adamw", {}), ("adamax", {}), ("nadam", {}),
        ("adagrad", {}), ("adadelta", {}), ("adabelief", {}),
        ("rmsprop", {"centered": True}), ("ftrl", {}), ("ftml", {}),
        ("lamb", {}), ("lars", {}), ("lans", {}), ("signum", {}),
        ("sgld", {}), ("dcasgd", {"momentum": 0.9}),
        ("sgd", {"momentum": 0.9, "lazy_update": False}),
        ("adam", {"lazy_update": False})]
EXTRA = {"wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.8}
ROWS = ([1, 4, 6], [0, 4], [4])         # each step's touched rows of 8
UNTOUCHED = [2, 3, 5, 7]


def _assert(exact, got, want, what):
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)


@pytest.mark.parametrize("name,kw", LAZY, ids=str)
def test_lazy_update_matches_reference(name, kw, same_noise):
    """Three row-sparse steps of one key (rows of each step in
    ``ROWS``), with weight decay, rescaling and clipping: the weight and
    every state as the reference's ``Optimizer.update`` on a
    ``RowSparseNDArray``; with ``lazy_update`` the rows no step touched,
    and their states, bit for bit as they started."""
    rs = np.random.RandomState(0)
    w0 = rs.randn(8, 3).astype(np.float32)
    args = dict(learning_rate=_lr(name), **EXTRA, **kw)
    jo, to = jopt.create(name, **args), topt.create(name, **args)
    jw, tw = NDArray(jnp.asarray(w0)), torch.from_numpy(w0.copy())
    js = {k: jnp.array(v, copy=True)
          for k, v in jo.create_state(0, jw).items()}
    ts = to.create_state(0, tw)
    s0 = {k: v.clone() for k, v in ts.items()}
    exact = name in EXACT + ("sgd", "nag")
    for step, rows in enumerate(ROWS):
        g = (2 * rs.randn(len(rows), 3)).astype(np.float32)
        jo.update("w", jw, jsparse.RowSparseNDArray(
            g, np.array(rows, np.int64), w0.shape), js)
        to.update("w", tw, RowSparseNDArray(torch.from_numpy(g),
                                            torch.tensor(rows), w0.shape),
                  ts)
        _assert(exact, tw.numpy(), np.asarray(jw._data), f"weight {step}")
        assert sorted(ts) == sorted(k for k in js if k != "key")
        for k in ts:
            _assert(exact, ts[k].numpy(), np.asarray(js[k]),
                    f"state {k} {step}")
    assert to._index_update_count == jo._index_update_count == {"w": 3}
    assert to.num_update == jo.num_update == 3
    if args.get("lazy_update", True):
        np.testing.assert_array_equal(tw.numpy()[UNTOUCHED], w0[UNTOUCHED])
        for k in ts:
            np.testing.assert_array_equal(ts[k][UNTOUCHED].numpy(),
                                          s0[k][UNTOUCHED].numpy())


# ----------------------------------- the reference's own cases, mirrored
def _row_sparse(rows, vals, shape):
    return RowSparseNDArray(torch.tensor(np.asarray(vals, "float32")),
                            torch.tensor(rows), shape)


def test_lazy_sgd_matches_dense_on_touched_rows():
    rng = np.random.RandomState(0)
    w0 = rng.rand(6, 4).astype("f")
    g_rows = rng.rand(2, 4).astype("f")
    rows = [1, 4]
    dense_g = np.zeros_like(w0)
    dense_g[rows] = g_rows
    opt_d = topt.create("sgd", learning_rate=0.1)
    wd_ = torch.from_numpy(w0.copy())
    opt_d.update("w", wd_, torch.from_numpy(dense_g),
                 opt_d.create_state("w", wd_))
    opt_s = topt.create("sgd", learning_rate=0.1)
    ws = torch.from_numpy(w0.copy())
    opt_s.update("w", ws, _row_sparse(rows, g_rows, w0.shape),
                 opt_s.create_state("w", ws))
    np.testing.assert_allclose(ws.numpy(), wd_.numpy(), atol=1e-6)


def test_lazy_momentum_skips_untouched_rows():
    rng = np.random.RandomState(1)
    w0 = rng.rand(5, 3).astype("f")
    opt = topt.create("sgd", learning_rate=0.1, momentum=0.9)
    w = torch.from_numpy(w0.copy())
    st = opt.create_state("w", w)
    for _ in range(2):
        opt.update("w", w, _row_sparse([2], rng.rand(1, 3), w0.shape), st)
    untouched = [0, 1, 3, 4]
    np.testing.assert_array_equal(w.numpy()[untouched], w0[untouched])
    assert not np.allclose(w.numpy()[2], w0[2])
    assert (st["mom"][untouched] == 0).all()


def test_lazy_adam_rows():
    rng = np.random.RandomState(2)
    w0 = rng.rand(6, 2).astype("f")
    opt = topt.create("adam", learning_rate=0.01)
    w = torch.from_numpy(w0.copy())
    opt.update("w", w, _row_sparse([0, 3], rng.rand(2, 2), w0.shape),
               opt.create_state("w", w))
    np.testing.assert_array_equal(w.numpy()[[1, 2, 4, 5]],
                                  w0[[1, 2, 4, 5]])
    assert not np.allclose(w.numpy()[[0, 3]], w0[[0, 3]])


def test_embedding_sparse_grad_training_parity():
    """Embedding(sparse_grad=True) trains as the dense path does (plain
    SGD, no wd: lazy and dense agree on the touched rows)."""
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.randint(0, 20, (8, 5)).astype("int32"))
    Y = torch.from_numpy(rng.rand(8, 5, 1).astype("f"))
    outs = []
    for sparse in (False, True):
        net = nn.HybridSequential()
        net.add(nn.Embedding(20, 8, sparse_grad=sparse),
                nn.Dense(1, flatten=False))
        net.initialize(ctx="cpu", seed=7)
        tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.2},
                     kvstore=None)
        for _ in range(5):
            with autograd.record():
                loss = L2Loss()(net(X), Y).mean()
            loss.backward()
            tr.step(1)
        outs.append(net(X).detach().numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)


def test_from_dense_rows():
    d = torch.zeros(5, 3)
    d[1] = 2.0
    d[4] = -1.0
    d[2, 1] = float("nan")              # NaN is non-zero, as g != 0 says
    rs = RowSparseNDArray.from_dense(d)
    assert rs.stype == "row_sparse" and rs.shape == (5, 3)
    assert rs.indices.dtype == torch.int64
    assert rs.indices.tolist() == [1, 2, 4]
    np.testing.assert_array_equal(rs.tostype("default").numpy(), d.numpy())
    assert rs.tostype("row_sparse") is rs
    with pytest.raises(ValueError):
        RowSparseNDArray(torch.zeros(2, 3), torch.tensor([0]), (5, 3))
    with pytest.raises(ValueError):
        rs.tostype("csr")


# ------------------------------------------- the Trainer, both packages
V, E, T, NB = 20, 8, 5, 4
ZERO_ROW = 19       # indexed only where the output is masked: zero gradient
NEVER = list(range(12, 19))


class TNet(nn.HybridBlock):
    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(V, E, sparse_grad=True)
        self.out = nn.Dense(1, flatten=False)

    def forward(self, x, keep, h=None):
        return self.out(self.emb(x) * keep if h is None else h)


class JNet(jnn.HybridBlock):
    def __init__(self):
        super().__init__()
        self.emb = jnn.Embedding(V, E, sparse_grad=True)
        self.out = jnn.Dense(1, flatten=False)

    def forward(self, x, keep, h=None):
        return self.out(self.emb(x) * keep if h is None else h)


def _pair(name, kw):
    rs = np.random.RandomState(11)
    arrays = {"emb.weight": rs.randn(V, E).astype(np.float32),
              "out.weight": rs.randn(1, E).astype(np.float32),
              "out.bias": np.zeros(1, np.float32)}
    keep = np.ones((1, T, 1), np.float32)
    keep[0, 0, 0] = 0.0
    net = TNet()
    net.initialize(ctx="cpu", seed=0)
    net(torch.zeros(1, T, dtype=torch.int32), torch.from_numpy(keep))
    load_numpy(net, arrays)
    jnet = JNet()
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1, T), np.int32)), mx.np.array(keep))
    for k, p in jnet.collect_params().items():
        p.set_data(jnp.asarray(arrays[k]))
    tr = Trainer(net.collect_params(), name, dict(kw))
    jtr = jgluon.Trainer(jnet.collect_params(), name, dict(kw),
                         kvstore=None)
    return net, tr, jnet, jtr, keep, arrays


def _batch(i):
    rs = np.random.RandomState(100 + i)
    x = rs.randint(0, 12, (NB, T)).astype(np.int32)
    x[0, 0] = ZERO_ROW
    return x, rs.randn(NB, T, 1).astype(np.float32)


def _steps(net, tr, jnet, jtr, keep, i, bypass=False):
    x, y = _batch(i)
    h = np.random.RandomState(200 + i).randn(NB, T, E).astype(np.float32)
    th = torch.from_numpy(h) if bypass else None
    jh = mx.np.array(h) if bypass else None
    with autograd.record():
        loss = L2Loss()(net(torch.from_numpy(x), torch.from_numpy(keep),
                            th), torch.from_numpy(y)).mean()
    loss.backward()
    tr.step(1, ignore_stale_grad=bypass)
    with jautograd.record():
        jl = jgluon.loss.L2Loss()(jnet(mx.np.array(x), mx.np.array(keep),
                                       jh), mx.np.array(y)).mean()
    jl.backward()
    jtr.step(1, ignore_stale_grad=bypass)


def _assert_same(net, jnet, what):
    jp = jnet.collect_params()
    for k, t in net.collect_params().items():
        np.testing.assert_allclose(t.detach().numpy(),
                                   np.asarray(jp[k].data()._data),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.05, "wd": 1e-3})])
def test_trainer_sparse_embedding_matches_reference(name, kw):
    """Five steps: every weight as the reference's after each; the rows
    never indexed and the indexed row whose gradient is exactly zero
    (``ZERO_ROW``) stay bit for bit as they started, with their states
    at zero; the step counts as the reference's."""
    net, tr, jnet, jtr, keep, arrays = _pair(name, kw)
    for i in range(5):
        _steps(net, tr, jnet, jtr, keep, i)
        _assert_same(net, jnet, f"step {i}")
    w = net.emb.weight.detach().numpy()
    stay = NEVER + [ZERO_ROW]
    np.testing.assert_array_equal(w[stay], arrays["emb.weight"][stay])
    for s in tr._states["emb.weight"].values():
        assert (s[stay] == 0).all()
    opt, jopt_ = tr.optimizer, jtr._optimizer
    assert opt.num_update == jopt_.num_update == 5
    assert opt._index_update_count == jopt_._index_update_count


def test_trainer_lagging_sparse_count():
    """Step 2 bypasses the embedding (no gradient, ``ignore_stale_grad``):
    its key's count lags, so at step 3 ``num_update`` = max(2, 2) and the
    dense parameters take t = 2 again, as in the reference."""
    net, tr, jnet, jtr, keep, _ = _pair("adam", {"learning_rate": 0.05})
    want = [(1, 1), (2, 1), (2, 2)]     # (num_update, the key's count)
    for i, bypass in enumerate((False, True, False)):
        _steps(net, tr, jnet, jtr, keep, i, bypass=bypass)
        _assert_same(net, jnet, f"step {i}")
        for opt in (tr.optimizer, jtr._optimizer):
            assert (opt.num_update,
                    opt._index_update_count.get("emb.weight")) == want[i]


def test_save_states_round_trip(tmp_path):
    """A sparse key's states and count go through ``save_states`` /
    ``load_states`` like any other's: a trainer restored from the file
    takes the next step bit for bit as the one that wrote it."""
    net, tr, jnet, jtr, keep, arrays = _pair("adam", {"learning_rate": 0.05})
    for i in range(2):
        _steps(net, tr, jnet, jtr, keep, i)
    fname = str(tmp_path / "states.npz")
    tr.save_states(fname)
    net2 = TNet()
    net2.initialize(ctx="cpu", seed=0)
    net2(torch.zeros(1, T, dtype=torch.int32), torch.from_numpy(keep))
    load_numpy(net2, {k: t.detach().numpy()
                      for k, t in net.collect_params().items()})
    tr2 = Trainer(net2.collect_params(), "adam", {"learning_rate": 0.05})
    tr2.load_states(fname)
    assert tr2.optimizer._index_update_count == \
        tr.optimizer._index_update_count
    assert tr2.optimizer.num_update == tr.optimizer.num_update
    for n, st in tr._states.items():
        for k, v in st.items():
            assert torch.equal(tr2._states[n][k], v), (n, k)
    x, y = _batch(9)
    for m, t in ((net, tr), (net2, tr2)):
        with autograd.record():
            loss = L2Loss()(m(torch.from_numpy(x), torch.from_numpy(keep)),
                            torch.from_numpy(y)).mean()
        loss.backward()
        t.step(1)
    for k, p in net.collect_params().items():
        assert torch.equal(p, net2.collect_params()[k]), k


def test_fuse_step_fallback_equals_plain_loop():
    """``fuse_step`` on a hybridized net with a sparse embedding falls
    back as ``sparse_param``; its legacy steps give the plain loop's
    weights bit for bit."""
    rs = np.random.RandomState(3)
    batches = [(torch.from_numpy(rs.randint(0, 12, (NB, T)).astype(
        np.int32)), torch.from_numpy(rs.randn(NB, T, 1).astype(np.float32)))
        for _ in range(3)]
    nets = []
    for _ in range(2):
        net = nn.HybridSequential()
        net.add(nn.Embedding(V, E, sparse_grad=True),
                nn.Dense(1, flatten=False))
        net.initialize(ctx="cpu", seed=5)
        net.hybridize()
        nets.append(net)
    trs = [Trainer(n.collect_params(), "adam", {"learning_rate": 0.05})
           for n in nets]
    step = trs[0].fuse_step(L2Loss())
    assert step.fallback_reason == "sparse_param"
    c0 = telemetry.raw_snapshot()["counters"].get(
        "fused.fallback.sparse_param", 0)
    for x, y in batches:
        step(x, y)
        with autograd.record():
            loss = L2Loss()(nets[1](x), y)
        loss.backward(torch.ones_like(loss))
        trs[1].step(NB)
    assert telemetry.raw_snapshot()["counters"][
        "fused.fallback.sparse_param"] == c0 + 3
    for k, p in nets[0].collect_params().items():
        assert torch.equal(p, nets[1].collect_params()[k]), k
    assert (nets[0][0].weight[12:] ==
            nets[1][0].weight[12:]).all()


# ------------------------------------------------------------- blocks
def test_embedding_sparse_grad_marks_the_weight():
    e = nn.Embedding(20, 4, sparse_grad=True)
    e.initialize(ctx="cpu", seed=0)
    assert e.weight.grad_stype == "row_sparse"
    assert getattr(nn.Embedding(20, 4).weight, "grad_stype",
                   "default") == "default"


@pytest.mark.parametrize("training", [False, True])
def test_dropout_axes_drops_element_by_element(training):
    """``axes`` is taken and not used, as in the reference: in training
    the draws are ``Dropout(rate)``'s from the same generator, one per
    element (the mask differs along axis 1); outside it, the identity."""
    x = torch.randn(4, 64, 3)
    gens = [torch.Generator().manual_seed(1) for _ in range(2)]
    a = nn.Dropout(0.5, axes=(1,), generator=gens[0])
    b = nn.Dropout(0.5, generator=gens[1])
    if training:
        with autograd.record():
            ya, yb = a(x), b(x)
        assert torch.equal(ya, yb)
        kept = ya != 0
        assert (kept.any(dim=1) & ~kept.all(dim=1)).any()
        assert torch.equal(ya, tnn.dropout(
            x, 0.5, torch.Generator().manual_seed(1)))
    else:
        assert a(x) is x
