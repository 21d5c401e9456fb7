"""int8 thresholds calibrated from telemetry in the port
(``quantization.observe_activations`` / ``thresholds_from_telemetry``)
against the JAX package's on the CPU.

- the reference's cases: a scoring run under the hooks gives ``naive``
  thresholds equal to the direct max |x| (the ×1e6 gauge, 2e-6 of the
  value), and ``entropy`` re-expands the registry's buckets onto the KL
  grid (below amax for a gaussian tail, the naive gauge without a
  histogram);
- on shared weights and the same batches the port's ``naive`` and
  ``entropy`` thresholds equal the reference's: ``NAIVE_TOL`` of the
  threshold (the gauge's 1e-6 resolution), ``ENTROPY_TOL`` of the
  threshold (a value a bucket edge apart moves it);
- a ResNet-18 at 48x48 (each residual branch's last γ damped by 0.1)
  has every quantizable layer observed while its blocks take the fused
  route (``fused_conv_bn_relu`` → ``residual_block``), its thresholds
  the reference's (layer by layer) within ``NAIVE_TOL``, and
  ``quantize_net(thresholds=)`` takes them without calibration data;
- the hooks' batched histogram write equals ``observe`` value by value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import quantization as jq  # noqa: E402
from mxnet_tpu import telemetry as jtel  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import quantization as tq  # noqa: E402
from mxnet_tpu_torch import telemetry as ttel  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from test_torch_resnet import port_net, reference_net  # noqa: E402

torch.set_num_threads(1)

NAIVE_TOL = 1e-6        # of the threshold (at least 1e-6 absolute)
ENTROPY_TOL = 1e-3      # of the threshold: a bucket edge apart moves it
RESNET_ITEM = (48, 48, 3)


@pytest.fixture(autouse=True)
def _telemetry_on():
    a, b = ttel.set_enabled(True), jtel.set_enabled(True)
    yield
    ttel.set_enabled(a)
    jtel.set_enabled(b)


def _snap(tel):
    s = tel.raw_snapshot()
    return {"gauges": dict(s["gauges"]),
            "histograms": {k: dict(v) for k, v in s["histograms"].items()}}


def _window(before, after):
    """The snapshot of what was recorded between two snapshots (gauges as
    after; histogram counts as the difference)."""
    hists = {}
    for k, h in after["histograms"].items():
        p = before["histograms"].get(k)
        if p is None:
            hists[k] = h
            continue
        hists[k] = dict(h, counts=[a - b for a, b in zip(h["counts"],
                                                         p["counts"])],
                        count=h["count"] - p["count"])
    return {"gauges": after["gauges"], "histograms": hists}


def _close(a, b, tol):
    return abs(a - b) <= tol * max(1.0, abs(b))


def _dense_pair(seed=5):
    """Dense(16, relu) → Dense(4) in both packages on shared weights."""
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(16, activation="relu"), jnn.Dense(4))
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1, 8), np.float32)))
    rs = np.random.RandomState(seed)
    arrays = {}
    for k, p in jnet.collect_params().items():
        arrays[k] = (rs.randn(*p.shape) * 0.5).astype(np.float32)
        p.set_data(jnp.asarray(arrays[k]))
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(16, activation="relu"), tnn.Dense(4))
    tgluon.load_numpy(tnet, arrays)
    return jnet, tnet


def _observe(tel, q, net, batches, fwd, layers=None, sample=None):
    """Run ``batches`` through ``net`` under the hooks → the window's
    snapshot."""
    before = _snap(tel)
    h = q.observe_activations(net, layers=layers, sample=sample)
    try:
        for b in batches:
            fwd(net, b)
    finally:
        h.remove()
    return _window(before, _snap(tel)), h


def _jfwd(net, b):
    net(mx.np.array(b))


def _tfwd(net, b):
    with torch.no_grad():
        net(torch.from_numpy(b))


def test_telemetry_calibration_parity_with_minmax():
    _, net = _dense_pair()
    rs = np.random.RandomState(5)
    batches = [(rs.randn(16, 8) * 3).astype(np.float32) for _ in range(3)]
    snap, h = _observe(ttel, tq, net, batches, _tfwd, sample=64)
    th = tq.thresholds_from_telemetry(layers={"0", "1"}, snap=snap)
    direct = max(float(np.abs(b).max()) for b in batches)
    assert abs(th["0"] - direct) <= 2e-6 * max(1.0, direct), (th, direct)
    assert th["1"] > 0.0
    # the live registry reads the same; one transfer a layer and batch
    assert tq.thresholds_from_telemetry(layers={"0"})["0"] == th["0"]
    assert h.syncs == 2 * len(batches)
    assert snap["histograms"]["quant.act.0"]["count"] == 64 * 3


def test_telemetry_entropy_from_bucket_hist():
    rng = np.random.RandomState(6)
    data = np.abs(rng.randn(20000) * 0.03)
    amax = float(data.max())
    fix = data * 1e6
    counts, lo = [], 0.0
    for b in ttel.BUCKET_BOUNDS_US:
        counts.append(int(((fix > lo) & (fix <= b)).sum()))
        lo = b
    counts.append(int((fix > lo).sum()))        # +inf overflow bucket
    snap = {"gauges": {"quant.amax.fc": int(round(amax * 1e6))},
            "histograms": {"quant.act.fc": {
                "le": list(ttel.BUCKET_BOUNDS_US), "counts": counts}}}
    naive = tq.thresholds_from_telemetry(snap=snap)["fc"]
    ent = tq.thresholds_from_telemetry(mode="entropy", snap=snap)["fc"]
    assert abs(naive - amax) <= 1e-6
    assert 0.0 < ent < amax
    assert ent == jq.thresholds_from_telemetry(mode="entropy",
                                               snap=snap)["fc"]
    bare = {"gauges": dict(snap["gauges"]), "histograms": {}}
    assert tq.thresholds_from_telemetry(mode="entropy",
                                        snap=bare)["fc"] == naive
    # an all-zero layer takes the reference's floor
    zero = {"gauges": {"quant.amax.z": 0}, "histograms": {}}
    assert tq.thresholds_from_telemetry(snap=zero) == \
        jq.thresholds_from_telemetry(snap=zero) == {"z": 1e-8}


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_thresholds_equal_reference_on_same_batches(mode):
    jnet, tnet = _dense_pair(seed=9)
    rs = np.random.RandomState(9)
    batches = [(rs.randn(32, 8) * 2).astype(np.float32) for _ in range(4)]
    jsnap, _ = _observe(jtel, jq, jnet, batches, _jfwd)
    tsnap, _ = _observe(ttel, tq, tnet, batches, _tfwd)
    want = jq.thresholds_from_telemetry(layers={"0", "1"}, mode=mode,
                                        snap=jsnap)
    got = tq.thresholds_from_telemetry(layers={"0", "1"}, mode=mode,
                                       snap=tsnap)
    assert set(got) == set(want) == {"0", "1"}
    tol = NAIVE_TOL if mode == "naive" else ENTROPY_TOL
    for k in want:
        assert _close(got[k], want[k], tol), (k, got[k], want[k])
    # the input layer's statistics are the same numbers: equal buckets
    assert tsnap["histograms"]["quant.act.0"]["counts"] == \
        jsnap["histograms"]["quant.act.0"]["counts"]


def _damped_resnet18():
    jnet, arrays = reference_net("resnet18_v1", seed=4, classes=10)
    params = jnet.collect_params()
    for k, p in params.items():
        if k.endswith(".body.4.gamma"):
            arrays[k] = (0.1 * arrays[k]).astype(np.float32)
            p.set_data(jnp.asarray(arrays[k]))
    tnet = port_net("resnet18_v1", arrays, classes=10)
    tnet.eval()
    return jnet, tnet


def test_resnet_every_layer_observed_on_the_fused_route(monkeypatch):
    jnet, tnet = _damped_resnet18()
    sites = [p for _, c, p in tq._walk(tnet)
             if isinstance(c, tq._QUANTIZABLE)]
    fused = []
    real = tnn._nn.residual_block

    def counting(x, *a, **k):
        fused.append(tuple(x.shape))
        return real(x, *a, **k)
    monkeypatch.setattr(tnn._nn, "residual_block", counting)
    rs = np.random.RandomState(11)
    batches = [rs.rand(2, *RESNET_ITEM).astype(np.float32)
               for _ in range(2)]
    tsnap, h = _observe(ttel, tq, tnet, batches, _tfwd)
    # the blocks' 3x3/s1 segments ran fused: 13 a ResNet-18 forward
    assert len(fused) == 13 * len(batches)
    got = tq.thresholds_from_telemetry(layers=set(sites), snap=tsnap)
    assert sorted(got) == sorted(sites) and len(sites) == 22
    assert h.syncs == len(sites) * len(batches)
    jsnap, _ = _observe(jtel, jq, jnet, batches, _jfwd)
    want = jq.thresholds_from_telemetry(layers=set(sites), snap=jsnap)
    assert sorted(want) == sorted(sites)
    for k in sites:
        assert _close(got[k], want[k], NAIVE_TOL), (k, got[k], want[k])
    # the thresholds cover every layer: no calibration data needed
    monkeypatch.setattr(tnn._nn, "residual_block", real)
    tq.quantize_net(tnet, thresholds=got)
    twins = [b for b in tnet.modules() if isinstance(b, tq._Twin)]
    assert len(twins) == len(sites)
    assert {b._in_t for b in twins} == {got[k] for k in sites}
    with torch.no_grad():
        out = tnet(torch.from_numpy(batches[0]))
    assert out.shape == (2, 10) and torch.isfinite(out).all()


def test_remove_restores_the_layers():
    _, net = _dense_pair()
    h = tq.observe_activations(net, layers={"1"})
    assert "_mx_observe" in net[1].__dict__ and \
        "_mx_observe" not in net[0].__dict__
    h.remove()
    assert "_mx_observe" not in net[1].__dict__
    before = _snap(ttel)
    with torch.no_grad():
        net(torch.ones(2, 8))
    assert _snap(ttel)["gauges"] == before["gauges"]


def test_quant_sample_env_sets_the_subsample(monkeypatch):
    _, net = _dense_pair()
    monkeypatch.setenv("MXNET_QUANT_SAMPLE", "8")
    before = ttel.raw_snapshot()["counters"].get("quant.calib.batches", 0)
    snap, _ = _observe(ttel, tq, net, [np.ones((16, 8), np.float32)] * 2,
                       _tfwd)
    assert snap["histograms"]["quant.act.0"]["count"] == 16
    assert ttel.raw_snapshot()["counters"]["quant.calib.batches"] == \
        before + 4


def test_batched_observe_equals_observe_value_by_value():
    rs = np.random.RandomState(2)
    v = np.abs(rs.randn(512) * 10 ** rs.uniform(-1, 7, 512))
    v[:3] = [1.0, 2.5e5, 1e9]          # on a bound, past the last one
    for x in v:
        ttel.observe("test.qt_one", x)
    ttel._observe_many("test.qt_many", v)
    h = ttel.raw_snapshot()["histograms"]
    assert h["test.qt_one"]["counts"] == h["test.qt_many"]["counts"]
    assert h["test.qt_one"]["sum"] == h["test.qt_many"]["sum"]
    assert h["test.qt_one"]["count"] == h["test.qt_many"]["count"] == 512
