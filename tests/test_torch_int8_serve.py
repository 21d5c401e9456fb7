"""int8 serving of the PyTorch port (``InferenceEngine(precision=
"int8")``, ``ModelRegistry(precision=...)``, the ``Batcher``) against
the JAX package's on the CPU: the default calibration data, the
thresholds it gives, per-bucket outputs on the reference's int8 state,
an already-quantized net passed through, and batched responses against
unbatched forwards.

Tolerances: thresholds within 1e-5 relative (the calibration forwards sum
in another order); outputs on the same int8 weights and thresholds
within 1e-5 of the largest output (only the average pool's sum order
differs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import quantization as jq  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.models.resnet import BasicBlockV1 as JBasic  # noqa: E402
from mxnet_tpu.serve import InferenceEngine as JEngine  # noqa: E402
from mxnet_tpu.serve import ModelRegistry as JRegistry  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import quantization as tq  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tgnn  # noqa: E402
from mxnet_tpu_torch.models.resnet import BasicBlockV1 as TBasic  # noqa: E402
from mxnet_tpu_torch.serve import (Batcher, InferenceEngine,  # noqa: E402
                                   ModelRegistry)
from test_torch_resnet import weights_for  # noqa: E402

torch.set_num_threads(1)

ITEM = (8, 8, 3)
BUCKETS = (1, 2, 4)
THR_RTOL = 1e-5
TOL = 1e-5


def _tiny(nn, basic):
    """Stem conv + BN + ReLU, one residual basic block (two fused
    segments), pooling and a dense head."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, use_bias=False), nn.BatchNorm(),
            nn.Activation("relu"), basic(8, 1), nn.GlobalAvgPool2D(),
            nn.Flatten(), nn.Dense(4))
    return net


@pytest.fixture(scope="module")
def arrays():
    jnet = _tiny(jgnn, JBasic)
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1,) + ITEM, np.float32)))
    params = jnet.collect_params()
    return weights_for([(k, p.shape) for k, p in params.items()], 31)


def _jnet(arrays):
    net = _tiny(jgnn, JBasic)
    net.initialize()
    net(mx.np.array(np.zeros((1,) + ITEM, np.float32)))
    for k, p in net.collect_params().items():
        p.set_data(jnp.asarray(arrays[k]))
    return net


def _tnet(arrays):
    net = _tiny(tgnn, TBasic)
    tgluon.load_numpy(net, arrays)
    return net


def _images(n, seed=0):
    return np.random.RandomState(seed).randn(n, *ITEM).astype(np.float32)


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()


def _twins_j(net):
    return {p: b for _, b, p in jq._walk(net)
            if isinstance(b, (jq.QuantizedDense, jq.QuantizedConv2D))}


def _twins_t(net):
    return {p: b for _, b, p in tq._walk(net) if isinstance(b, tq._Twin)}


def _state(jnet):
    return {p: {"qw": np.asarray(b._qw._data),
                "w_scale": np.asarray(b._w_scale._data),
                "bias": None if b._bias is None else
                np.asarray(b._bias._data), "in_t": b._in_t}
            for p, b in _twins_j(jnet).items()}


def _spy(monkeypatch, module):
    """Record the calibration batches ``module.quantize_net`` gets."""
    seen = []
    orig = module.quantize_net

    def spy(net, calib_data=None, **kw):
        calib_data = [np.asarray(getattr(b, "_data", b))
                      for b in (calib_data or [])]
        seen.append(calib_data)
        return orig(net, calib_data=calib_data or None, **kw)
    monkeypatch.setattr(module, "quantize_net", spy)
    return seen


def test_engine_default_calibration_matches_reference(arrays, monkeypatch):
    """Both engines calibrate on the same two ``RandomState(0)`` batches
    shaped ``(buckets[0], *item_shape)``; the thresholds agree within
    1e-5 and, on the reference's int8 state, every bucket's output within
    1e-5 of the largest."""
    jseen, tseen = _spy(monkeypatch, jq), _spy(monkeypatch, tq)
    jeng = JEngine(_jnet(arrays), ITEM, buckets=BUCKETS, name="jq",
                   precision="int8").warmup()
    teng = InferenceEngine(_tnet(arrays), ITEM, buckets=BUCKETS, name="tq",
                           precision="int8", device="cpu").warmup()
    assert len(jseen) == len(tseen) == 1 and len(tseen[0]) == 2
    for a, b in zip(jseen[0], tseen[0]):
        assert a.shape == (1,) + ITEM
        np.testing.assert_array_equal(a, b)
    jt, tt = _twins_j(jeng.net), _twins_t(teng.net)
    assert list(jt) == list(tt) and len(tt) == 4
    for p in jt:
        assert abs(tt[p]._in_t - jt[p]._in_t) <= THR_RTOL * jt[p]._in_t
    tq.state_from_numpy(teng.net, _state(jeng.net))
    for b in BUCKETS:
        x = _images(b, seed=b)
        out = teng.run(x)[0]
        assert out.device.type == "cpu"
        _close(out.numpy(), np.asarray(jeng.run(x)[0]))
    ts = teng.stats()
    assert ts["precision"] == "int8" and ts["retraces"] == 0
    # int8 weights are buffers: counted, not collected as parameters
    assert ts["param_bytes_per_device"] > 0
    assert list(teng.net.collect_params()) == []


def test_engine_passes_an_already_quantized_net_through(arrays,
                                                        monkeypatch):
    net = _tnet(arrays)
    rs = np.random.RandomState(32)
    tq.quantize_net(net, calib_data=[rs.rand(2, *ITEM).astype(np.float32)])
    before = {p: (b, b._in_t) for p, b in _twins_t(net).items()}
    seen = _spy(monkeypatch, tq)
    eng = InferenceEngine(net, ITEM, buckets=(2,), precision="int8",
                          device="cpu")
    assert seen == []
    after = _twins_t(eng.net)
    assert {p: (b, b._in_t) for p, b in after.items()} == before
    assert eng.run(_images(2))[0].shape == (2, 4)


def test_engine_int8_takes_the_callers_calibration_data(arrays):
    calib = [np.random.RandomState(33).rand(3, *ITEM).astype(np.float32)]
    eng = InferenceEngine(_tnet(arrays), ITEM, buckets=(1,),
                          precision="int8", calib_data=calib, device="cpu")
    ref = tq.quantize_net(_tnet(arrays), calib_data=calib)
    got, want = _twins_t(eng.net), _twins_t(ref)
    assert {p: b._in_t for p, b in got.items()} == \
        {p: b._in_t for p, b in want.items()}


def test_registry_precision_and_reference_params_file(arrays, tmp_path):
    """``ModelRegistry(precision="int8")`` and a per-model override load
    a ``.params`` file written by the JAX package and serve int8; the
    reference's registry does the same with the same thresholds (within
    1e-5) and, on its int8 state, the same outputs."""
    path = str(tmp_path / "tiny.params")
    _jnet(arrays).save_parameters(path)
    x = _images(1, seed=34)[0]
    jreg = JRegistry(buckets=(1, 2), precision="int8")
    try:
        jent = jreg.register("tiny", _jnet(arrays), ITEM)
        jout = np.asarray(jreg.predict("tiny", x, timeout=60)[0])
    finally:
        jreg.close()
    with ModelRegistry(buckets=(1, 2), precision="int8",
                       device="cpu") as reg:
        ent = reg.load("tiny", path, net=_tiny(tgnn, TBasic),
                       item_shape=ITEM)
        assert ent.engine.precision == "int8"
        assert reg.stats()["models"]["tiny"]["precision"] == "int8"
        fp = reg.load("fp", path, net=_tiny(tgnn, TBasic), item_shape=ITEM,
                      precision="fp32")
        assert fp.engine.precision == "fp32" and not _twins_t(fp.net)
        jt, tt = _twins_j(jent.net), _twins_t(ent.net)
        for p in jt:
            assert abs(tt[p]._in_t - jt[p]._in_t) <= \
                THR_RTOL * jt[p]._in_t
        tq.state_from_numpy(ent.net, _state(jent.net))
        out = reg.predict("tiny", x, timeout=60)
    _close(out[0], jout)


def test_batched_int8_responses_match_unbatched(arrays):
    eng = InferenceEngine(_tnet(arrays), ITEM, buckets=BUCKETS,
                          precision="int8", device="cpu").warmup()
    xs = _images(3, seed=35)
    with Batcher(eng, max_wait_ms=2000) as bat:
        reqs = [bat.submit_async(x) for x in xs]
        for r in reqs:
            assert r.event.wait(60)
    for x, r in zip(xs, reqs):
        assert r.error is None
        _close(r.result[0], eng.run(x[None])[0].numpy())
