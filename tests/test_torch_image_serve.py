"""Image serving of the PyTorch port (``mxnet_tpu_torch.serve``
``InferenceEngine``, ``Batcher``, ``ModelRegistry``) against the JAX
package's on the CPU: per-bucket outputs on shared numpy weights,
coalescing and padding, admission control, timeout tombstones, loading
from a JAX-written ``.params`` file, LRU eviction and the device rule."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.models.resnet import BasicBlockV1 as JBasic  # noqa: E402
from mxnet_tpu.serve import InferenceEngine as JEngine  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import telemetry as ttel  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tgnn  # noqa: E402
from mxnet_tpu_torch.models.resnet import BasicBlockV1 as TBasic  # noqa: E402
from mxnet_tpu_torch.serve import (Batcher, InferenceEngine,  # noqa: E402
                                   ModelRegistry, QueueFull, RequestError,
                                   bucket_ladder)
from test_torch_resnet import weights_for  # noqa: E402

torch.set_num_threads(1)

ITEM = (8, 8, 3)
BUCKETS = (1, 2, 4)
TOL = 1e-4


def _tiny(nn, basic):
    """Stem conv + BN + ReLU, one residual basic block (two fused
    segments), pooling and a dense head."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, use_bias=False), nn.BatchNorm(),
            nn.Activation("relu"), basic(8, 1), nn.GlobalAvgPool2D(),
            nn.Flatten(), nn.Dense(4))
    return net


@pytest.fixture(scope="module")
def nets():
    jnet = _tiny(jgnn, JBasic)
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1,) + ITEM, np.float32)))
    params = jnet.collect_params()
    arrays = weights_for([(k, p.shape) for k, p in params.items()], 21)
    for k, p in params.items():
        p.set_data(mx.np.array(arrays[k])._data)
    return jnet, arrays


def _port(arrays):
    net = _tiny(tgnn, TBasic)
    tgluon.load_numpy(net, arrays)
    return net


def _ref(jnet, x):
    return np.asarray(jnet(mx.np.array(x))._data)


def _close(out, ref):
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= TOL * np.abs(ref).max()


def _images(n, seed=0):
    return np.random.RandomState(seed).randn(n, *ITEM).astype(np.float32)


def _counters():
    return dict(ttel.raw_snapshot()["counters"])


def _delta(before, name):
    return _counters().get(name, 0) - before.get(name, 0)


# ------------------------------------------------------------------ engine
def test_engine_matches_reference_engine_per_bucket(nets):
    jnet, arrays = nets
    jeng = JEngine(jnet, ITEM, buckets=BUCKETS, name="jtiny").warmup()
    teng = InferenceEngine(_port(arrays), ITEM, buckets=BUCKETS,
                           name="ttiny", device="cpu").warmup()
    for b in BUCKETS:
        x = _images(b, seed=b)
        out = teng.run(x)
        assert len(out) == 1 and out[0].device.type == "cpu"
        _close(out[0].numpy(), np.asarray(jeng.run(x)[0]))
    js, ts = jeng.stats(), teng.stats()
    assert set(js) <= set(ts)
    assert ts["retraces"] == 0 and ts["rebuilds"] == 0
    assert ts["programs"] == len(BUCKETS) and ts["ready"]
    assert ts["buckets"] == list(BUCKETS) and ts["precision"] == "fp32"


def test_engine_needs_an_exact_bucket_and_item_shape(nets):
    eng = InferenceEngine(_port(nets[1]), ITEM, buckets=BUCKETS,
                          device="cpu")
    with pytest.raises(ValueError):
        eng.run(_images(3))
    with pytest.raises(ValueError):
        eng.run(np.zeros((2, 8, 8, 4), np.float32))
    assert [eng.bucket_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    with pytest.raises(ValueError):
        eng.bucket_for(5)


def test_engine_resolves_deferred_shapes_on_a_fresh_net():
    net = _tiny(tgnn, TBasic)
    net.initialize(seed=1, ctx="cpu")
    eng = InferenceEngine(net, ITEM, buckets=(2,), device="cpu").warmup()
    assert eng.run(_images(2))[0].shape == (2, 4)


@pytest.mark.parametrize("kw", [dict(precision="bf16"),
                                dict(precision="bfloat16"),
                                dict(mesh=object()),
                                dict(sharding_plan=object())])
def test_engine_refuses_what_later_slices_bring(nets, kw):
    """Meshes and sharding plans still raise.  bf16 (either spelling) is
    served: the net cast to bf16, float items run as bf16, bf16 outputs
    (``test_torch_bf16_serve.py`` holds them against the reference's);
    int8 is served too (``test_torch_int8_serve.py``)."""
    if "precision" not in kw:
        with pytest.raises(NotImplementedError):
            InferenceEngine(_port(nets[1]), ITEM, device="cpu", **kw)
        return
    eng = InferenceEngine(_port(nets[1]), ITEM, buckets=(2,), device="cpu",
                          **kw)
    assert eng.precision == "bf16"
    assert eng.stats()["dtype"] == "bfloat16"
    out = eng.run(_images(2))[0]
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 4)
    assert torch.isfinite(out).all()


def test_precision_env_and_bucket_ladder(nets, monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_PRECISION", "int8")
    eng = InferenceEngine(_port(nets[1]), ITEM, buckets=(1,), device="cpu")
    assert eng.precision == eng.stats()["precision"] == "int8"
    assert eng.run(_images(1))[0].shape == (1, 4)
    monkeypatch.setenv("MXNET_SERVE_PRECISION", "bf16")
    eng = InferenceEngine(_port(nets[1]), ITEM, buckets=(1,), device="cpu")
    assert eng.precision == eng.stats()["precision"] == "bf16"
    assert eng.run(_images(1))[0].dtype == torch.bfloat16
    monkeypatch.delenv("MXNET_SERVE_PRECISION")
    assert bucket_ladder((8, 1, 4, 2, 4)) == (1, 2, 4, 8)
    monkeypatch.setenv("MXNET_SERVE_BUCKETS", "2, 4,16")
    assert bucket_ladder() == (2, 4, 16)
    monkeypatch.delenv("MXNET_SERVE_BUCKETS")
    assert bucket_ladder() == (1, 2, 4, 8)
    with pytest.raises(ValueError):
        bucket_ladder((0, 2))


def test_no_card_and_no_device_raises(nets, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(_port(nets[1]), ITEM)
    path = str(tmp_path / "tiny.params")
    _port(nets[1]).save_parameters(path)
    with ModelRegistry() as reg:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            reg.load("tiny", path, net=_tiny(tgnn, TBasic), item_shape=ITEM)


# ----------------------------------------------------------------- batcher
@pytest.fixture(scope="module")
def engine(nets):
    return InferenceEngine(_port(nets[1]), ITEM, buckets=BUCKETS,
                           name="bat", device="cpu").warmup()


def test_partial_batch_coalesces_pads_and_matches_unbatched(nets, engine):
    jnet = nets[0]
    xs = _images(3, seed=5)
    before = _counters()
    with Batcher(engine, max_wait_ms=2000) as bat:
        reqs = [bat.submit_async(x) for x in xs]
        for r in reqs:
            assert r.event.wait(60)
    assert _delta(before, "serve.batches") == 1
    assert _delta(before, "serve.coalesced_batches") == 1
    assert _delta(before, "serve.padded") == 1      # 3 items → bucket 4
    assert _delta(before, "serve.admitted") == 3
    for x, r in zip(xs, reqs):
        assert r.error is None and r.result[0].shape == (1, 4)
        _close(r.result[0], _ref(jnet, x[None]))
        # against the port's own unbatched forward: close, not bitwise
        _close(r.result[0], engine.run(x[None])[0].numpy())


def test_lone_request_flushes_at_the_deadline(engine):
    x = _images(1, seed=6)[0]
    with Batcher(engine, max_wait_ms=30) as bat:
        t0 = time.perf_counter()
        out = bat.submit(x, timeout=60)
        dt = time.perf_counter() - t0
    assert out[0].shape == (1, 4)
    assert dt >= 0.025             # waited for company, then flushed


def test_multi_item_requests_and_bad_shapes(engine):
    xs = _images(2, seed=7)
    with Batcher(engine, max_wait_ms=1) as bat:
        out = bat.submit(xs, timeout=60)
        assert out[0].shape == (2, 4)
        _close(out[0], engine.run(xs)[0].numpy())
        with pytest.raises(ValueError):
            bat.submit(_images(5))                # > max bucket
        with pytest.raises(ValueError):
            bat.submit(np.zeros((8, 8, 4), np.float32))
    with pytest.raises(RuntimeError):
        bat.submit(xs[0])                         # closed


class _GateEngine:
    """Stands in for an engine whose forward blocks until released, so
    the tests can fill the queue behind it."""

    item_shape, dtype, buckets = (2,), np.dtype(np.float32), (1, 2, 4)
    max_bucket, name, device = 4, "gate", torch.device("cpu")

    def __init__(self, fail=False):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.rows = []
        self.fail = fail

    def bucket_for(self, n):
        return next(b for b in self.buckets if n <= b)

    def run(self, x):
        self.rows.append(x.copy())
        self.entered.set()
        assert self.release.wait(60)
        if self.fail:
            raise RuntimeError("device fault")
        return (torch.from_numpy(x * 2),)


def test_queue_full_rejects_at_admission():
    eng = _GateEngine()
    before = _counters()
    bat = Batcher(eng, max_wait_ms=0, queue_depth=2)
    first = bat.submit_async(np.ones(2, np.float32))
    assert eng.entered.wait(30)                   # the loop is busy
    queued = [bat.submit_async(np.ones(2, np.float32)) for _ in range(2)]
    with pytest.raises(QueueFull):
        bat.submit_async(np.ones(2, np.float32))
    assert _delta(before, "serve.rejected") == 1
    assert bat.retry_after_s() > 0
    eng.release.set()
    for r in [first] + queued:
        assert r.event.wait(30) and r.error is None
    bat.close()
    assert not bat._thread.is_alive()


def test_timed_out_request_is_tombstoned_and_never_run():
    eng = _GateEngine()
    before = _counters()
    with Batcher(eng, max_wait_ms=0) as bat:
        bat.submit_async(np.full(2, 1, np.float32))
        assert eng.entered.wait(30)
        with pytest.raises(TimeoutError):
            bat.submit(np.full(2, 7, np.float32), timeout=0.05)
        eng.release.set()
        out = bat.submit(np.full(2, 3, np.float32), timeout=30)
    np.testing.assert_array_equal(out[0], np.full((1, 2), 6, np.float32))
    assert _delta(before, "serve.abandoned") == 1
    # the engine never saw the abandoned item (all 7s)
    assert not any((rows == 7).all(axis=1).any() for rows in eng.rows)


def test_loop_thread_warms_before_the_constructor_returns(engine):
    seen = []
    orig = engine.warm_thread

    def record():
        seen.append(threading.current_thread().name)
        orig()

    engine.warm_thread = record
    try:
        bat = Batcher(engine, name="warm")
        assert seen == ["serve-batcher-warm"]       # done, on the loop
        bat.close()

        def broken():
            raise RuntimeError("no handle")
        engine.warm_thread = broken
        with pytest.raises(RuntimeError, match="no handle"):
            Batcher(engine, name="broken")
    finally:
        del engine.warm_thread


def test_device_error_reaches_every_request_of_the_batch():
    eng = _GateEngine(fail=True)
    eng.release.set()
    before = _counters()
    with Batcher(eng, max_wait_ms=500) as bat:
        reqs = [bat.submit_async(np.ones(2, np.float32)) for _ in range(2)]
        for r in reqs:
            assert r.event.wait(30)
        with pytest.raises(RequestError):
            bat.submit(np.ones(2, np.float32), timeout=30)
    assert all(isinstance(r.error, RuntimeError) for r in reqs)
    assert _delta(before, "serve.errors") == 2


# ---------------------------------------------------------------- registry
def test_registry_loads_a_reference_params_file(nets, tmp_path):
    jnet = nets[0]
    path = str(tmp_path / "tiny.params")
    jnet.save_parameters(path)
    x = _images(1, seed=9)[0]
    with ModelRegistry(buckets=(1, 2), device="cpu") as reg:
        entry = reg.load("tiny", path, net=_tiny(tgnn, TBasic),
                         item_shape=ITEM)
        assert entry.engine.ready and entry.source == path
        out = reg.predict("tiny", x, timeout=60)
        assert reg.stats()["models"]["tiny"]["batcher"]["closed"] is False
    _close(out[0], _ref(jnet, x[None]))


def test_registry_builds_the_zoo_arch_from_a_params_file(tmp_path):
    from mxnet_tpu_torch.models import get_model
    src = get_model("resnet18_v1", classes=5)
    src.initialize(seed=2, ctx="cpu")
    src(torch.zeros(1, 16, 16, 3))          # deferred shapes, then save
    path = str(tmp_path / "r18.params")
    src.save_parameters(path)
    x = np.random.RandomState(4).rand(16, 16, 3).astype(np.float32)
    with ModelRegistry(buckets=(1,), device="cpu") as reg:
        reg.load("r18", path, arch="resnet18_v1", classes=5,
                 item_shape=(16, 16, 3))
        out = reg.predict("r18", x, timeout=60)[0]
    with torch.inference_mode():
        ref = src(torch.from_numpy(x[None])).numpy()
    _close(out, ref)
    with ModelRegistry(device="cpu") as reg:
        with pytest.raises(NotImplementedError, match="checkpoint"):
            reg.load("ckpt", str(tmp_path), arch="resnet18_v1",
                     item_shape=(16, 16, 3))
        with pytest.raises(ValueError):
            reg.load("r18", path, item_shape=(16, 16, 3))   # no net/arch


def test_registry_lru_eviction_closes_the_batcher(nets):
    before = _counters()
    with ModelRegistry(max_models=2, buckets=(1,), device="cpu") as reg:
        a = reg.register("a", _port(nets[1]), ITEM)
        reg.register("b", _port(nets[1]), ITEM)
        reg.predict("a", _images(1)[0], timeout=60)     # a is now fresh
        reg.register("c", _port(nets[1]), ITEM)
        assert reg.names() == ["a", "c"]
        assert _delta(before, "serve.evictions") == 1
        with pytest.raises(KeyError):
            reg.predict("b", _images(1)[0])
        reg.register("a", _port(nets[1]), ITEM)          # a warm swap
        assert a.batcher.stats()["closed"]
        assert _delta(before, "serve.swaps") == 1
        assert reg.names() == ["c", "a"]
