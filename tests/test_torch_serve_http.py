"""The HTTP front end of the PyTorch port (``mxnet_tpu_torch.serve``
``InferenceServer`` over ``ModelRegistry``) in process on port 0, held
against the JAX package's server on the CPU.

- one request to each server, both holding the same numpy weights: the
  same JSON keys and outputs within ``TOL`` of the largest |output|;
- codes: 200, 404 (unknown model, no route), 400 (bad body, bad
  Content-Length), 429 with ``Retry-After`` (a bounded queue), 500 and
  the delay / black-hole modes of ``MXNET_SERVE_FAULT`` at ``server``,
  504 (a black-holed batch);
- readiness: ``/healthz`` 503 ``warming`` until the engine is warm, then
  200; ``/v1/models``, ``/metrics``;
- the registry: ``publish`` (from a ``.params`` file and from a
  checkpoint root; a failing load leaves the old entry serving),
  ``health``, ``unregister``; a request that meets a batcher closed by a
  swap goes to the new entry."""
import http.client
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu.serve import InferenceServer as JServer  # noqa: E402
from mxnet_tpu.serve import ModelRegistry as JRegistry  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import telemetry as ttel  # noqa: E402
from mxnet_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from mxnet_tpu_torch.gluon import load_numpy  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from mxnet_tpu_torch.serve import (InferenceServer, ModelRegistry,  # noqa
                                   faults)
from mxnet_tpu_torch.serve.batcher import BatcherClosed  # noqa: E402

torch.set_num_threads(1)

ITEM = (12,)
TOL = 1e-5


def _arrays(seed):
    rs = np.random.RandomState(seed)
    return {"0.weight": rs.randn(24, 12).astype(np.float32) * 0.3,
            "0.bias": rs.randn(24).astype(np.float32) * 0.1,
            "1.weight": rs.randn(5, 24).astype(np.float32) * 0.3,
            "1.bias": rs.randn(5).astype(np.float32) * 0.1}


def _tnet(seed=0):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(24, activation="relu"), tnn.Dense(5))
    load_numpy(net, _arrays(seed))
    net.hybridize()
    return net


def _ref(net, x):
    with torch.no_grad():
        return net(torch.as_tensor(x[None])).numpy()


def _server(seed=0, warmup=True, **reg_kw):
    reg = ModelRegistry(max_models=2, device="cpu", **reg_kw)
    reg.register("web", _tnet(seed), ITEM, buckets=(1, 2, 4),
                 warmup=warmup)
    return InferenceServer(reg, host="127.0.0.1", port=0).start()


def _req(port, method, path, body=b"", headers=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers=headers or {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _body(x, model="web"):
    return json.dumps({"model": model, "inputs": x.tolist()}).encode()


def _counters():
    return ttel.raw_snapshot()["counters"]


def test_predict_matches_the_reference_server():
    x = np.random.RandomState(2).randn(3, *ITEM).astype(np.float32)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(24, activation="relu"), jnn.Dense(5))
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1,) + ITEM, np.float32)))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.np.array(_arrays(0)[k])._data)
    jnet.hybridize()
    jreg = JRegistry(max_models=1)
    jreg.register("web", jnet, ITEM, buckets=(1, 2, 4))
    jsrv = JServer(jreg, host="127.0.0.1", port=0).start()
    srv = _server()
    try:
        replies = []
        for port in (jsrv.port, srv.port):
            single = _req(port, "POST", "/v1/predict", _body(x[0]))
            batch = _req(port, "POST", "/v1/predict", _body(x))
            replies.append((single, batch))
    finally:
        jsrv.stop(close_registry=True)
        srv.stop(close_registry=True)
    (js, jb), (ts, tb) = replies
    for j, t in ((js, ts), (jb, tb)):
        assert j[0] == t[0] == 200
        jd, td = json.loads(j[2]), json.loads(t[2])
        assert sorted(jd) == sorted(td) == ["batched", "model", "outputs"]
        assert jd["batched"] == td["batched"] and jd["model"] == "web"
        a, b = np.asarray(jd["outputs"]), np.asarray(td["outputs"])
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL * np.abs(a).max()
    assert json.loads(ts[2])["batched"] is False
    assert json.loads(tb[2])["batched"] is True


def test_codes_and_endpoints():
    srv = _server(seed=3)
    try:
        x = np.random.RandomState(4).randn(*ITEM).astype(np.float32)
        st, _, raw = _req(srv.port, "POST", "/v1/predict", _body(x))
        assert st == 200
        got = np.asarray(json.loads(raw)["outputs"][0], np.float32)
        assert np.array_equal(got, _ref(_tnet(3), x))
        assert _req(srv.port, "POST", "/v1/predict",
                    _body(x, "nope"))[0] == 404
        assert _req(srv.port, "GET", "/nowhere")[0] == 404
        assert _req(srv.port, "POST", "/nowhere", b"{}")[0] == 404
        assert _req(srv.port, "POST", "/v1/predict", b"not json")[0] == 400
        assert _req(srv.port, "POST", "/v1/predict",
                    json.dumps({"inputs": [1]}).encode())[0] == 400
        assert _req(srv.port, "POST", "/v1/predict",
                    _body(np.zeros(5, np.float32)))[0] == 400
        st, _, raw = _req(srv.port, "POST", "/v1/predict", b"",
                          headers={"Content-Length": "-3"})
        assert st == 400
        st, _, raw = _req(srv.port, "GET", "/v1/models")
        models = json.loads(raw)["models"]
        assert st == 200 and models["web"]["ready"] and \
            models["web"]["batcher"]["name"] == "web"
        st, h, raw = _req(srv.port, "GET", "/metrics")
        assert st == 200 and h["Content-Type"].startswith("text/plain")
        assert b"mxtpu_serve_http_requests" in raw
    finally:
        srv.stop(close_registry=True)


def test_healthz_warming_then_ready_and_engine_flags():
    reg = ModelRegistry(max_models=2, device="cpu")
    entry = reg.register("web", _tnet(), ITEM, buckets=(1, 2),
                         warmup=False)
    srv = InferenceServer(reg, host="127.0.0.1", port=0).start()
    try:
        assert not entry.engine.warm and not entry.engine.ready
        st, _, raw = _req(srv.port, "GET", "/healthz")
        body = json.loads(raw)
        assert st == 503 and body["status"] == "warming"
        assert body["models"] == {"web": "warming"} == reg.health()
        entry.engine.warmup()
        st, _, raw = _req(srv.port, "GET", "/healthz")
        assert st == 200 and json.loads(raw) == {
            "status": "ok", "ready": True, "models": {"web": "ready"}}
        assert entry.engine.warm and entry.engine.ready
    finally:
        srv.stop(close_registry=True)


def test_bounded_queue_sheds_429_with_retry_after(monkeypatch):
    srv = _server(queue_depth=1, max_wait_ms=1)
    monkeypatch.setenv(faults.FAULT_ENV, "batcher:delay:1.0:300")
    c0 = _counters().get("serve.http_429", 0)
    try:
        body = _body(np.zeros(ITEM, np.float32))
        out = [None] * 5
        barrier = threading.Barrier(5)

        def client(i):
            barrier.wait()
            out[i] = _req(srv.port, "POST", "/v1/predict", body)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(5)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
    finally:
        monkeypatch.delenv(faults.FAULT_ENV)
        srv.stop(close_registry=True)
    codes = sorted(o[0] for o in out)
    assert set(codes) == {200, 429}
    shed = [o for o in out if o[0] == 429]
    assert all(float(o[1]["Retry-After"]) > 0 for o in shed)
    assert _counters()["serve.http_429"] == c0 + len(shed)


@pytest.mark.parametrize("spec,code", [
    ("server:error:1.0", 500), ("server:delay:1.0:150", 200),
    ("batcher:error:1.0", 500)])
def test_server_fault_modes(monkeypatch, spec, code):
    srv = _server()
    try:
        monkeypatch.setenv(faults.FAULT_ENV, spec)
        t0 = time.perf_counter()
        st, _, _ = _req(srv.port, "POST", "/v1/predict",
                        _body(np.zeros(ITEM, np.float32)))
        took = time.perf_counter() - t0
    finally:
        monkeypatch.delenv(faults.FAULT_ENV)
        srv.stop(close_registry=True)
    assert st == code
    if "delay" in spec:
        assert took >= 0.15


def test_black_holes(monkeypatch):
    srv = _server()
    try:
        monkeypatch.setenv(faults.FAULT_ENV, "server:black_hole:1.0:100")
        with pytest.raises((http.client.RemoteDisconnected,
                            ConnectionError)):
            _req(srv.port, "POST", "/v1/predict",
                 _body(np.zeros(ITEM, np.float32)))
        # a stranded batch: the submit times out → 504
        monkeypatch.setenv(faults.FAULT_ENV, "batcher:black_hole:1.0")
        srv.registry.get("web").batcher.timeout_s = 0.2
        st, _, _ = _req(srv.port, "POST", "/v1/predict",
                        _body(np.zeros(ITEM, np.float32)))
        assert st == 504
    finally:
        monkeypatch.delenv(faults.FAULT_ENV)
        srv.stop(close_registry=True)


def test_publish_from_params_and_checkpoint_health_unregister(tmp_path):
    new = _tnet(seed=9)
    params = str(tmp_path / "m.params")
    new.save_parameters(params)
    root = str(tmp_path / "ckpt")
    CheckpointManager(root).save(
        {"params": {k: t for k, t in _tnet(seed=11).collect_params()
                    .items()}}, step=1, blocking=True)
    reg = ModelRegistry(max_models=2, device="cpu")
    reg.register("m", _tnet(seed=8), ITEM, buckets=(1, 2))
    x = np.random.RandomState(5).randn(*ITEM).astype(np.float32)
    c0 = _counters().get("serve.swaps", 0)
    try:
        def fresh():
            net = tnn.HybridSequential()
            net.add(tnn.Dense(24, activation="relu"), tnn.Dense(5))
            return net

        reg.publish("m", params, net=fresh(), item_shape=ITEM,
                    buckets=(1, 2))
        assert np.array_equal(reg.predict("m", x)[0], _ref(_tnet(9), x))
        reg.publish("m", root, net=fresh(), item_shape=ITEM,
                    buckets=(1, 2))
        assert np.array_equal(reg.predict("m", x)[0], _ref(_tnet(11), x))
        assert _counters()["serve.swaps"] == c0 + 2
        with pytest.raises(Exception):
            reg.publish("m", str(tmp_path / "missing.params"),
                        net=fresh(), item_shape=ITEM)
        assert np.array_equal(reg.predict("m", x)[0], _ref(_tnet(11), x))
        assert reg.health() == {"m": "ready"}
        reg.unregister("m")
        assert reg.names() == [] and reg.health() == {}
        assert ttel.raw_snapshot()["gauges"]["serve.models"] == 0
    finally:
        reg.close()


def test_a_request_that_meets_a_closed_batcher_goes_to_the_new_entry():
    srv = _server(seed=12)
    try:
        old = srv.registry.get("web")
        old.batcher.close()
        with pytest.raises(BatcherClosed):
            old.batcher.submit(np.zeros(ITEM, np.float32))
        srv.registry.register("web", _tnet(seed=13), ITEM, buckets=(1, 2))
        get, handed = srv.registry.get, []

        def stale_first(name):      # the request read the map before the swap
            handed.append(name)
            return old if len(handed) == 1 else get(name)

        srv.registry.get = stale_first
        x = np.zeros(ITEM, np.float32)
        st, _, raw = _req(srv.port, "POST", "/v1/predict", _body(x))
        assert st == 200
        got = np.asarray(json.loads(raw)["outputs"][0], np.float32)
        assert np.array_equal(got, _ref(_tnet(13), x))
        assert handed == ["web", "web"]
    finally:
        srv.stop(close_registry=True)


def test_selftest_cli_check_passes_on_the_cpu():
    from mxnet_tpu_torch.serve import _main
    assert _main(["--check", "--quiet", "--device", "cpu"]) == 0
    assert tmx is not None
