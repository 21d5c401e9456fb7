"""The resilience plane of the PyTorch port (``mxnet_tpu_torch.serve``
``Router``, the batcher's tombstones and ``Retry-After``, the replica
lifecycle) on the CPU: the JAX package's router cases, run against the
port's servers, with predictions held against the port's own forward
(which ``test_torch_serve_http`` holds against the JAX package's).

- ``MXNET_SERVE_FAULT`` parses ``[site:]mode:prob[:ms]`` and rejects
  malformed specs (the parse matrix equals the reference's:
  ``test_torch_telemetry_profiler``);
- a timed-out ``submit`` is swept, never executed, counted
  ``serve.abandoned``; ``Retry-After`` is queue depth × the EWMA
  per-item time, jittered, ~1 s before any batch;
- drain on a keep-alive connection, warm-swap republish;
- router gates: least-loaded routing, drain un-routes without an
  ejection, probe-error ejection and reinstatement, the breaker cycle,
  retry exhaustion → 502, all replicas shedding pass the 503 through,
  hedging fires and cancels the loser;
- the chaos gate (``slow``, as the reference's): a subprocess fleet,
  SIGKILL, zero client-visible failures."""
import json
import http.client
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as onp
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import telemetry  # noqa: E402
from mxnet_tpu_torch.gluon import nn  # noqa: E402
from mxnet_tpu_torch.serve import (Batcher, InferenceEngine,  # noqa: E402
                                   InferenceServer, ModelRegistry, Router)
from mxnet_tpu_torch.serve import faults  # noqa: E402

torch.set_num_threads(1)

ITEM = (12,)


def _small_net(seed=0, out=5):
    mx.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(24, activation="relu"), nn.Dense(out))
    net.initialize(ctx="cpu")
    net(torch.zeros((1,) + ITEM))           # deferred shapes
    net.hybridize()
    return net


def _ref(net, x):
    with torch.no_grad():
        return net(torch.as_tensor(x[None])).numpy()


def _counters():
    return telemetry.raw_snapshot()["counters"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _registry():
    return ModelRegistry(max_models=2, device="cpu")


# ------------------------------------------------------------------ faults
def test_fault_spec_parse_matrix():
    assert faults.parse("error") == ("server", "error", 1.0, 0.0)
    assert faults.parse("batcher:delay:1.0:25") == \
        ("batcher", "delay", 1.0, 0.025)
    assert faults.parse("server:black_hole:0.1:5000") == \
        ("server", "black_hole", 0.1, 5.0)
    site, mode, prob, secs = faults.parse("delay:0.5")
    assert (site, mode, prob) == ("server", "delay", 0.5)
    assert secs == pytest.approx(0.1)          # mode's default ms
    for bad in ("bogus", "server:bogus", "error:2.0", "error:-0.1",
                "delay:1.0:10:extra"):
        with pytest.raises(ValueError):
            faults.parse(bad)


def test_fault_injection_counted(monkeypatch):
    telemetry.reset()
    monkeypatch.setenv(faults.FAULT_ENV, "server:error:1.0")
    assert faults.maybe("server") == ("error", 0.0)
    assert faults.maybe("batcher") is None      # other site untouched
    monkeypatch.delenv(faults.FAULT_ENV)
    assert faults.maybe("server") is None
    assert _counters().get("serve.fault.server.error", 0) == 1


# ----------------------------------------------------------------- batcher
def test_abandoned_timeout_tombstoned_and_swept():
    net = _small_net()
    eng = InferenceEngine(net, ITEM, buckets=(8,), device="cpu").warmup()
    telemetry.reset()
    # deadline 150 ms, bucket 8 never fills: a 10 ms submit timeout
    # fires while the request is still queued → tombstone
    with Batcher(eng, max_wait_ms=150, name="tomb") as b:
        x = onp.zeros(ITEM, "float32")
        with pytest.raises(TimeoutError):
            b.submit(x, timeout=0.01)
        # the deadline flush sweeps the tombstone instead of executing it
        time.sleep(0.4)
        c = _counters()
        assert c.get("serve.abandoned", 0) == 1
        assert c.get("serve.batches", 0) == 0   # nobody executed it
        # the lane is clean for the next caller
        (out,) = b.submit(x, timeout=10.0)
        assert (out == _ref(net, x)).all()
    assert _counters().get("serve.batches", 0) == 1


def test_retry_after_derived_from_queue_and_ewma():
    net = _small_net()
    eng = InferenceEngine(net, ITEM, buckets=(8,), device="cpu").warmup()
    b = Batcher(eng, max_wait_ms=5000, queue_depth=256, name="ra")
    try:
        # before any measured batch: ~1 s fallback, jittered ±25%
        assert 0.74 <= b.retry_after_s() <= 1.26
        # with a measured EWMA the estimate is queue × per-item time
        with b._cv:
            b._ewma_item_s = 0.010
            b._qn = 50
        est = b.retry_after_s()                 # 0.5 s ± 25%
        assert 0.5 * 0.74 <= est <= 0.5 * 1.26
        with b._cv:
            b._qn = 0
    finally:
        b.close()


# --------------------------------------------------- replica lifecycle
def test_drain_lifecycle_on_keepalive_connection():
    reg = _registry()
    net = _small_net(seed=31)
    reg.register("web", net, ITEM, buckets=(1, 2))
    srv = InferenceServer(reg, host="127.0.0.1", port=0).start()
    telemetry.reset()
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=15)
    body = json.dumps({"model": "web",
                       "inputs": onp.zeros(ITEM, "float32").tolist()}
                      ).encode()
    hdr = {"Content-Type": "application/json"}

    def roundtrip(method, path, payload=b""):
        conn.request(method, path, body=payload, headers=hdr)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()

    try:
        st, _, _ = roundtrip("POST", "/admin/drain")
        assert st == 200 and srv.draining
        st, _, raw = roundtrip("GET", "/healthz")
        assert st == 503 and json.loads(raw)["status"] == "draining"
        # predict is shed with a Retry-After — and its early reply must
        # consume the request body, or these keep-alive follow-ups would
        # parse the leftover bytes as their request line
        st, h, _ = roundtrip("POST", "/v1/predict", body)
        assert st == 503
        assert float(h.get("Retry-After")) > 0
        st, _, _ = roundtrip("POST", "/admin/undrain")
        assert st == 200 and not srv.draining
        st, _, raw = roundtrip("GET", "/healthz")
        assert st == 200 and json.loads(raw)["models"]["web"] == "ready"
        st, _, raw = roundtrip("POST", "/v1/predict", body)
        assert st == 200 and json.loads(raw)["model"] == "web"
        assert _counters().get("serve.http_503_draining", 0) == 1
    finally:
        conn.close()
        srv.stop(close_registry=True)


def test_warm_swap_republish_counts_and_serves_new_weights():
    telemetry.reset()
    reg = _registry()
    try:
        old_net = _small_net(seed=41)
        reg.register("m", old_net, ITEM, buckets=(1, 2))
        xi = onp.random.RandomState(42).randn(*ITEM).astype("float32")
        (out,) = reg.predict("m", xi)
        assert (out == _ref(old_net, xi)).all()
        new_net = _small_net(seed=43)
        reg.register("m", new_net, ITEM, buckets=(1, 2))
        assert _counters().get("serve.swaps", 0) == 1
        (out2,) = reg.predict("m", xi)
        assert (out2 == _ref(new_net, xi)).all()
        assert not (out2 == out).all()          # weights really changed
    finally:
        reg.close()
    time.sleep(0.1)     # the old entry's batcher drained, no leaks
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("serve-batcher-m")]


# ------------------------------------------------------------------ router
@pytest.fixture
def fleet():
    """Two live replicas serving the SAME weights + a started router."""
    servers, regs = [], []
    for _ in range(2):
        reg = _registry()
        reg.register("web", _small_net(seed=51), ITEM, buckets=(1, 2))
        srv = InferenceServer(reg, host="127.0.0.1", port=0).start()
        regs.append(reg)
        servers.append(srv)
    telemetry.reset()
    router = Router([f"127.0.0.1:{s.port}" for s in servers],
                    host="127.0.0.1", port=0,
                    probe_interval_ms=100, probe_timeout_ms=2000,
                    retries=3, backoff_ms=5, timeout_ms=5000).start()
    yield router, servers
    router.stop()
    for srv in servers:
        srv.stop(close_registry=True)


def _predict_body(x):
    return json.dumps({"model": "web", "inputs": x.tolist()}).encode()


def test_router_front_end_round_trip(fleet):
    router, _servers = fleet
    net = _small_net(seed=51)           # same seed ⇒ same weights
    base = f"http://127.0.0.1:{router.port}"
    xi = onp.random.RandomState(52).randn(*ITEM).astype("float32")
    req = urllib.request.Request(
        base + "/v1/predict", data=_predict_body(xi),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=15) as r:
        assert r.status == 200
        got = onp.asarray(json.loads(r.read())["outputs"][0], "float32")
    assert (got == _ref(net, xi)).all()
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        body = json.loads(r.read())
        assert r.status == 200 and body["routable"] == 2
        assert all(rep["breaker"] == "closed"
                   for rep in body["replicas"])
    with urllib.request.urlopen(base + "/v1/models", timeout=10) as r:
        assert "web" in json.loads(r.read())["models"]
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        text = r.read().decode()
        assert "mxtpu_router_ok" in text
        assert "mxtpu_router_replicas_routable" in text


def test_router_drain_unroutes_without_ejection(fleet):
    router, servers = fleet
    servers[0].drain()
    router.probe_all()
    st = router.stats()
    by_key = {r["key"]: r for r in st["replicas"]}
    assert by_key[f"127.0.0.1:{servers[0].port}"]["status"] == "draining"
    assert st["routable"] == 1
    # drain is lifecycle, not failure: no ejection counted
    assert _counters().get("router.ejections", 0) == 0
    xi = onp.zeros(ITEM, "float32")
    for _ in range(4):      # all traffic lands on the surviving replica
        status, _, _ = router.forward(_predict_body(xi))
        assert status == 200
    servers[0].undrain()
    router.probe_all()
    assert router.stats()["routable"] == 2


def test_router_ejection_and_reinstatement():
    telemetry.reset()
    port = _free_port()
    router = Router([("127.0.0.1", port)], port=0, unhealthy_after=2,
                    probe_timeout_ms=500)
    try:
        rep = router.replicas[0]
        router.probe_once(rep)      # connection refused × 2 → ejected
        router.probe_once(rep)
        assert rep.status == "down"
        assert _counters().get("router.ejections", 0) == 1
        reg = _registry()
        reg.register("web", _small_net(seed=61), ITEM, buckets=(1, 2))
        srv = InferenceServer(reg, host="127.0.0.1", port=port).start()
        try:
            router.probe_once(rep)
            assert rep.status == "ready"
            assert _counters().get("router.reinstatements", 0) == 1
        finally:
            srv.stop(close_registry=True)
    finally:
        router.stop()


def test_breaker_full_cycle(monkeypatch):
    telemetry.reset()
    reg = _registry()
    reg.register("web", _small_net(seed=71), ITEM, buckets=(1, 2))
    srv = InferenceServer(reg, host="127.0.0.1", port=0).start()
    # no start(): drive _pick/forward deterministically, no prober races
    router = Router([f"127.0.0.1:{srv.port}"], port=0, retries=1,
                    breaker_fails=2, cooldown_ms=100, backoff_ms=1)
    body = _predict_body(onp.zeros(ITEM, "float32"))
    try:
        router.replicas[0].status = "ready"
        monkeypatch.setenv(faults.FAULT_ENV, "server:error:1.0")
        assert router.forward(body)[0] == 502       # fail 1/2
        assert router.replicas[0].breaker == "closed"
        assert router.forward(body)[0] == 502       # fail 2/2 → open
        assert router.replicas[0].breaker == "open"
        assert _counters().get("router.breaker_open", 0) == 1
        # open + cooldown not elapsed: not routable at all
        assert router.forward(body)[0] == 502
        assert _counters().get("router.no_replica", 0) >= 1
        monkeypatch.delenv(faults.FAULT_ENV)
        time.sleep(0.15)                            # cooldown elapses
        status, _, payload = router.forward(body)   # half-open trial
        assert status == 200 and json.loads(payload)["model"] == "web"
        assert router.replicas[0].breaker == "closed"
        c = _counters()
        assert c.get("router.breaker_half_open", 0) == 1
        assert c.get("router.breaker_close", 0) == 1
    finally:
        router.stop()
        srv.stop(close_registry=True)


def test_retry_exhaustion_maps_to_502(monkeypatch):
    telemetry.reset()
    reg = _registry()
    reg.register("web", _small_net(seed=81), ITEM, buckets=(1, 2))
    srv = InferenceServer(reg, host="127.0.0.1", port=0).start()
    router = Router([f"127.0.0.1:{srv.port}"], port=0, retries=3,
                    breaker_fails=10, backoff_ms=1)
    try:
        router.replicas[0].status = "ready"
        monkeypatch.setenv(faults.FAULT_ENV, "server:error:1.0")
        status, _, payload = router.forward(
            _predict_body(onp.zeros(ITEM, "float32")))
        assert status == 502 and b"attempts" in payload
        c = _counters()
        assert c.get("router.retries", 0) == 2      # attempts 2 and 3
        assert c.get("router.failures", 0) == 3
        assert c.get("router.http_502", 0) == 1
    finally:
        router.stop()
        srv.stop(close_registry=True)


def test_all_replicas_shedding_passes_503_through():
    telemetry.reset()
    servers = []
    for seed in (91, 92):
        reg = _registry()
        reg.register("web", _small_net(seed=seed), ITEM, buckets=(1, 2))
        servers.append(InferenceServer(reg, host="127.0.0.1",
                                       port=0).start().drain())
    router = Router([f"127.0.0.1:{s.port}" for s in servers], port=0,
                    retries=3, backoff_ms=1)
    try:
        for rep in router.replicas:     # bypass probing: statuses stale
            rep.status = "ready"        # so requests really hit the 503s
        status, headers, _ = router.forward(
            _predict_body(onp.zeros(ITEM, "float32")))
        assert status == 503
        assert float(headers.get("Retry-After")) > 0    # passed through
        c = _counters()
        assert c.get("router.reroutes", 0) >= 1
        assert c.get("router.http_502", 0) == 0         # no fabricated 502
        # alive pushback is never a breaker failure
        assert all(r.breaker == "closed" for r in router.replicas)
    finally:
        router.stop()
        for s in servers:
            s.stop(close_registry=True)


def test_hedging_fires_and_cancels_loser():
    telemetry.reset()
    # replica 0: accepts connections but never responds (backlog only)
    hang = socket.socket()
    hang.bind(("127.0.0.1", 0))
    hang.listen(1)
    reg = _registry()
    net = _small_net(seed=95)
    reg.register("web", net, ITEM, buckets=(1, 2))
    srv = InferenceServer(reg, host="127.0.0.1", port=0).start()
    router = Router(
        [f"127.0.0.1:{hang.getsockname()[1]}", f"127.0.0.1:{srv.port}"],
        port=0, hedge=True, hedge_floor_ms=50, timeout_ms=8000,
        retries=2, backoff_ms=1)
    try:
        for rep in router.replicas:
            rep.status = "ready"
        xi = onp.random.RandomState(96).randn(*ITEM).astype("float32")
        # both idle ⇒ least-loaded tie breaks to list order: the hang
        # replica is primary, the hedge must rescue the request
        status, _, payload = router.forward(_predict_body(xi))
        assert status == 200
        got = onp.asarray(json.loads(payload)["outputs"][0], "float32")
        assert (got == _ref(net, xi)).all()
        c = _counters()
        assert c.get("router.hedges", 0) >= 1
        assert c.get("router.hedge_wins", 0) >= 1
        assert c.get("router.cancelled", 0) >= 1    # loser conn closed
        assert c.get("router.ok", 0) == 1
    finally:
        router.stop()
        srv.stop(close_registry=True)
        hang.close()


# ------------------------------------------------------------- chaos gate
@pytest.mark.slow
@pytest.mark.dist
def test_chaos_gate_zero_visible_failures():
    """The chaos contract: a subprocess fleet (on the CPU) under
    supervise_respawn, SIGKILL one replica mid-load, require zero
    client-visible failures, a full breaker cycle, a respawn, and
    ≥ 1.5× two-replica throughput scaling."""
    from mxnet_tpu_torch.serve.chaos import resilience_bench
    out = resilience_bench(verbose=False, device="cpu")
    assert "error" not in out, out
    checks = out["checks"]
    assert checks["zero_client_visible_failures"], out["kill"]
    assert checks["breaker_cycle_observed"], out["kill"]
    assert checks["replica_respawned"], out["kill"]
    assert checks["qps_scaling_ge_1p5"], \
        (out["qps_1replica"], out["qps_2replica"])
    assert out["ok"]
