"""The port's observability plane (``mxnet_tpu_torch.obs``: recorder,
signals, rules, the fleet aggregator; ``tracemerge``; the batcher's and
the fused step's trace links) against the JAX package's on the CPU.

Every case of the reference's ``tests/test_obs.py`` but its
``tools/diagnose.py`` one, and:

- on the same registry sequence the recorder's derived rates and
  windowed quantiles equal the reference's (1e-12 of each value; over
  the two packages' own registries the rates and bucket quantiles are
  equal and the window's mean within 1e-6);
- ``fleet.build_report`` and ``tracemerge.merge_events`` give the
  reference tools' results on the same input;
- a ``Batcher``'s ``serve.execute`` span is a child of its first
  request's span and links every request's; each fused step runs under
  a fresh trace id that the following feed fetch shares; the step
  publishes ``obs.model_flops_per_step`` (3 × the forward's FLOPs) at
  build when the recorder runs."""
import importlib.util
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu import telemetry as jtel  # noqa: E402
from mxnet_tpu.obs import recorder as jrec  # noqa: E402
from mxnet_tpu_torch import telemetry  # noqa: E402
from mxnet_tpu_torch import tracemerge  # noqa: E402
from mxnet_tpu_torch.obs import fleet  # noqa: E402
from mxnet_tpu_torch.obs import recorder as obs_recorder  # noqa: E402
from mxnet_tpu_torch.obs import rules as obs_rules  # noqa: E402
from mxnet_tpu_torch.obs import signals as obs_signals  # noqa: E402
from mxnet_tpu_torch.obs.recorder import (Recorder, delta_hist,  # noqa: E402
                                          derive_between, split_label)
from mxnet_tpu_torch.obs.rules import Rule, RuleEngine  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DERIVE_RTOL = 1e-12     # rates and quantiles: the same float arithmetic
MEAN_RTOL = 1e-6        # a window's mean µs over the two registries


def _load_tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_t_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def enabled_telemetry():
    prev = telemetry.set_enabled(True)
    yield
    telemetry.set_enabled(prev)


def _hist(vals):
    le = list(telemetry.BUCKET_BOUNDS_US)
    counts = [0] * (len(le) + 1)
    for v in vals:
        for i, b in enumerate(le):
            if v <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
    return {"le": le, "counts": counts, "count": len(vals),
            "sum": float(sum(vals))}


# ------------------------------------------------------------- derivation
def test_split_label():
    assert split_label("trainer-rank3") == ("trainer", 3)
    assert split_label("feed-worker1") == ("feed-worker", 1)
    assert split_label("worker-rank0") == ("worker", 0)
    assert split_label("serve") == ("serve", 0)
    assert split_label("") == ("proc", 0)
    for lbl in ("trainer-rank3", "feed-worker1", "replica0", "x", ""):
        assert split_label(lbl) == jrec.split_label(lbl)


def test_delta_hist_window():
    prev, cur = _hist([3, 30]), _hist([3, 30, 300, 3000])
    d = delta_hist(prev, cur)
    assert d["count"] == 2
    assert d["sum"] == pytest.approx(3300.0)
    assert sum(d["counts"]) == 2
    assert delta_hist(cur, cur) is None
    assert delta_hist(cur, prev) is None
    assert delta_hist(None, cur)["count"] == 4
    assert d == jrec.delta_hist(prev, cur)


def test_derive_between_rates_and_quantiles():
    prev = {"counters": {"a.x": 10, "a.reset": 100},
            "histograms": {"h.us": _hist([10])}}
    cur = {"counters": {"a.x": 30, "a.reset": 5, "a.new": 4},
           "histograms": {"h.us": _hist([10, 100, 100, 100])}}
    d = derive_between(prev, cur, 2.0)
    assert d["rates"]["a.x"] == pytest.approx(10.0)
    assert d["rates"]["a.new"] == pytest.approx(2.0)
    assert "a.reset" not in d["rates"]
    q = d["quantiles"]["h.us"]
    assert q["rate"] == pytest.approx(1.5)
    assert q["mean_us"] == pytest.approx(100.0)
    assert 50.0 <= q["p50_us"] <= 100.0
    assert d == jrec.derive_between(prev, cur, 2.0)


def _same_derived(a, b):
    assert set(a["rates"]) == set(b["rates"])
    for k, v in b["rates"].items():
        assert a["rates"][k] == pytest.approx(v, rel=DERIVE_RTOL), k
    assert set(a["quantiles"]) == set(b["quantiles"])
    for k, q in b["quantiles"].items():
        assert set(a["quantiles"][k]) == set(q), k
        for t, v in q.items():
            assert a["quantiles"][k][t] == pytest.approx(
                v, rel=DERIVE_RTOL), (k, t)


def test_recorder_derivations_equal_the_reference_on_one_sequence(
        enabled_telemetry):
    """The same counter and histogram sequence into both registries;
    each package's snapshots derived over each window: equal rates and
    windowed quantiles."""
    prev = jtel.set_enabled(True)
    keep = ("test.obs_seq", "test.obs_seq_us")

    def kept(d):
        return {"rates": {k: v for k, v in d["rates"].items() if k in keep},
                "quantiles": {k: v for k, v in d["quantiles"].items()
                              if k in keep}}
    try:
        rs = np.random.RandomState(0)
        snaps = []
        for step in range(4):
            vals = rs.lognormal(5, 2, 20)
            for tel in (telemetry, jtel):
                tel.counter_add("test.obs_seq", 3 + step)
                for v in vals:
                    tel.observe("test.obs_seq_us", float(v))
            snaps.append((telemetry.raw_snapshot(), jtel.raw_snapshot()))
        for (tp, jp), (tc, jc) in zip(snaps, snaps[1:]):
            # one snapshot sequence through both derivations
            t = kept(derive_between(tp, tc, 0.25))
            _same_derived(t, kept(jrec.derive_between(tp, tc, 0.25)))
            assert set(t["quantiles"]) == {"test.obs_seq_us"}
            # each package's own registry: the same rates and bucket
            # quantiles (the reference's registry keeps its sums rounded:
            # the window's mean within MEAN_RTOL)
            j = kept(jrec.derive_between(jp, jc, 0.25))
            tq, jq = t["quantiles"]["test.obs_seq_us"], \
                j["quantiles"]["test.obs_seq_us"]
            assert t["rates"] == j["rates"]
            assert {k: tq[k] for k in ("rate", "p50_us", "p99_us")} == \
                {k: jq[k] for k in ("rate", "p50_us", "p99_us")}
            assert tq["mean_us"] == pytest.approx(jq["mean_us"],
                                                  rel=MEAN_RTOL)
    finally:
        jtel.set_enabled(prev)


# --------------------------------------------------------------- recorder
def test_recorder_ring_shard_and_dropped_frames(tmp_path,
                                                enabled_telemetry,
                                                monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_LABEL", "trainer-rank2")
    rec = Recorder(interval_s=9999.0, ring=8, out_dir=str(tmp_path))
    for _ in range(12):
        telemetry.counter_add("test.obs_tick", 2)
        rec.sample_once()
    frames = rec.frames()
    assert len(frames) == 8
    assert rec.state()["dropped_frames"] == 4
    assert frames[-1]["rates"]["test.obs_tick"] > 0
    path = rec.flush()
    lines = [json.loads(ln) for ln in open(path).read().splitlines()]
    assert lines[0]["kind"] == "obs-shard"
    assert (lines[0]["role"], lines[0]["rank"]) == ("trainer", 2)
    assert len(lines) == 1 + 8
    assert path.endswith(".obs.jsonl")
    snap = telemetry.raw_snapshot()["counters"]
    assert snap.get("obs.dropped_frames", 0) >= 4
    assert snap.get("obs.frames", 0) >= 12


def test_recorder_flushes_from_two_threads(tmp_path, enabled_telemetry):
    """The sampler's periodic flush and a caller's never collide on the
    shard's temporary file."""
    rec = Recorder(interval_s=9999.0, ring=8, out_dir=str(tmp_path))
    rec.sample_once()
    errs = []

    def flush_many():
        try:
            for _ in range(50):
                rec.flush()
        except Exception as e:
            errs.append(e)
    threads = [threading.Thread(target=flush_many) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errs == []
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_recorder_state_in_dump(tmp_path, enabled_telemetry):
    rec = obs_recorder.start(interval_ms=10)
    try:
        assert rec is obs_recorder.get() and obs_recorder.active()
        assert obs_recorder.start(interval_ms=10) is rec
        time.sleep(0.1)
        p = str(tmp_path / "d.json")
        telemetry.dump(p, reason="test")
        d = json.load(open(p))
        assert d["obs"]["frames"] >= 1
        assert d["obs"]["running"] is True
        assert "alerts" in d["obs"]
        from mxnet_tpu_torch import obs
        summ = obs.bench_summary()
        assert summ["frames"] >= 1 and "alerts" in summ
    finally:
        obs_recorder.stop()
    assert not obs_recorder.active()
    assert obs_recorder.start(interval_ms=0) is None


# ------------------------------------------------------------------ rules
def test_rule_for_duration_and_hysteresis():
    r = Rule("starved", "x", ">", 0.5, for_s=1.0,
             clear_threshold=0.25, clear_for_s=1.0)
    assert r.update(0.0, {"x": 0.9}) is None
    assert r.state == "pending"
    assert r.update(0.5, {"x": 0.1}) is None
    assert r.state == "ok"
    assert r.update(1.0, {"x": 0.9}) is None
    ev = r.update(2.1, {"x": 0.9})
    assert ev["event"] == "firing" and r.state == "firing"
    assert r.update(3.0, {"x": 0.3}) is None
    assert r.state == "firing"
    assert r.update(4.0, {"x": 0.1}) is None
    ev = r.update(5.1, {"x": 0.1})
    assert ev["event"] == "cleared" and r.state == "ok"
    r2 = Rule("m", "y", "<", 1.0, for_s=0.0)
    assert r2.update(0.0, {}) is None and r2.state == "ok"
    with pytest.raises(ValueError):
        Rule("bad", "x", ">=", 1.0)


def test_rule_engine_counts_and_logs(enabled_telemetry):
    eng = RuleEngine([Rule("test_alert", "sig", ">", 1.0, for_s=0.0)],
                     log=open(os.devnull, "w"))
    before = telemetry.raw_snapshot()["counters"].get(
        "obs.alerts.test_alert", 0)
    evs = eng.update({"mono": 1.0, "signals": {"sig": 5.0}})
    assert [e["event"] for e in evs] == ["firing"]
    assert eng.firing() == ["test_alert"]
    after = telemetry.raw_snapshot()["counters"]["obs.alerts.test_alert"]
    assert after == before + 1
    assert eng.summary()["rules"]["test_alert"] == "firing"


def test_seeded_rules_are_the_reference_rules():
    from mxnet_tpu.obs import rules as jrules
    got = [(r.name, r.metric, r.op, r.threshold, r.for_s,
            r.clear_threshold, r.clear_for_s)
           for r in obs_rules.seeded_rules()]
    want = [(r.name, r.metric, r.op, r.threshold, r.for_s,
             r.clear_threshold, r.clear_for_s)
            for r in jrules.seeded_rules()]
    assert got == want


def test_frame_view_namespaces():
    view = obs_rules.frame_view({
        "signals": {"goodput": 0.5},
        "rates": {"c.x": 2.0},
        "gauges": {"g.y": 7},
        "quantiles": {"h.us": {"p50_us": 10.0, "p99_us": 20.0,
                               "mean_us": 12.0, "rate": 3.0}}})
    assert view["goodput"] == 0.5
    assert view["rate:c.x"] == 2.0
    assert view["gauge:g.y"] == 7.0
    assert view["p99:h.us"] == 20.0
    assert view["hrate:h.us"] == 3.0


# ---------------------------------------------------------------- signals
def test_signals_compute(monkeypatch):
    frame = {
        "rates": {"serve.requests": 10.0, "serve.admitted": 9.0,
                  "serve.rejected": 1.0, "fused.retraces": 0.5},
        "gauges": {"serve.queue_depth": 64,
                   "obs.model_flops_per_step": 1_000_000},
        "quantiles": {
            "fused.step_us": {"rate": 4.0, "mean_us": 1000.0,
                              "p50_us": 900.0},
            "datafeed.wait_us": {"rate": 4.0, "mean_us": 500.0}},
    }
    monkeypatch.setenv("MXNET_OBS_PEAK_FLOPS", "1e8")
    sig = obs_signals.compute(frame)
    from mxnet_tpu.obs import signals as jsignals
    assert sig == jsignals.compute(frame)
    assert sig["input_stall_frac"] == pytest.approx(0.5)
    assert sig["goodput"] == pytest.approx(0.8)
    assert sig["steps_per_s"] == pytest.approx(4.0)
    assert sig["retrace_rate"] == pytest.approx(0.5)
    assert sig["queue_frac"] == pytest.approx(64 / 256.0)
    assert sig["mfu"] == pytest.approx(0.04)
    sig2 = obs_signals.compute({"rates": {}, "gauges": {},
                                "quantiles": {}})
    assert "input_stall_frac" not in sig2 and "mfu" not in sig2
    sig3 = obs_signals.compute({
        "rates": {}, "gauges": {},
        "quantiles": {"fused.step_us": {"rate": 4.0, "mean_us": 1000.0}}})
    assert sig3["input_stall_frac"] == 0.0


def test_signals_published_as_ppm_gauges(enabled_telemetry):
    obs_signals.publish({"goodput": 0.25, "mfu": 0.5})
    g = telemetry.raw_snapshot()["gauges"]
    assert g["obs.goodput_ppm"] == 250000
    assert g["obs.mfu_ppm"] == 500000


# ------------------------------------------------------------------ flops
def test_block_flops_dense(enabled_telemetry):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
    net.initialize(ctx="cpu")
    x = torch.zeros((8, 6))
    net(x)
    net.hybridize()
    assert net.flops(x) == 2560
    per_step = obs_signals.publish_model_flops(net, x)
    assert per_step == 3 * 2560
    assert telemetry.raw_snapshot()["gauges"][
        "obs.model_flops_per_step"] == 3 * 2560
    # a net that cannot be priced publishes nothing and never raises
    assert obs_signals.publish_model_flops(net) is None


def test_block_flops_conv():
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, kernel_size=3, padding=1))
    net.initialize(ctx="cpu")
    x = torch.zeros((2, 8, 8, 3))
    net(x)
    assert net.flops(x) == 2 * 27 * 512


# ----------------------------------------------------- the fleet tool
def test_parse_prometheus_roundtrip(enabled_telemetry):
    telemetry.counter_add("test.prom_rt", 7)
    telemetry.gauge_set("test.prom_g", 3)
    for v in (10.0, 400.0):
        telemetry.observe("test.prom_h_us", v)
    raw = fleet.parse_prometheus(telemetry.dump_prometheus())
    assert raw["counters"]["mxtpu_test_prom_rt"] >= 7
    assert raw["gauges"]["mxtpu_test_prom_g"] == 3
    h = raw["histograms"]["mxtpu_test_prom_h_us"]
    assert h["count"] >= 2 and sum(h["counts"]) == h["count"]
    assert telemetry.quantile_from_hist(h, 0.5) is not None
    assert fleet._dotted("mxtpu_serve_queue_depth") == "serve.queue_depth"
    assert fleet._dotted("mxtpu_feed_service_worker_bytes") == \
        "feed_service.worker_bytes"
    assert raw == _load_tool("obs").parse_prometheus(
        telemetry.dump_prometheus()) or True   # live registry moves
    text = telemetry.dump_prometheus()
    assert fleet.parse_prometheus(text) == \
        _load_tool("obs").parse_prometheus(text)


def _report_frames():
    frames = []
    for t in (1.0, 2.0, 3.0, 4.0):
        frames.append({"t": t, "role": "serve", "rank": 0,
                       "source": "scrape",
                       "rates": {"serve.requests": 10.0,
                                 "serve.admitted": 8.0,
                                 "serve.rejected": 2.0},
                       "quantiles": {}, "gauges": {}})
        for rank, p50 in ((0, 1000.0), (1, 2500.0)):
            frames.append({
                "t": t, "role": "trainer", "rank": rank,
                "source": "shard",
                "rates": {"fused.steps": 5.0 * (1 + t)},
                "quantiles": {"fused.step_us":
                              {"p50_us": p50, "rate": 5.0,
                               "mean_us": p50}},
                "signals": {"input_stall_frac": 0.1, "mfu": 0.3}})
    return frames


def test_build_report_roles_signals_straggler():
    rep = fleet.build_report({"frames": _report_frames()})
    assert rep["roles"]["serve"]["nonzero_rates"] == 3
    assert rep["roles"]["trainer"]["ranks"] == [0, 1]
    assert rep["signals"]["goodput"] == pytest.approx(0.6)
    assert rep["signals"]["input_stall_frac"] == pytest.approx(0.1)
    assert rep["signals"]["mfu"] == pytest.approx(0.3)
    assert rep["signals"]["straggler_skew"] > 0.5
    assert any(ev["rule"] == "straggler" and ev["event"] == "firing"
               for ev in rep["straggler_alerts"])
    assert any(r["metric"] == "fused.steps" for r in rep["regressions"])
    text = fleet.render_report(rep)
    assert "straggler" in text and "goodput" in text
    # the reference tool's report of the same timeline
    want = _load_tool("obs").build_report({"frames": _report_frames()})
    strip = (lambda r: {k: v for k, v in r.items()
                        if k != "straggler_alerts"})
    assert strip(rep) == strip(want)
    assert [(e["rule"], e["event"], e["value"])
            for e in rep["straggler_alerts"]] == \
        [(e["rule"], e["event"], e["value"])
         for e in want["straggler_alerts"]]


def test_read_shards_roundtrip(tmp_path, enabled_telemetry, monkeypatch):
    monkeypatch.setenv("MXNET_TRACE_LABEL", "trainer-rank1")
    rec = Recorder(interval_s=9999.0, ring=8, out_dir=str(tmp_path))
    telemetry.counter_add("test.shard_rt", 1)
    rec.sample_once()
    telemetry.counter_add("test.shard_rt", 1)
    rec.sample_once()
    rec.flush()
    frames = fleet.read_shards(str(tmp_path))
    assert frames and all(f["role"] == "trainer" and f["rank"] == 1
                          for f in frames)
    assert any(f["rates"].get("test.shard_rt", 0) > 0 for f in frames)
    assert frames == _load_tool("obs").read_shards(str(tmp_path))


def test_scrape_a_live_worker(tmp_path, enabled_telemetry):
    """``scrape`` of a decode worker's ``/metrics`` beside a recorder
    shard, through the CLI too."""
    from mxnet_tpu_torch.io.data_service import DecodeWorker, FeedClient
    spec = "synthetic:2x1x2x2:2:40"
    with DecodeWorker(spec, seed=0) as w, \
            FeedClient(workers=[w.addr], spec=spec, seed=0, prefetch=0,
                       start_probing=False) as c:
        stop = threading.Event()

        def pull():
            while not stop.is_set():
                try:
                    c.next_raw()
                except StopIteration:
                    c.reset()
                time.sleep(0.01)
        t = threading.Thread(target=pull, daemon=True)
        t.start()
        try:
            out = str(tmp_path / "fleet.json")
            rc = fleet.main(["scrape", "--target", f"feed@{w.addr}",
                             "--interval-ms", "100", "--duration-s", "0.5",
                             "--out", out])
        finally:
            stop.set()
            t.join()
    assert rc == 0
    tl = json.load(open(out))
    rep = fleet.build_report(tl)
    assert rep["roles"]["feed"]["nonzero_rates"] > 0
    assert fleet.main(["report", out]) == 0


# ------------------------------------------------------------ trace links
def test_batcher_execute_span_links_its_requests():
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.serve import Batcher, InferenceEngine
    net = nn.Dense(3)
    net.initialize(ctx="cpu")
    net(torch.zeros(1, 4))
    eng = InferenceEngine(net, (4,), buckets=(1, 2, 4), device="cpu")
    eng.warmup()
    b = Batcher(eng, max_wait_ms=200.0)
    telemetry.trace_reset()
    ctxs, barrier = [], threading.Barrier(3)

    def client(i):
        with telemetry.span("test.request", i=i) as sp:
            ctxs.append(sp.context())
            barrier.wait()
            b.submit(np.ones((1, 4), np.float32), timeout=30)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        b.close()
    spans = [s for s in telemetry.trace_spans() if s[3] == "serve.execute"]
    assert spans
    served = set()
    for (tid, sid, pid, _n, _t, _d, _th, attrs, links) in spans:
        assert len(links) == attrs["requests"]
        assert (tid, pid) == links[0]         # the first request's child
        served |= set(links)
        assert attrs["fill"] == attrs["requests"]
    assert served == set(ctxs)
    # a request with no trace context (a fresh thread has none) makes a
    # root execute span
    telemetry.trace_reset()
    b2 = Batcher(eng)
    try:
        _in_fresh_thread(
            lambda: b2.submit(np.ones((1, 4), np.float32), timeout=30))
    finally:
        b2.close()
    (rec,) = [s for s in telemetry.trace_spans() if s[3] == "serve.execute"]
    assert rec[2] is None and rec[8] is None


def _in_fresh_thread(fn):
    """``fn()`` on a new thread, whose trace context is empty (a fused
    step earlier on this one leaves its trace id current) → its
    result."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and out
    return out[0]


def test_decode_request_keeps_its_trace():
    from mxnet_tpu_torch.serve.batcher import _DecodeRequest
    assert _in_fresh_thread(lambda: _DecodeRequest([1], 2).trace) is None
    with telemetry.span("test.decode") as sp:
        assert _DecodeRequest([1], 2).trace == sp.context()


def test_fused_step_rotates_the_trace_and_publishes_flops(
        enabled_telemetry):
    from mxnet_tpu_torch.gluon import Trainer, nn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.io.data_service import DecodeWorker, FeedClient
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(10))
    net.initialize(ctx="cpu")
    net.hybridize()
    step = Trainer(net.collect_params(), "sgd",
                   {"learning_rate": 0.05}).fuse_step(
        SoftmaxCrossEntropyLoss())
    spec = "synthetic:4x1x2x3:10:40"
    rec = obs_recorder.start(interval_ms=1000)
    try:
        telemetry.gauge_set("obs.model_flops_per_step", 0)
        telemetry.trace_reset()
        with DecodeWorker(spec, seed=0) as w, \
                FeedClient(workers=[w.addr], spec=spec, seed=0,
                           prefetch=0, start_probing=False) as c:
            for _ in range(3):
                d, lab, _ = c.next_raw()
                step(torch.from_numpy(d).float(),
                     torch.from_numpy(lab.reshape(-1)).long())
    finally:
        obs_recorder.stop()
    assert rec is not None
    # priced at build: 3 x 2 x (4·6·16 + 4·16·10)
    assert telemetry.raw_snapshot()["gauges"][
        "obs.model_flops_per_step"] == 3 * 2 * (4 * 6 * 16 + 4 * 16 * 10)
    spans = telemetry.trace_spans()
    steps = [s for s in spans if s[3] == "train.step"]
    fetches = [s for s in spans if s[3] == "feed.fetch"]
    assert len(steps) == 3 and len(fetches) == 3
    assert len({s[0] for s in steps}) == 3        # a fresh id a step
    # the fetch after step N is in step N's trace
    assert [f[0] for f in fetches[1:]] == [s[0] for s in steps[:2]]
    assert all(s[2] is None for s in steps)       # roots of their traces


# ------------------------------------------------------------- tracemerge
def test_merge_events_equal_the_reference_tool(tmp_path):
    telemetry.trace_reset()
    with telemetry.span("test.parent") as p:
        with telemetry.span("test.child"):
            pass
        ctx = p.context()
    with telemetry.span("test.exec", links=[ctx]):
        pass
    d = tmp_path / "shards"
    d.mkdir()
    telemetry.dump_trace(str(d / "a.json"))
    telemetry.dump(str(d / "dump.json"), reason="test")
    (d / "noise.json").write_text("[1, 2]")
    got = tracemerge.merge_events([str(d)])
    want = _load_tool("trace").merge_events([str(d)])
    assert got == want
    assert sum(1 for e in got if e.get("ph") == "X") == 3
    assert [e["ph"] for e in got if e.get("cat") == "mxtpu.link"] == \
        ["s", "f"]
    out = str(tmp_path / "m.json")
    assert tracemerge.main(["merge", str(d), "-o", out]) == 0
    assert json.load(open(out))["traceEvents"] == got
    assert tracemerge.main(["merge", str(tmp_path / "empty_dir_none"),
                            "-o", out]) == 1


# --------------------------------------------- SIGUSR2 while sampling
@pytest.mark.skipif(not hasattr(signal, "SIGUSR2"),
                    reason="platform has no SIGUSR2")
def test_sigusr2_dump_with_live_sampler(tmp_path):
    """A dump taken while the sampler thread runs must not deadlock,
    must list the sampler thread and must carry the ring's state under
    "obs"; importing the package with the knob set starts the
    recorder."""
    dump_path = str(tmp_path / "dump.json")
    code = (
        "import os, signal, time\n"
        "import mxnet_tpu_torch as mx\n"
        "from mxnet_tpu_torch import obs\n"
        "assert obs.active()\n"
        "mx.telemetry.counter_add('test.obs_sig', 3)\n"
        "time.sleep(0.15)\n"
        "os.kill(os.getpid(), signal.SIGUSR2)\n"
        "time.sleep(0.5)\n"
        "print('ALIVE', len(obs.get().frames()))\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO, "MXNET_TELEMETRY": "1",
           "MXNET_OBS_INTERVAL_MS": "20",
           "MXNET_TELEMETRY_DUMP_PATH": dump_path}
    env.pop("MXNET_OBS_DIR", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "ALIVE" in r.stdout
    d = json.load(open(dump_path))
    assert d["reason"] == "SIGUSR2"
    assert any("obs-sampler" in k for k in d["threads"]), list(d["threads"])
    obs_state = d["obs"]
    assert obs_state["running"] is True
    assert obs_state["frames"] >= 1
    assert isinstance(obs_state["window"], list)
    assert math.isfinite(obs_state["interval_ms"])


def test_package_imports_obs_only_when_asked():
    code = ("import sys, mxnet_tpu_torch\n"
            "print('mxnet_tpu_torch.obs' in sys.modules)\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("MXNET_OBS_INTERVAL_MS", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "False"
