"""Telemetry, profiler, the fault grammar and the lock-order watchdog of
the PyTorch port (``mxnet_tpu_torch.telemetry``, ``profiler``,
``faults``, ``lockwatch``) against the JAX package's on the CPU.

- ``quantile_from_hist``, ``quantile``, ``summary`` and
  ``dump_prometheus`` give the JAX package's numbers and lines on the
  same registry contents (observed into both under names of this test);
- the trace context: ``X-MXNet-Trace`` round-trips and parses as the
  reference parses it, spans nest, ``dump_trace`` writes Chrome
  trace-event JSON; ``snapshot()`` sections and its device memory;
- the profiler's chrome trace and table (the reference's format), its
  ``torch.profiler`` trace under ``tensorboard_dir``, the autostart
  hook, and the DataFeed gauges as ``profiler.Counter`` s;
- the ``[site:]mode[:prob[:ms]]`` parse matrix equals the reference's;
- ``MXNET_LOCK_CHECK`` catches an ABBA inversion (a subprocess), and a
  process under it counts through telemetry and exits without hanging;
- ``SIGUSR2`` and ``MXNET_TELEMETRY_DUMP_ON_EXIT`` write the dump."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu import faults as jfaults  # noqa: E402
from mxnet_tpu import profiler as jprof  # noqa: E402
from mxnet_tpu import telemetry as jtel  # noqa: E402
from mxnet_tpu.serve import faults as jsfaults  # noqa: E402
from mxnet_tpu_torch import checkpoint as tck  # noqa: E402,F401
from mxnet_tpu_torch import faults as tfaults  # noqa: E402
from mxnet_tpu_torch import profiler as tprof  # noqa: E402
from mxnet_tpu_torch import telemetry as ttel  # noqa: E402
from mxnet_tpu_torch.serve import faults as tsfaults  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "serve.ttp_"       # names of this test, in the serve section


def _feed(tel, tag):
    rs = np.random.RandomState(4)
    # whole µs: the reference's native registry reports sums to 1e-3
    for v in np.round(rs.exponential(3000.0, 200)):
        tel.observe(f"{PREFIX}{tag}_us", float(v))
    tel.observe(f"{PREFIX}{tag}_us", 5e6)             # the overflow bucket
    tel.counter_add(f"{PREFIX}{tag}_count", 7)
    tel.gauge_set(f"{PREFIX}{tag}_depth", 3)


def test_quantiles_summary_and_prometheus_equal_the_reference():
    tag = f"p{os.getpid()}"
    was = jtel.set_enabled(True)
    try:
        _feed(jtel, tag)
        _feed(ttel, tag)
        jraw, traw = jtel.raw_snapshot(), ttel.raw_snapshot()
    finally:
        jtel.set_enabled(was)
    name = f"{PREFIX}{tag}_us"
    assert traw["histograms"][name] == jraw["histograms"][name]
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert ttel.quantile("serve", name, q, snap=traw) == \
            jtel.quantile("serve", name, q, snap=jraw)
        assert ttel.quantile_from_hist(traw["histograms"][name], q) == \
            jtel.quantile_from_hist(jraw["histograms"][name], q)
    assert ttel.quantile_from_hist({"count": 0}, 0.5) is None
    mine = {k: v for k, v in ttel.summary().items() if tag in k}
    theirs = {k: v for k, v in jtel.summary().items() if tag in k}
    assert mine == theirs and len(mine) == 4

    def lines(text):
        return [ln for ln in text.splitlines() if tag in ln]

    assert lines(ttel.dump_prometheus()) == lines(jtel.dump_prometheus())
    prom = ttel.dump_prometheus()
    bad = [ln for ln in prom.splitlines() if ln and not ln.startswith("#")
           and not re.match(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$",
                            ln)]
    assert bad == []


@pytest.mark.parametrize("value", [
    "00000000000000ab-00000000000000cd", "ab-cd", "ab-0", "0-12", "",
    None, "zz-1", "abc", "  ab-cd  ", 17])
def test_trace_header_parses_as_the_reference(value):
    assert ttel.parse_trace_header(value) == jtel.parse_trace_header(value)


def test_trace_context_round_trip_and_chrome_export(tmp_path):
    ttel.trace_reset()
    with ttel.span("outer", a=1) as outer:
        hdr = ttel.trace_header()
        assert hdr == outer.header()
        with ttel.span("inner"):
            pass
    tid, sid = ttel.parse_trace_header(hdr)
    assert (tid, sid) == outer.context() or outer.context() is None
    with ttel.span("remote", parent=hdr) as remote:
        assert remote.context()[0] == tid
    spans = {r[3]: r for r in ttel.trace_spans()}
    assert spans["inner"][2] == spans["outer"][1]       # parent id
    assert spans["remote"][2] == spans["outer"][1]
    assert spans["outer"][7] == {"a": 1}
    path = ttel.dump_trace(str(tmp_path / "t.json"))
    data = json.load(open(path))
    xs = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"outer", "inner", "remote"}
    assert all(len(e["args"]["span_id"]) == 16 for e in xs)
    assert ttel.trace_stats()["spans"] == 3
    assert ttel.current_context() is None


def test_snapshot_sections_and_device_memory():
    ttel.counter_add("checkpoint.ttp_saves")
    snap = ttel.snapshot()
    for sec in ("serve", "router", "checkpoint", "fused", "datafeed",
                "decode", "other"):
        assert set(snap[sec]) >= {"counters", "gauges", "histograms"}
    assert "checkpoint.ttp_saves" in snap["checkpoint"]["counters"]
    dm = snap["device_memory"]
    assert dm["device_count"] == len(dm["devices"]) >= 1
    raw = ttel.raw_snapshot()
    assert set(raw) == set(jtel.raw_snapshot())


def test_disabled_recording_freezes_metrics():
    prev = ttel.set_enabled(False)
    try:
        ttel.counter_add("serve.ttp_frozen")
        assert "serve.ttp_frozen" not in ttel.raw_snapshot()["counters"]
    finally:
        ttel.set_enabled(prev)
    ttel.counter_add("serve.ttp_frozen")
    assert ttel.raw_snapshot()["counters"]["serve.ttp_frozen"] >= 1


# ---------------------------------------------------------------- profiler
@pytest.fixture
def profiling():
    for p in (tprof, jprof):
        p._events.clear()
        p.start()
    yield
    for p in (tprof, jprof):
        p.stop()
        p._events.clear()


def _drive(prof):
    for _ in range(3):
        with prof.scope("hot_op"):
            pass
    prof.pause()
    with prof.scope("invisible"):
        pass
    prof.resume()
    prof.Marker("saved").mark()
    c = prof.Counter("queue", value=1)
    c += 4
    c -= 2
    c.set_value(9)


def test_profiler_trace_and_table_match_the_reference(tmp_path, profiling):
    _drive(tprof)
    _drive(jprof)
    path = tprof.dump(path=str(tmp_path / "p.json"))
    data = json.load(open(path))
    evs = data["traceEvents"]
    assert [e["ph"] for e in evs] == [e["ph"] for e in jprof._events]
    assert [e["name"] for e in evs] == [e["name"] for e in jprof._events]
    assert [e.get("args") for e in evs if e["ph"] == "C"] == \
        [{"value": 5}, {"value": 3}, {"value": 9}]
    mine, theirs = tprof.dumps(), jprof.dumps()

    def shape(table):       # names, counts and the counter section
        return [re.sub(r"\d+\.\d", "T", ln).split() for ln in
                table.splitlines()]

    assert shape(mine) == shape(theirs)
    assert "invisible" not in mine


def test_profiler_device_trace_under_tensorboard_dir(tmp_path):
    tprof.set_config(tensorboard_dir=str(tmp_path / "tb"))
    try:
        tprof.start()
        torch.ones(64).mul(2.0).sum()
        tprof.stop()
    finally:
        tprof._config.pop("tensorboard_dir", None)
    path = tmp_path / "tb" / f"trace_{os.getpid()}.json"
    data = json.load(open(path))
    assert data["traceEvents"]


def test_profiler_autostart_dumps_at_exit(tmp_path):
    out = tmp_path / "auto.json"
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_PROFILER_AUTOSTART="1",
               MXNET_PROFILER_FILENAME=str(out))
    r = subprocess.run([sys.executable, "-c", (
        "from mxnet_tpu_torch import profiler\n"
        "with profiler.scope('startup'):\n    pass\n")], env=env,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    names = [e["name"] for e in json.load(open(out))["traceEvents"]]
    assert names == ["startup"]


def test_datafeed_gauges_feed_profiler_counters(profiling):
    from mxnet_tpu_torch.io import DataFeed
    batches = [(np.ones((2, 3), np.float32), np.zeros((2,), np.float32))
               for _ in range(3)]
    feed = DataFeed(batches, device="cpu", depth=2)
    try:
        for _ in feed:
            pass
    finally:
        feed.close()
    names = {e["name"] for e in tprof._events if e["ph"] == "C"}
    assert {"datafeed/staged", "datafeed/ring_depth"} <= names
    assert ttel.raw_snapshot()["gauges"]["datafeed.staged"] >= 3


def test_snapshot_feeds_profiler_counters(profiling):
    ttel.counter_add("serve.ttp_fed", 2)
    ttel.snapshot()
    assert any(e["name"] == "serve.ttp_fed" for e in tprof._events
               if e["ph"] == "C")


# ------------------------------------------------------------ fault grammar
SPECS = ["error", "batcher:delay:1.0:25", "server:black_hole:0.1:5000",
         "delay:0.5", "bogus", "server:bogus", "error:2.0", "error:-0.1",
         "delay:1.0:10:extra", "batcher:error", "commit:torn_write",
         "torn_write:0.5", "bitflip", "crash_after_tmp:1:3"]


def _parse(fn, spec):
    try:
        return fn(spec)
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("spec", SPECS)
def test_fault_parse_matrix_equals_the_reference(spec):
    assert _parse(tsfaults.parse, spec) == _parse(jsfaults.parse, spec)
    tdom = tfaults.domains()["MXNET_CKPT_FAULT"]
    jdom = jfaults.domains()["MXNET_CKPT_FAULT"]
    assert _parse(tdom.parse, spec) == _parse(jdom.parse, spec)


def test_fault_firing_counted(monkeypatch):
    before = ttel.raw_snapshot()["counters"].get("serve.fault.server.error",
                                                 0)
    monkeypatch.setenv(tsfaults.FAULT_ENV, "server:error:1.0")
    assert tsfaults.maybe("server") == ("error", 0.0)
    assert tsfaults.maybe("batcher") is None
    monkeypatch.delenv(tsfaults.FAULT_ENV)
    assert tsfaults.maybe("server") is None
    assert ttel.raw_snapshot()["counters"]["serve.fault.server.error"] == \
        before + 1


# -------------------------------------------------------------- lockwatch
_ABBA = r'''
import json, threading
from mxnet_tpu_torch import lockwatch, telemetry
assert lockwatch.installed()
a = threading.Lock()        # two construction sites: two nodes
b = threading.Lock()
with a:
    with b:
        pass
caught = None
try:
    with b:
        with a:
            pass
except lockwatch.LockCycleError as e:
    caught = str(e)
c = telemetry.raw_snapshot()["counters"]
# a count made while another watched lock is held (the registry's edge)
rl = threading.RLock()
with rl:
    telemetry.gauge_set("serve.ttp_under_lock", 1)
print(json.dumps({"caught": caught, "cycles": c.get("lockwatch.cycles"),
                  "edges": c.get("lockwatch.edges", 0),
                  "graph": len(lockwatch.order_graph())}))
'''


def test_lockwatch_catches_an_abba_inversion():
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_LOCK_CHECK="1")
    r = subprocess.run([sys.executable, "-c", _ABBA], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["caught"] and "lock-order inversion" in out["caught"]
    assert out["cycles"] == 1 and out["edges"] >= 2 and out["graph"] >= 2


# -------------------------------------------------------------- dump hooks
def test_sigusr2_and_exit_dumps(tmp_path):
    sig = tmp_path / "sig.json"
    env = dict(os.environ, PYTHONPATH=REPO,
               MXNET_TELEMETRY_DUMP_PATH=str(sig))
    script = ("import os, signal, time\n"
              "from mxnet_tpu_torch import telemetry\n"
              "telemetry.counter_add('serve.ttp_sig')\n"
              "os.kill(os.getpid(), signal.SIGUSR2)\n"
              "time.sleep(0.5)\n")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    d = json.load(open(sig))
    assert d["reason"] == "SIGUSR2" and d["version"] == 1
    assert d["snapshot"]["serve"]["counters"]["serve.ttp_sig"] == 1
    assert "threads" in d and "events" in d["trace"]
    ex = tmp_path / "exit.json"
    env.update(MXNET_TELEMETRY_DUMP_PATH=str(ex),
               MXNET_TELEMETRY_DUMP_ON_EXIT="1")
    r = subprocess.run([sys.executable, "-c",
                        "import mxnet_tpu_torch.telemetry"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.load(open(ex))["reason"] == "exit"
