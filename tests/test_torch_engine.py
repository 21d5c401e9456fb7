"""The port's dependency engine (``mxnet_tpu_torch.engine``): the native
engine of ``csrc_host/engine.cc`` and ``_PythonEngine``, its plain
version, each through the cases of the JAX package's
``tests/test_engine.py`` (its storage cases are ``test_torch_io``'s since
the port's ``storage.py``), and the two held against each other and
against the JAX package's two engines on the same seeded op graphs:
every variable sees its reads and writes in the same order, and the same
values come out.  Also the engine's counters in
the port's telemetry, its survival across ``fork``, the Python engine
under ``MXNET_TPU_NO_NATIVE=1`` and a build that names its compiler when
it fails."""
import os
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from mxnet_tpu_torch import base, engine as eng, telemetry  # noqa: E402
from mxnet_tpu_torch.base import MXTpuError  # noqa: E402

KINDS = ["native", "python"]


def _engine(kind, naive=False, num_workers=0):
    """``native`` / ``python``: the port's engines; ``ref-native`` /
    ``ref-python``: the JAX package's."""
    if kind.startswith("ref-"):
        from mxnet_tpu import engine as module
        if kind == "ref-native" and module.LIB is None:
            pytest.fail("the JAX package's native engine did not load")
    else:
        module = eng
    cls = module._NativeEngine if kind.endswith("native") else \
        module._PythonEngine
    return cls(naive=naive, num_workers=num_workers)


def test_native_lib_loaded():
    """The engine the port uses is the native one, built from the port's
    own copy of the source."""
    assert base.lib() is not None and base.LIB is base.lib()
    assert base.lib_path().endswith("libmxnet_tpu_torch_engine.so")
    assert type(eng.Engine()).__name__ == "_NativeEngine"
    assert type(eng.engine()) is type(eng.engine()) and \
        eng.engine() is eng.engine()


@pytest.mark.parametrize("kind", KINDS)
def test_push_and_wait_all(kind):
    e = _engine(kind)
    v = e.new_variable()
    results = []
    for i in range(100):
        e.push(lambda i=i: results.append(i), mutable_vars=[v])
    e.wait_for_all()
    # writes to the same var are serialized in FIFO order
    assert results == list(range(100))
    assert e.num_executed == 100


@pytest.mark.parametrize("kind", KINDS)
def test_write_write_ordering(kind):
    e = _engine(kind)
    v = e.new_variable()
    out = []
    e.push(lambda: (time.sleep(0.05), out.append("a")), mutable_vars=[v])
    e.push(lambda: out.append("b"), mutable_vars=[v])
    e.wait_for_var(v)
    assert out == ["a", "b"]


@pytest.mark.parametrize("kind", KINDS)
def test_read_read_parallel_read_write_ordered(kind):
    e = _engine(kind)
    v = e.new_variable()
    state = {"x": 0}
    e.push(lambda: state.__setitem__("x", 1), mutable_vars=[v])
    seen = []
    barrier = threading.Barrier(2, timeout=5)

    def reader():
        # both readers run concurrently after the write: they meet at a
        # barrier, which only works if reads are granted in parallel
        barrier.wait()
        seen.append(state["x"])

    e.push(reader, const_vars=[v])
    e.push(reader, const_vars=[v])
    e.push(lambda: state.__setitem__("x", 2), mutable_vars=[v])
    e.wait_for_var(v)
    assert seen == [1, 1]
    assert state["x"] == 2


@pytest.mark.parametrize("kind", KINDS)
def test_raw_war_waw_chain(kind):
    e = _engine(kind)
    a, b = e.new_variable(), e.new_variable()
    log = []
    e.push(lambda: log.append("w_a"), mutable_vars=[a])
    e.push(lambda: log.append("r_a_w_b"), const_vars=[a], mutable_vars=[b])
    e.push(lambda: log.append("w_a2"), mutable_vars=[a])
    e.push(lambda: log.append("r_b"), const_vars=[b])
    e.wait_for_all()
    assert log.index("w_a") < log.index("r_a_w_b")
    assert log.index("r_a_w_b") < log.index("w_a2")   # WAR
    assert log.index("r_a_w_b") < log.index("r_b")    # RAW on b


@pytest.mark.parametrize("kind", KINDS)
def test_exception_at_wait_for_var(kind):
    e = _engine(kind)
    v = e.new_variable()

    def boom():
        raise ValueError("engine op failed")

    e.push(boom, mutable_vars=[v])
    with pytest.raises(MXTpuError, match="ValueError: engine op failed"):
        e.wait_for_var(v)
    # exception is rethrown once; a second wait succeeds (reference contract)
    e.wait_for_var(v)


@pytest.mark.parametrize("kind", KINDS)
def test_exception_at_wait_for_all(kind):
    e = _engine(kind)
    v = e.new_variable()
    e.push(lambda: (_ for _ in ()).throw(RuntimeError("bad")),
           mutable_vars=[v])
    with pytest.raises(MXTpuError, match="bad"):
        e.wait_for_all()


@pytest.mark.parametrize("kind", KINDS)
def test_naive_engine_sync(kind):
    e = _engine(kind, naive=True)
    v = e.new_variable()
    out = []
    e.push(lambda: out.append(1), mutable_vars=[v])
    # the naive engine executes inline — result visible immediately
    assert out == [1]
    assert e.num_executed == 1


def test_naive_engine_env_switch(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    e = eng.Engine()
    assert e.naive and type(e).__name__ == "_NativeEngine"


@pytest.mark.parametrize("kind", KINDS)
def test_delete_variable_after_pending_ops(kind):
    e = _engine(kind)
    v = e.new_variable()
    out = []
    e.push(lambda: (time.sleep(0.02), out.append(1)), mutable_vars=[v])
    e.delete_variable(v)
    e.wait_for_all()
    assert out == [1]


def test_bulk_context():
    assert eng.current_bulk_size() == 0
    with eng.bulk(16):
        assert eng.current_bulk_size() == 16
    assert eng.current_bulk_size() == 0


@pytest.mark.parametrize("kind", KINDS)
def test_cross_var_parallelism(kind):
    """Ops on disjoint vars run concurrently (two sleeps overlap)."""
    e = _engine(kind)
    a, b = e.new_variable(), e.new_variable()
    t0 = time.perf_counter()
    e.push(lambda: time.sleep(0.15), mutable_vars=[a])
    e.push(lambda: time.sleep(0.15), mutable_vars=[b])
    e.wait_for_all()
    assert time.perf_counter() - t0 < 0.29


@pytest.mark.parametrize("kind", KINDS)
def test_stress_many_ops(kind):
    e = _engine(kind)
    nvars = 8
    vars_ = [e.new_variable() for _ in range(nvars)]
    counters = [0] * nvars

    def bump(i):
        counters[i] += 1

    for it in range(50):
        for i in range(nvars):
            e.push(lambda i=i: bump(i), mutable_vars=[vars_[i]],
                   const_vars=[vars_[(i + 1) % nvars]] if it % 2 else [])
    e.wait_for_all()
    assert counters == [50] * nvars


def _graph_run(kind, seed, n_vars=6, n_ops=300):
    """A seeded random op graph: each op reads some vars and writes
    others, records, for every var it touches, its own id in that var's
    log, and folds what it read into what it writes.  → (per-var logs,
    final values)."""
    rng = np.random.RandomState(seed)
    e = _engine(kind, num_workers=4)
    vars_ = [e.new_variable() for _ in range(n_vars)]
    vals = [float(i) for i in range(n_vars)]
    logs = [[] for _ in range(n_vars)]
    mu = threading.Lock()
    for op in range(n_ops):
        k = rng.randint(1, 4)
        picked = rng.choice(n_vars, size=k, replace=False)
        n_w = rng.randint(0, k + 1)
        writes, reads = list(picked[:n_w]), list(picked[n_w:])

        def body(op=op, reads=reads, writes=writes):
            got = sum(vals[r] for r in reads)
            with mu:
                for r in reads:
                    logs[r].append(("r", op))
                for w in writes:
                    logs[w].append(("w", op))
            for w in writes:
                vals[w] = vals[w] * 0.5 + got + op
        e.push(body, const_vars=[vars_[r] for r in reads],
               mutable_vars=[vars_[w] for w in writes],
               priority=int(rng.randint(0, 3)))
    e.wait_for_all()
    # reads between two writes may run in any order among themselves:
    # compare each var's writes in order, and the set of reads between
    canon = []
    for log in logs:
        segs, cur = [], set()
        for kind_, op in log:
            if kind_ == "w":
                segs.append((frozenset(cur), op))
                cur = set()
            else:
                cur.add(op)
        segs.append((frozenset(cur), None))
        canon.append(segs)
    return canon, vals, e.num_executed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_engine_matches_python_engine_on_op_graphs(seed):
    """The same seeded op graph on the port's two engines and the JAX
    package's two: each variable's writes in the same order with the same
    reads between them, the same values (exactly: the ops' arithmetic
    runs in the same order on each var), the same number of ops
    executed."""
    runs = {k: _graph_run(k, seed)
            for k in ("native", "python", "ref-native", "ref-python")}
    want = runs["ref-python"]
    assert want[2] == 300
    for kind, got in runs.items():
        assert got[0] == want[0], kind
        assert got[1] == want[1], kind
        assert got[2] == want[2], kind


def test_engine_counters_reach_telemetry():
    """The native engine counts into its library's block; a snapshot's
    ``engine`` section carries the reference's counter names, the
    executed ops since the last snapshot, and each engine's state."""
    telemetry.snapshot()
    before = telemetry.raw_snapshot()["counters"]
    e = eng.Engine()
    v = e.new_variable()
    for _ in range(7):
        e.push(lambda: None, mutable_vars=[v])
    e.push(lambda: 1 / 0, mutable_vars=[v])
    with pytest.raises(MXTpuError, match="ZeroDivisionError"):
        e.wait_for_all()
    snap = telemetry.snapshot()["engine"]
    c = snap["counters"]
    for name in ("engine.ops_dispatched", "engine.ops_executed"):
        assert c[name] - before.get(name, 0) == 8, (name, c)
    assert c["engine.exceptions"] - before.get("engine.exceptions", 0) == 1
    assert {"engine.run_us", "engine.queue_wait_us"} <= \
        set(snap["histograms"])
    assert "engine.pending_ops" in snap["gauges"]
    assert any(s["executed"] >= 8 and s["workers"] >= 4
               for s in snap["state"])


def test_engine_survives_fork():
    """A forked child inheriting a live engine can still push and wait
    (≙ the reference's pthread_atfork guard, src/initialize.cc:73-100):
    the atfork child handler re-initializes the worker pool, so the
    child neither deadlocks nor crashes."""
    e = eng.Engine(naive=False)
    v = e.new_variable()
    ran = []
    e.push(lambda: ran.append(1), mutable_vars=[v])
    e.wait_for_all()
    assert ran == [1]

    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:                       # child
        try:
            os.close(r)
            got = []
            e.push(lambda: got.append(2), mutable_vars=[v])
            e.wait_for_all()
            os.write(w, b"OK" if got == [2] else b"NO")
            os._exit(0)
        except BaseException:
            try:
                os.write(w, b"EX")
            except OSError:
                pass
            os._exit(1)
    os.close(w)
    _, status = os.waitpid(pid, 0)
    msg = os.read(r, 2)
    os.close(r)
    assert status == 0 and msg == b"OK", (status, msg)
    # the parent's pool is untouched
    e.push(lambda: ran.append(3), mutable_vars=[v])
    e.wait_for_all()
    assert ran == [1, 3]


def test_no_native_selects_the_python_engine(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_NO_NATIVE", "1")
    assert base.lib() is None and base.LIB is None
    assert base.lib_path() is None
    assert type(eng.Engine()).__name__ == "_PythonEngine"


def test_failed_build_raises_naming_the_compiler(tmp_path, monkeypatch):
    """A build that fails raises with the command (the compiler first)
    and its output; nothing falls back silently."""
    from mxnet_tpu_torch import _host_build
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")

    def command(out):
        return ["g++", "-shared", "-fPIC", str(bad), "-o", str(out)]
    with pytest.raises(RuntimeError, match=r"building the native engine "
                                           r"failed:\ng\+\+ "):
        _host_build.stamped_build(tmp_path / "libx.so", "x_test",
                                  "the native engine", command, [bad])
    monkeypatch.setattr(_host_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found: the native"):
        _host_build._cxx("the native engine (csrc_host/engine.cc)")
