"""WorkersMerge in the port (``mxnet_tpu_torch.kvstore.workers_merge``):
the cases of the JAX package's ``tests/test_workers_merge.py``, each with
its counterpart here, in process: a real ParameterServer on a real
socket, a MergeLeader endpoint, and N "workers" as threads each holding
their own PSGroup connection (the loopback stand-in for N co-located
ranks; the multi-process run is ``test_torch_dist_kvstore``'s).  Also:
the leader's sums run on the native engine's pool threads, and a port
leader forwards its merged push to a JAX-package server, which applies
it once and replays it."""
import os
import struct
import threading

import numpy as onp
import pytest

pytest.importorskip("torch")

from mxnet_tpu_torch.kvstore.ps import (ParameterServer, PSClient,  # noqa
                                        PSGroup, _dec_num_merge,
                                        _enc_num_merge, decode_payload,
                                        pack_1bit, pack_2bit)
from mxnet_tpu_torch.kvstore.workers_merge import (MergeLeader,  # noqa
                                                   MergedPSGroup,
                                                   merge_enabled,
                                                   merge_timeout_s)

N_WORKERS = 4


@pytest.fixture
def loop(monkeypatch):
    """One in-process server + a PSGroup routed to it via the env path."""
    srv = ParameterServer()
    addr = srv.start(publish=False)
    monkeypatch.setenv("MXNET_TPU_PS_ADDRS", addr)
    group = PSGroup(seq=0, n=1)
    yield srv, group
    group.stop_servers()
    group.close()


def _merged_workers(group, laddr, n=N_WORKERS):
    """n worker-side stores, each with its OWN server connection (like
    distinct ranks) but pushing through the shared leader endpoint."""
    return [MergedPSGroup(PSGroup(seq=0, n=1), laddr) for _ in range(n)]


def _run_workers(stores, fn, timeout=60.0):
    errs = []

    def body(i):
        try:
            fn(i, stores[i])
        except BaseException as e:      # surfaced below, not swallowed
            errs.append(e)
    ts = [threading.Thread(target=body, args=(i,))
          for i in range(len(stores))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), \
        "a merged worker never unblocked — num_merge replay broken"
    if errs:
        raise errs[0]


def _close(stores, leader):
    for st in stores:
        st._merge_client.close()
    leader.stop()


# --------------------------------------------------------- wire trailer
def test_num_merge_trailer_roundtrip():
    buf = _enc_num_merge(7)
    assert _dec_num_merge(buf, 0) == 7
    assert _dec_num_merge(b"", 0) == 1          # absent → legacy frame
    assert _dec_num_merge(b"payload", 7) == 1   # body ends at payload
    with pytest.raises(ValueError):
        _dec_num_merge(struct.pack("<BBI", 0x58, 1, 3), 0)   # bad magic
    with pytest.raises(ValueError):
        _dec_num_merge(struct.pack("<BBI", 0x4D, 9, 3), 0)   # bad version


def test_legacy_client_still_talks_to_new_server(loop):
    """Backward compat: merge-disabled pushes (no trailer) are untouched."""
    srv, group = loop
    group.init("w", onp.zeros(4, onp.float32))
    group.push("w", ("raw", onp.full(4, 2.0, onp.float32)))
    onp.testing.assert_array_equal(group.pull("w"), 2.0)
    assert srv.stats["merged_pushes"] == 0
    assert srv.stats["push_frames"] == 1


def test_explicit_num_merge_one_omits_trailer(loop):
    srv, group = loop
    group.init("k", onp.zeros(2, onp.float32))
    group.clients[0].push(group._wk("k"),
                          ("raw", onp.ones(2, onp.float32)), num_merge=1)
    assert srv.stats["merged_pushes"] == 0      # legacy frame on the wire


# -------------------------------------------------- merged push fan-in
def test_server_sees_one_frame_per_key_per_round(loop):
    """4 loopback workers + merge → 4× fewer push frames."""
    srv, group = loop
    keys = ["a", "b", "c"]
    for k in keys:
        group.init(k, onp.zeros(8, onp.float32))
    plain = [PSGroup(seq=0, n=1) for _ in range(N_WORKERS)]
    base = srv.stats["push_frames"]
    _run_workers(plain, lambda i, st: [
        st.push(k, ("raw", onp.full(8, 1.0, onp.float32))) for k in keys])
    unmerged_frames = srv.stats["push_frames"] - base
    assert unmerged_frames == N_WORKERS * len(keys)
    for st in plain:
        st.close()

    leader = MergeLeader(group, group_size=N_WORKERS)
    stores = _merged_workers(group, leader.start())
    base = srv.stats["push_frames"]
    _run_workers(stores, lambda i, st: [
        st.push(k, ("raw", onp.full(8, 1.0, onp.float32))) for k in keys])
    merged_frames = srv.stats["push_frames"] - base
    assert merged_frames == len(keys)
    assert unmerged_frames == N_WORKERS * merged_frames      # 4× fewer
    assert srv.stats["merged_pushes"] == len(keys)
    assert srv.stats["replayed_replies"] == N_WORKERS * len(keys)
    _close(stores, leader)


def test_replay_unblocks_every_worker_and_sums(loop):
    srv, group = loop
    group.init("w", onp.zeros(8, onp.float32))
    leader = MergeLeader(group, group_size=N_WORKERS)
    stores = _merged_workers(group, leader.start())
    _run_workers(stores, lambda i, st: st.push(
        "w", ("raw", onp.full(8, float(2 ** i), onp.float32))))
    # 1+2+4+8: distinct per-worker contributions all present exactly once
    onp.testing.assert_array_equal(group.pull("w"), 15.0)
    _close(stores, leader)


def test_multiple_rounds_accumulate(loop):
    """Round boundaries: each round of group_size pushes → ONE frame."""
    srv, group = loop
    group.init("w", onp.zeros(4, onp.float32))
    leader = MergeLeader(group, group_size=N_WORKERS)
    stores = _merged_workers(group, leader.start())
    rounds = 3
    for _ in range(rounds):
        _run_workers(stores, lambda i, st: st.push(
            "w", ("raw", onp.ones(4, onp.float32))))
    assert srv.stats["push_frames"] == rounds
    onp.testing.assert_array_equal(group.pull("w"), rounds * N_WORKERS)
    _close(stores, leader)


def test_partial_flush_on_straggler_timeout(loop):
    """A round that never fills (a peer skipped a stale key / died)
    flushes partially after the timeout instead of deadlocking, counted
    in ``kvstore.merge_partial_flushes``."""
    from mxnet_tpu_torch import telemetry
    c0 = telemetry.raw_snapshot()["counters"].get(
        "kvstore.merge_partial_flushes", 0)
    srv, group = loop
    group.init("w", onp.zeros(4, onp.float32))
    leader = MergeLeader(group, group_size=N_WORKERS, timeout_s=0.3)
    stores = _merged_workers(group, leader.start(), n=2)   # 2 of 4 push
    _run_workers(stores, lambda i, st: st.push(
        "w", ("raw", onp.full(4, 1.0, onp.float32))), timeout=30.0)
    onp.testing.assert_array_equal(group.pull("w"), 2.0)
    assert telemetry.raw_snapshot()["counters"][
        "kvstore.merge_partial_flushes"] > c0
    _close(stores, leader)


def test_merge_sums_run_on_the_engine_pool(loop):
    """Each member's push is summed by an op of the native engine (a
    thread of its pool, which Python sees as a foreign thread), under
    the key's write variable."""
    srv, group = loop
    group.init("w", onp.zeros(4, onp.float32))
    leader = MergeLeader(group, group_size=2)
    assert type(leader._engine).__name__ == "_NativeEngine"
    names = []
    orig = leader._accumulate

    def spy(*a):
        names.append(threading.current_thread().name)
        return orig(*a)
    leader._accumulate = spy
    stores = _merged_workers(group, leader.start(), n=2)
    _run_workers(stores, lambda i, st: st.push(
        "w", ("raw", onp.ones(4, onp.float32))))
    assert len(names) == 2 and all(n.startswith("Dummy") for n in names)
    assert set(leader._vars) == {"w"}
    _close(stores, leader)


# -------------------------------------------------- numerical identity
def _sgd_run(merged: bool, steps=4, n=N_WORKERS, server_cls=None):
    """Train one key with the server-side SGD; return the final weights.

    All values are powers of two (weights, grads, lr) so float summation
    is EXACT and merged-vs-unmerged equality is bit for bit — vanilla SGD
    is linear in the gradient, so one step on sum(g_i) equals n
    sequential steps on each g_i.
    """
    from mxnet_tpu_torch import optimizer as opt_mod
    srv = (server_cls or ParameterServer)()
    addr = srv.start(publish=False)
    old = os.environ.get("MXNET_TPU_PS_ADDRS")
    os.environ["MXNET_TPU_PS_ADDRS"] = addr
    try:
        group = PSGroup(seq=0, n=1)
        w0 = (onp.arange(16, dtype=onp.float32) - 8.0) * 0.25
        group.init("w", w0)
        group.set_optimizer(opt_mod.create("sgd", learning_rate=0.5))
        if merged:
            leader = MergeLeader(group, group_size=n)
            stores = _merged_workers(group, leader.start(), n=n)
        else:
            stores = [PSGroup(seq=0, n=1) for _ in range(n)]
        for step in range(steps):
            grads = [(onp.arange(16, dtype=onp.float32) % 4 - 2.0)
                     * (2.0 ** -(step + i)) for i in range(n)]
            if merged:
                _run_workers(stores, lambda i, st: st.push(
                    "w", ("raw", grads[i])))
            else:
                for i, st in enumerate(stores):   # sequential: one
                    st.push("w", ("raw", grads[i]))  # optimizer step each
        out = group.pull("w")
        merged_frames = srv.stats["merged_pushes"]
        for st in stores:
            (st._merge_client if merged else st.clients[0]).close()
        if merged:
            leader.stop()
        group.stop_servers()
        group.close()
        return out, merged_frames
    finally:
        if old is None:
            os.environ.pop("MXNET_TPU_PS_ADDRS", None)
        else:
            os.environ["MXNET_TPU_PS_ADDRS"] = old


def test_merged_sgd_weights_bit_for_bit():
    """Merged and unmerged dense-SGD training end in the SAME weights,
    compared at byte granularity."""
    w_merged, frames = _sgd_run(merged=True)
    w_plain, _ = _sgd_run(merged=False)
    assert frames == 4
    assert w_merged.tobytes() == w_plain.tobytes()


def test_port_leader_merges_into_a_reference_server():
    """The port's leader forwards each round as one trailer-tagged frame
    to a JAX-package server, which applies it once and replays it; the
    weights equal the port server's run bit for bit."""
    from mxnet_tpu.kvstore.ps import ParameterServer as RefServer
    w_ref, frames = _sgd_run(merged=True, server_cls=RefServer)
    w_port, _ = _sgd_run(merged=True)
    assert frames == 4
    assert w_ref.tobytes() == w_port.tobytes()


# -------------------------------------------------- compressed payloads
@pytest.mark.parametrize("kind", ["2bit", "1bit"])
def test_compressed_payloads_merge(loop, kind):
    """Packed member pushes are decoded then summed by the leader — the
    server receives ONE dense frame equal to the sum of the unpacked
    gradients (≙ server-side decompress-then-sum semantics)."""
    srv, group = loop
    group.init("w", onp.zeros(8, onp.float32))
    leader = MergeLeader(group, group_size=N_WORKERS)
    stores = _merged_workers(group, leader.start())
    thr = 0.5
    rng = onp.random.RandomState(7)
    qs = []
    for i in range(N_WORKERS):
        g = rng.randn(8).astype(onp.float32)
        if kind == "2bit":
            qs.append(onp.where(g > thr, thr, onp.where(
                g < -thr, -thr, 0.0)).astype(onp.float32))
        else:
            qs.append(onp.where(g >= 0, thr, -thr).astype(onp.float32))
    payloads = [(kind,) + (pack_2bit(q, thr) if kind == "2bit"
                           else pack_1bit(q, thr)) for q in qs]
    base = srv.stats["push_frames"]
    _run_workers(stores, lambda i, st: st.push("w", payloads[i]))
    assert srv.stats["push_frames"] - base == 1
    onp.testing.assert_array_equal(group.pull("w"), sum(qs))
    _close(stores, leader)


def test_decode_payload_kinds():
    thr = 0.5
    q = onp.array([thr, -thr, 0.0, thr], onp.float32)
    onp.testing.assert_array_equal(decode_payload(("raw", q)), q)
    onp.testing.assert_array_equal(
        decode_payload(("2bit",) + pack_2bit(q, thr)), q)
    s = onp.where(q >= 0, thr, -thr).astype(onp.float32)
    onp.testing.assert_array_equal(
        decode_payload(("1bit",) + pack_1bit(s, thr)), s)
    with pytest.raises(ValueError):
        decode_payload(("gzip", b""))


# -------------------------------------------------- store-level gating
def test_merge_enabled_knob(monkeypatch):
    monkeypatch.delenv("MXNET_KVSTORE_USE_WORKERS_MERGE", raising=False)
    assert merge_enabled() is True                  # fork default: on
    monkeypatch.setenv("MXNET_KVSTORE_USE_WORKERS_MERGE", "0")
    assert merge_enabled() is False
    assert merge_enabled(True) is True              # explicit kwarg wins
    monkeypatch.setenv("MXNET_KVSTORE_USE_WORKERS_MERGE", "1")
    assert merge_enabled(False) is False
    monkeypatch.setenv("MXNET_TPU_MERGE_TIMEOUT", "2.5")
    assert merge_timeout_s() == 2.5


def test_single_process_store_skips_merge(loop):
    """nproc == 1 → merging is a pure latency tax; the store keeps a
    plain PSGroup client (setup_workers_merge is a no-op)."""
    from mxnet_tpu_torch import kvstore as kvs
    kv = kvs.create("dist_async", use_workers_merge=True)
    try:
        assert isinstance(kv._client, PSGroup)
        assert not isinstance(kv._client, MergedPSGroup)
    finally:
        kv._stop_servers()
