"""The port's parameter server and its wire (``mxnet_tpu_torch.kvstore.
ps``): the cases of the JAX package's ``tests/test_kvstore_ps.py``, each
with its counterpart here, and the wire held against the reference's:
the 2-bit and 1-bit packings and every frame encoding are its bytes, a
port ``PSClient`` drives a JAX-package ``ParameterServer`` and a
JAX-package client drives the port's (init, push, pull, set-optimizer,
compressed payloads, the ``num_merge`` trailer), in one process, and the
server-side SGD's results agree within 1e-6."""
import os
import socket
import struct
import threading
import time

import numpy as onp
import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu.kvstore import ps as rps  # noqa: E402
from mxnet_tpu import optimizer as ropt  # noqa: E402

from mxnet_tpu_torch import kvstore as kvs  # noqa: E402
from mxnet_tpu_torch import optimizer as opt_mod  # noqa: E402
from mxnet_tpu_torch.kvstore import ps  # noqa: E402
from mxnet_tpu_torch.kvstore.ps import (pack_1bit, pack_2bit,  # noqa: E402
                                        unpack_1bit, unpack_2bit)


@pytest.fixture
def stores():
    """dist_async stores made by a test, whose spawned servers are
    stopped after it; the addresses a one-process store publishes in
    this process's environment are removed with them."""
    before = {k for k in os.environ if k.startswith("MXNET_TPU_PS_ADDR_")}
    made = []
    yield made
    for kv in made:
        kv._stop_servers()
    for k in [k for k in os.environ
              if k.startswith("MXNET_TPU_PS_ADDR_") and k not in before]:
        del os.environ[k]


@pytest.fixture(scope="module")
def server():
    """One in-process parameter server: each store instance has its own
    key namespace on it (the standalone layout), so the tests that need
    no server process of their own share it."""
    srv = ps.ParameterServer()
    addr = srv.start(publish=False)
    yield addr
    srv.stop()


@pytest.fixture
def standalone(server, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PS_ADDRS", server)


def _async(stores, **kw):
    kv = kvs.create("dist_async", **kw)
    stores.append(kv)
    return kv


def test_pack_2bit_roundtrip_and_size():
    g = onp.random.RandomState(0).randn(1000).astype(onp.float32)
    q = onp.where(g > 0.5, 0.5,
                  onp.where(g < -0.5, -0.5, 0.0)).astype(onp.float32)
    packed, shape, t = pack_2bit(q, 0.5)
    # 16× smaller than the f32 payload (4 codes per byte vs 4 bytes each)
    assert packed.nbytes == 250 and q.nbytes == 4000
    assert onp.array_equal(unpack_2bit(packed, shape, t), q)


def test_pack_2bit_nonmultiple_of_4():
    q = onp.array([0.5, -0.5, 0.0, 0.5, -0.5], onp.float32)
    packed, shape, t = pack_2bit(q, 0.5)
    assert onp.array_equal(unpack_2bit(packed, shape, t), q)


def test_pack_1bit_roundtrip_and_size():
    g = onp.random.RandomState(1).randn(800).astype(onp.float32)
    q = onp.where(g >= 0, 0.25, -0.25).astype(onp.float32)
    packed, shape, t = pack_1bit(q, 0.25)
    assert packed.nbytes == 100 and q.nbytes == 3200   # 32×
    assert onp.array_equal(unpack_1bit(packed, shape, t), q)


def test_dist_async_store_push_pull(stores):
    """The worker-hosted layout: the store spawns its server process."""
    kv = _async(stores)
    assert len(kv._server_procs) == 1
    kv.init("w", torch.ones(4, 3))
    kv.push("w", torch.full((4, 3), 2.0))
    out = torch.zeros(4, 3)
    kv.pull("w", out=out)
    # no optimizer → pushes accumulate (base push semantics)
    assert torch.equal(out, torch.full((4, 3), 3.0))


def test_dist_async_server_side_optimizer(stores, standalone):
    kv = _async(stores)
    kv.init("x", torch.zeros(5))
    kv.set_optimizer(opt_mod.create("sgd", learning_rate=0.5))
    kv.push("x", torch.ones(5))
    out = torch.zeros(5)
    kv.pull("x", out=out)
    # one SGD step on the server copy: 0 - 0.5*1
    assert torch.equal(out, torch.full((5,), -0.5))


def test_dist_async_packed_compression_wire(stores, standalone):
    """With compression on, the wire payload is packed uint8 words; the
    server unpacks and applies — end to end through a real socket."""
    kv = _async(stores)
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("y", torch.zeros(8))
    payload = kv._pack("y", torch.full((8,), 0.7))
    assert payload[0] == "2bit" and payload[1].nbytes == 2   # 8 f32 → 2 B
    kv.push("y", torch.full((8,), 0.7))
    out = torch.zeros(8)
    kv.pull("y", out=out)
    assert torch.equal(out, torch.full((8,), 0.5))   # quantized to +t


def test_dist_async_pushpull_raises(stores, standalone):
    kv = _async(stores)
    with pytest.raises(RuntimeError):
        kv.pushpull(0, torch.ones(3))


def test_dist_async_trainer_requires_update_on_kvstore():
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(1, in_units=4)
    net.initialize(ctx="cpu")
    with pytest.raises(ValueError):
        gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_async",
                      update_on_kvstore=False)


def test_dist_async_trainer_converges(standalone):
    from mxnet_tpu_torch import autograd, gluon, seed
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn
    seed(0)
    net = nn.Dense(1, in_units=4)
    net.initialize(ctx="cpu")
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1}, kvstore="dist_async")
    try:
        X = torch.from_numpy(
            onp.random.RandomState(0).rand(64, 4).astype(onp.float32))
        Y = X.sum(dim=1, keepdim=True)
        lf = gloss.L2Loss()
        first = last = None
        for _ in range(30):
            with autograd.record():
                lv = lf(net(X), Y).mean()
            lv.backward()
            tr.step(1)
            last = float(lv.detach())
            first = last if first is None else first
        assert last < first * 0.1, (first, last)
    finally:
        tr._kvstore._stop_servers()


def test_dist_async_fast_worker_never_waits_for_slow_pusher():
    """Async contract ≙ kvstore_dist_server.h:882: a straggler's pushes
    must not gate another client's pulls — the server applies work per
    connection thread, no barrier anywhere."""
    srv = ps.ParameterServer()
    addr = srv.start(publish=False)
    try:
        fast = ps.PSClient(addr=addr)
        slow = ps.PSClient(addr=addr)
        fast.init("w", onp.zeros(4, onp.float32))
        release = threading.Event()
        slow_done = threading.Event()

        def straggler():
            release.wait(10)                     # "compute" stall
            slow.push("w", ("raw", onp.ones(4, onp.float32)))
            slow_done.set()

        t = threading.Thread(target=straggler, daemon=True)
        t.start()
        t0 = time.perf_counter()
        for _ in range(5):
            fast.push("w", ("raw", onp.ones(4, onp.float32)))
        out = fast.pull("w")
        dt = time.perf_counter() - t0
        assert onp.allclose(out, 5.0)            # straggler not included
        assert dt < 5.0, f"fast worker stalled {dt:.1f}s behind straggler"
        release.set()
        assert slow_done.wait(10)
        assert onp.allclose(fast.pull("w"), 6.0)  # late push lands
        fast.close()
        slow.close()
    finally:
        srv.stop()


def test_dist_async_client_surfaces_server_death():
    """A dead server fails the worker fast and loudly (a connection
    error), not with a hang."""
    srv = ps.ParameterServer()
    addr = srv.start(publish=False)
    c = ps.PSClient(addr=addr)
    c.init("w", onp.zeros(2, onp.float32))
    srv.stop()
    with pytest.raises((ConnectionError, OSError, RuntimeError)):
        for _ in range(10):                      # first call may still be
            c.pull("w")                          # buffered; soon it breaks
    c.close()


def test_ps_wire_rejects_garbage_frames():
    """The typed wire fails cleanly on malformed input: a garbage op gets
    RE_ERR, a truncated frame drops its connection, and the server keeps
    serving healthy clients."""
    srv = ps.ParameterServer()
    addr = srv.start(publish=False)
    try:
        host, _, port = addr.rpartition(":")
        s = socket.create_connection((host, int(port)), timeout=5)
        s.sendall(struct.pack("<IB", 4, 250) + b"\xde\xad\xbe\xef")
        hdr = b""
        while len(hdr) < 5:                      # TCP may segment
            chunk = s.recv(5 - len(hdr))
            assert chunk, "server closed instead of replying RE_ERR"
            hdr += chunk
        n, op = struct.unpack("<IB", hdr)
        assert op == 255                          # RE_ERR, not a crash
        s.close()
        s2 = socket.create_connection((host, int(port)), timeout=5)
        s2.sendall(struct.pack("<IB", 1000, 2) + b"short")
        s2.close()
        c = ps.PSClient(addr=addr)
        c.init("k", onp.ones(3, onp.float32))
        assert onp.allclose(c.pull("k"), 1.0)
        c.close()
    finally:
        srv.stop()


def test_ps_two_stores_share_standalone_servers_without_collision(
        monkeypatch):
    """In standalone-server mode every store instance reaches the SAME
    server set; wire keys are seq-namespaced so a second store's keys and
    set_optimizer cannot collide with the first (PSGroup._wk)."""
    srv = ps.ParameterServer()
    monkeypatch.setenv("MXNET_TPU_PS_ADDRS", srv.start(publish=False))
    try:
        a = ps.PSGroup(seq=0, n=1)
        b = ps.PSGroup(seq=1, n=1)
        a.init("x", onp.zeros(4, onp.float32))
        b.init("x", onp.full(4, 7.0, onp.float32))
        a.set_optimizer(opt_mod.create("sgd", learning_rate=0.5))
        a.push("x", ("raw", onp.ones(4, onp.float32)))
        b.push("x", ("raw", onp.ones(4, onp.float32)))
        assert onp.allclose(a.pull("x"), -0.5)   # one SGD step from 0
        assert onp.allclose(b.pull("x"), 8.0)    # plain += on 7
        a.close()
        b.close()
    finally:
        srv.stop()


def test_ps_updater_watchdog_surfaces_wedged_apply(monkeypatch):
    """A wedged server-side update becomes an RE_ERR frame within the
    watchdog budget — never a silent client hang."""
    srv = ps.ParameterServer()
    srv.start(publish=False)
    monkeypatch.setenv("MXNET_TPU_PS_UPDATE_TIMEOUT", "1")
    try:
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="updater wedged"):
            srv._exec_update(lambda abandoned: time.sleep(30))
        assert time.perf_counter() - t0 < 5.0
    finally:
        srv.stop()


def test_ps_optimizer_step_runs_off_rpc_threads():
    """The optimizer step executes on the dedicated updater thread
    (reference: kvstore_dist_server.h:999 single-thread Executor), not on
    whichever socketserver handler received the push."""
    srv = ps.ParameterServer()
    addr = srv.start(publish=False)
    seen = []
    orig = srv._opt_step

    def spy(key, opt, g, abandoned=None):
        seen.append(threading.current_thread().name)
        return orig(key, opt, g, abandoned)

    srv._opt_step = spy
    try:
        c = ps.PSClient(addr=addr)
        c.init("w", onp.zeros(3, onp.float32))
        c.set_optimizer(opt_mod.create("sgd", learning_rate=1.0))
        c.push("w", ("raw", onp.ones(3, onp.float32)))
        assert onp.allclose(c.pull("w"), -1.0)
        assert seen and all(n == "mxtpu-ps-updater" for n in seen)
        c.close()
    finally:
        srv.stop()


# ------------------------------------------ the wire against the reference
def _codes(seed, n, thr, kind):
    g = onp.random.RandomState(seed).randn(n).astype(onp.float32)
    if kind == "2bit":
        return onp.where(g >= thr, thr, onp.where(
            g <= -thr, -thr, 0.0)).astype(onp.float32)
    return onp.where(g >= 0, thr, -thr).astype(onp.float32)


@pytest.mark.parametrize("n", [1, 7, 8, 1000, 4097])
def test_packings_are_the_references_bytes(n):
    for kind, pack, rpack, unpack in (
            ("2bit", pack_2bit, rps.pack_2bit, unpack_2bit),
            ("1bit", pack_1bit, rps.pack_1bit, unpack_1bit)):
        q = _codes(n, n, 0.375, kind).reshape(-1, 1) if n % 7 == 0 else \
            _codes(n, n, 0.375, kind)
        got, ref = pack(q, 0.375), rpack(q, 0.375)
        assert got[0].tobytes() == ref[0].tobytes(), (kind, n)
        assert tuple(got[1]) == tuple(ref[1]) and got[2] == ref[2]
        assert onp.array_equal(unpack(*got), q)


def test_frames_are_the_references_bytes():
    """Keys, tensors of every dtype the wire names, raw and packed
    payloads, text and the num_merge trailer encode to the reference's
    bytes, and each side decodes the other's."""
    rs = onp.random.RandomState(5)
    assert ps._enc_key("0/w#1") == rps._enc_key("0/w#1")
    for dt in ("float32", "float64", "float16", "int8", "int32", "int64",
               "uint8", "bool"):
        a = (rs.randn(3, 4) * 10).astype(dt)
        assert ps._enc_tensor(a) == rps._enc_tensor(a), dt
        b, _ = ps._dec_tensor(rps._enc_tensor(a), 0)
        assert b.dtype == a.dtype and onp.array_equal(b, a)
    q = _codes(9, 37, 0.5, "2bit").reshape(37, 1)
    for payload in (("raw", rs.randn(5).astype(onp.float32)),
                    ("2bit",) + pack_2bit(q, 0.5),
                    ("1bit",) + pack_1bit(q, 0.5)):
        enc = ps._enc_payload(payload)
        assert enc == rps._enc_payload(payload)
        assert onp.array_equal(ps.decode_payload(ps._dec_payload(enc, 0)[0]),
                               rps.decode_payload(rps._dec_payload(enc, 0)[0]))
    assert ps._enc_text("x é") == rps._enc_text("x é")
    for n in (2, 5, 1 << 20):
        assert ps._enc_num_merge(n) == rps._enc_num_merge(n)
        assert rps._dec_num_merge(ps._enc_num_merge(n), 0) == n
    assert (ps.OP_INIT, ps.OP_PUSH, ps.OP_PULL, ps.OP_PUSHPULL,
            ps.OP_SET_OPT, ps.OP_STOP, ps.RE_OK, ps.RE_VAL, ps.RE_ERR) == \
        (rps.OP_INIT, rps.OP_PUSH, rps.OP_PULL, rps.OP_PUSHPULL,
         rps.OP_SET_OPT, rps.OP_STOP, rps.RE_OK, rps.RE_VAL, rps.RE_ERR)


def test_optimizer_config_crosses_both_ways():
    """Each package's JSON optimizer config builds the other's optimizer
    with the same registry name, learning rate, momentum, weight decay,
    per-key step counts and namespace."""
    port = opt_mod.create("sgd", learning_rate=0.25, momentum=0.5, wd=0.01)
    port._index_update_count = {"3": 4}
    port.num_update = 4
    ref = ropt.create("sgd", learning_rate=0.25, momentum=0.5, wd=0.01)
    ref._index_update_count = {"3": 4}
    ref.num_update = 4
    r_from_p, pre1 = rps._opt_from_wire(ps._opt_to_wire(port, "2/"))
    p_from_r, pre2 = ps._opt_from_wire(rps._opt_to_wire(ref, "2/"))
    assert pre1 == pre2 == "2/"
    for o in (r_from_p, p_from_r):
        assert type(o).__name__ == "SGD"
        assert (o.lr, o.momentum, o.wd, o.num_update) == (0.25, 0.5, 0.01, 4)
        assert o._index_update_count == {"2/3": 4}


def _drive(client_mod, addr, kind):
    """init, raw push (no optimizer: accumulate), pull, set_optimizer,
    a compressed push, a pushpull and a two-member merged push through a
    ``client_mod.PSClient`` → the values it pulled."""
    c = client_mod.PSClient(addr=addr)
    got = {}
    w0 = onp.arange(12, dtype=onp.float32).reshape(3, 4) * 0.25
    c.init("acc", w0)
    c.push("acc", ("raw", onp.ones((3, 4), onp.float32)))
    got["acc"] = c.pull("acc")
    c.init("w", w0)
    opt = (opt_mod if client_mod is ps else ropt).create(
        "sgd", learning_rate=0.5, momentum=0.9)
    c.set_optimizer(opt)
    q = _codes(4, 12, 0.5, kind).reshape(3, 4)
    pack = client_mod.pack_2bit if kind == "2bit" else client_mod.pack_1bit
    c.push("w", (kind,) + pack(q, 0.5))
    got["w_packed"] = c.pull("w")
    got["w_pushpull"] = c.pushpull(
        "w", ("raw", onp.full((3, 4), 0.125, onp.float32)))
    c.push("w", ("raw", onp.full((3, 4), 0.25, onp.float32)), num_merge=2)
    got["w_merged"] = c.pull("w")
    c.close()
    return got


@pytest.mark.parametrize("kind", ["2bit", "1bit"])
def test_port_client_and_reference_server_and_the_reverse(kind):
    """The same frames both ways: a port client against a JAX-package
    server, a JAX-package client against the port's server, each against
    a same-package pair; the values agree within 1e-6 of their largest
    magnitude (the servers' SGD is each package's own), the accumulating
    ones exactly, and each server counted the merged push."""
    results = {}
    for server_mod in (ps, rps):
        for client_mod in (ps, rps):
            srv = server_mod.ParameterServer()
            addr = srv.start(publish=False)
            try:
                results[(server_mod is ps, client_mod is ps)] = \
                    _drive(client_mod, addr, kind)
                assert srv.stats["merged_pushes"] == 1
                assert srv.stats["replayed_replies"] == 2
                assert srv.stats["push_frames"] == 4
            finally:
                srv.stop()
    base = results[(False, False)]
    for k, got in results.items():
        for name, v in got.items():
            ref = base[name]
            if name == "acc":
                assert onp.array_equal(v, ref), (k, name)
            else:
                assert onp.abs(v - ref).max() <= \
                    1e-6 * onp.abs(ref).max(), (k, name)
