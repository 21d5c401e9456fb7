"""The port's one-process KVStore (``mxnet_tpu_torch.kvstore``): the cases
of the JAX package's ``tests/test_kvstore.py``, each with its counterpart
here, and the port held against the reference on the same seeded arrays:
the local store's ``pushpull`` and ``push`` / ``pull`` (exactly: one sum
of the same fp32 copies), its server-side optimizer (within 1e-6), the
2-bit and 1-bit compression's codes and error-feedback residuals (bit
for bit), and P3's slices.  Multi-process stores are
``test_torch_dist_kvstore``'s; the wire and the parameter server
``test_torch_kvstore_ps``'s."""
import json
import os
import threading
import time

import numpy as onp
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import kvstore as rkvs  # noqa: E402
from mxnet_tpu import np as mnp  # noqa: E402
from mxnet_tpu import optimizer as ropt  # noqa: E402

from mxnet_tpu_torch import kvstore as kvs  # noqa: E402
from mxnet_tpu_torch import optimizer as opt_mod  # noqa: E402
from mxnet_tpu_torch.sparse import RowSparseNDArray  # noqa: E402

T = torch.tensor


def test_init_push_pull():
    kv = kvs.create("local")
    kv.init(3, torch.ones(2, 2))
    out = torch.zeros(2, 2)
    kv.pull(3, out=out)
    assert torch.equal(out, torch.ones(2, 2))


def test_push_aggregates_device_copies():
    """List-push sums across copies ≙ Comm::Reduce (comm.h:57)."""
    kv = kvs.create("device")
    kv.init("w", torch.zeros(3))
    kv.push("w", [torch.ones(3), torch.ones(3) * 2, torch.ones(3) * 3])
    out = torch.zeros(3)
    kv.pull("w", out=out)
    assert torch.equal(out, torch.full((3,), 6.0))


def test_pushpull():
    kv = kvs.create("device")
    kv.init(0, torch.zeros(4))
    out = torch.zeros(4)
    kv.pushpull(0, [torch.ones(4), torch.ones(4) * 4], out=out)
    assert torch.equal(out, torch.full((4,), 5.0))


def test_list_keys():
    kv = kvs.create("local")
    kv.init([1, 2], [torch.ones(2), torch.ones(2) * 2])
    o1, o2 = torch.zeros(2), torch.zeros(2)
    kv.pull([1, 2], out=[o1, o2])
    assert torch.equal(o1, torch.ones(2)) and \
        torch.equal(o2, torch.full((2,), 2.0))


def test_updater():
    """A store-side updater ``(key, grad, weight)`` updates the weight in
    place: weight' = weight - 0.5 * grad."""
    kv = kvs.create("local")
    kv.init("x", torch.ones(2))

    def upd(key, grad, weight):
        weight.sub_(0.5 * grad)

    kv.set_updater(upd)
    kv.push("x", torch.ones(2))
    out = torch.zeros(2)
    kv.pull("x", out=out)
    assert torch.equal(out, torch.full((2,), 0.5))


def test_update_on_kvstore_optimizer():
    """Server-side optimizer ≙ kvstore_dist_server.h:496 ApplyUpdates."""
    kv = kvs.create("device")
    kv.init("w", torch.ones(2))
    kv.set_optimizer(opt_mod.SGD(learning_rate=0.1))
    kv.push("w", torch.ones(2))
    out = torch.zeros(2)
    kv.pull("w", out=out)
    onp.testing.assert_allclose(out.numpy(), 0.9, rtol=1e-6)


def test_gradient_compression_2bit():
    """1-bit/2-bit + error feedback ≙ gradient_compression.h:37-122."""
    kv = kvs.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("g", torch.zeros(3))
    out = torch.zeros(3)
    kv.pushpull("g", T([0.3, 0.7, -0.9]), out=out)
    # quantized to {0, +t, -t}
    assert out.tolist() == [0.0, 0.5, -0.5]
    # residual [0.3,0.2,-0.4]+[0.3,0,0] = [0.6,0.2,-0.4] -> [0.5,0,0]
    out2 = torch.zeros(3)
    kv.pushpull("g", T([0.3, 0.0, 0.0]), out=out2)
    onp.testing.assert_allclose(out2.numpy(), [0.5, 0.0, 0.0], atol=1e-6)


def test_dist_single_process_fallback():
    kv = kvs.create("dist_sync")
    assert kv.rank == 0 and kv.num_workers == 1
    kv.init(0, torch.zeros(2))
    out = torch.zeros(2)
    kv.pushpull(0, torch.ones(2), out=out)
    assert torch.equal(out, torch.ones(2))
    kv.barrier()


def test_optimizer_state_io(tmp_path):
    """States round-trip through the port's file, and a JAX-package
    store's pickle of the same states loads into the port's store."""
    kv = kvs.create("device")
    kv.init("w", torch.ones(2))
    kv.set_optimizer(opt_mod.SGD(learning_rate=0.1, momentum=0.9))
    kv.push("w", torch.ones(2))
    f = str(tmp_path / "states.bin")
    kv.save_optimizer_states(f)
    mom = kv._opt_states["w"]["mom"].clone()
    kv._opt_states = {}
    kv.load_optimizer_states(f)
    assert torch.equal(kv._opt_states["w"]["mom"], mom)

    rk = rkvs.create("device")
    rk.init("w", mnp.ones((2,)))
    rk.set_optimizer(ropt.SGD(learning_rate=0.1, momentum=0.9))
    rk.push("w", mnp.ones((2,)))
    rf = str(tmp_path / "ref_states.bin")
    rk.save_optimizer_states(rf)
    kv._opt_states = {}
    kv.load_optimizer_states(rf)
    ref = {k: onp.asarray(v) for k, v in rk._opt_states["w"].items()}
    assert set(kv._opt_states["w"]) == set(ref)
    for k, v in ref.items():
        onp.testing.assert_array_equal(kv._opt_states["w"][k].numpy(), v)


def test_p3_store_slicing(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_SLICE_THRESHOLD", "10")
    kv = kvs.create("p3")
    assert type(kv).__name__ == "P3StoreDist"
    assert kv.slice_threshold == 10
    # aggregate across "devices", tensor larger than one slice
    g1 = torch.arange(25, dtype=torch.float32).reshape(5, 5)
    g2 = torch.ones(5, 5)
    out = torch.zeros(5, 5)
    kv.pushpull(3, [g1, g2], out=out, priority=-3)   # bare call drains
    assert torch.equal(out, g1 + g2)


def test_p3_priority_order():
    """pushpulls stage; flush drains highest-priority first — the queue
    really reorders."""
    from mxnet_tpu_torch.kvstore.p3 import P3StoreDist
    kv = P3StoreDist()
    order = []
    orig = kv._global_sum

    def spy(x):
        order.append(x.numel())
        return orig(x)
    kv._global_sum = spy
    a, b, c = torch.ones(4), torch.ones(8), torch.ones(2)
    with kv.batch():             # Trainer's per-step staging window
        kv.pushpull("k0", a, out=a, priority=0)
        kv.pushpull("k1", b, out=b, priority=5)
        kv.pushpull("k2", c, out=c, priority=3)
        assert order == []       # nothing drained inside the window
    assert order == [8, 2, 4]    # priority 5, then 3, then 0


def test_kvstore_server_role_runs_real_server(monkeypatch):
    """DMLC_ROLE=server runs a REAL parameter server (blocking loop) that
    owns its key slot — a client can init/push/pull through it."""
    from mxnet_tpu_torch.kvstore import kvstore_server
    from mxnet_tpu_torch.kvstore import ps as psmod

    monkeypatch.setenv("DMLC_ROLE", "server")
    monkeypatch.setenv("DMLC_SERVER_ID", "0")
    monkeypatch.setenv("MXNET_TPU_PS_BIND", "127.0.0.1")
    monkeypatch.setenv("MXNET_TPU_PS_ADDR_0_0", "")
    t = threading.Thread(
        target=kvstore_server._init_kvstore_server_module, daemon=True)
    t.start()
    for _ in range(200):
        if os.environ.get("MXNET_TPU_PS_ADDR_0_0"):
            break
        time.sleep(0.05)
    addr = os.environ["MXNET_TPU_PS_ADDR_0_0"]
    assert addr, "server never published its address"
    c = psmod.PSClient(addr=addr)
    c.init("w", onp.arange(4, dtype=onp.float32))
    c.push("w", ("raw", onp.ones(4, onp.float32)))
    assert onp.allclose(c.pull("w"), onp.arange(4) + 1)
    c.stop_server()
    c.close()
    t.join(10)
    assert not t.is_alive()
    monkeypatch.setenv("DMLC_ROLE", "worker")
    assert kvstore_server._init_kvstore_server_module() is False


def test_kvstore_server_optimizer_command():
    """kSetOptimizer takes the parameter server's JSON config (no pickle),
    a registry name or an optimizer; the store then updates on push."""
    from mxnet_tpu_torch.kvstore.ps import _opt_to_wire
    for body in (_opt_to_wire(opt_mod.create("sgd", learning_rate=0.5))
                 .encode(), b"sgd", opt_mod.create("sgd", learning_rate=0.5)):
        kv = kvs.create("local")
        ctrl = kvs.KVStoreServer(kv).controller()
        ctrl(0, body)
        assert kv._optimizer is not None
        kv.init(0, torch.ones(3))
        kv.push(0, torch.ones(3))
        out = torch.zeros(3)
        kv.pull(0, out=out)
        assert not torch.allclose(out, torch.ones(3))   # weight moved


def test_plugin_backends_gated():
    for name in ("horovod", "byteps"):
        with pytest.raises(ImportError, match=name):
            kvs.create(name)


def test_row_sparse_pull():
    kv = kvs.create("device")
    w = torch.arange(20, dtype=torch.float32).reshape(5, 4)
    kv.init(7, w)
    out = kv.row_sparse_pull(7, row_ids=T([3, 1, 3]))
    assert isinstance(out, RowSparseNDArray)
    assert out.indices.tolist() == [1, 3]
    assert torch.equal(out.data, w[[1, 3]])
    # the dense view holds only the pulled rows
    dense = out.tostype("default")
    assert torch.equal(dense[1], w[1]) and torch.all(dense[0] == 0)
    dst = torch.full((5, 4), 9.0)
    kv.row_sparse_pull(7, out=dst, row_ids=T([4]))
    assert torch.equal(dst[4], w[4]) and torch.all(dst[:4] == 0)
    with pytest.raises(ValueError):
        kv.row_sparse_pull(7)


def test_kvstore_server_profiler_command(tmp_path):
    from mxnet_tpu_torch import profiler
    kv = kvs.create("local")
    ctrl = kvs.KVStoreServer(kv).controller()
    fname = str(tmp_path / "server_profile.json")
    ctrl(2, f"kSetConfig:{json.dumps({'filename': fname})}".encode())
    ctrl(2, b"kState:run")
    with profiler.scope("server_op"):
        pass
    ctrl(2, b"kState:stop")
    ctrl(2, b"kDump")
    assert os.path.exists(fname)


# ------------------------------------------------ parity with the reference
def _arrays(seed, shape, n):
    rs = onp.random.RandomState(seed)
    return [rs.randn(*shape).astype(onp.float32) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_local_pushpull_equals_the_reference(n):
    """The same list of fp32 copies through both packages' local store:
    the aggregate, written to ``out`` and (without ``out``) into each
    copy, is the reference's bit for bit (tolerance 0: one sum of the
    copies in list order)."""
    xs = _arrays(3 + n, (33, 17), n)
    ref = rkvs.create("device")
    rout = mnp.zeros((33, 17))
    ref.pushpull(5, [mnp.array(x) for x in xs], out=rout)
    kv = kvs.create("device")
    out = torch.zeros(33, 17)
    kv.pushpull(5, [torch.from_numpy(x.copy()) for x in xs], out=out)
    assert onp.array_equal(out.numpy(), rout.asnumpy())
    copies = [torch.from_numpy(x.copy()) for x in xs]
    kv.pushpull(5, copies)
    for c in copies:
        assert onp.array_equal(c.numpy(), rout.asnumpy())


def test_local_push_pull_and_optimizer_equal_the_reference():
    """Accumulating pushes, then a store-side SGD with momentum over three
    pushes of two copies each: the pulled weights are the reference's
    within 1e-6 of their largest magnitude."""
    w0 = _arrays(11, (64,), 1)[0]
    grads = _arrays(12, (64,), 6)
    for with_opt in (False, True):
        ref, kv = rkvs.create("device"), kvs.create("device")
        ref.init("w", mnp.array(w0))
        kv.init("w", torch.from_numpy(w0.copy()))
        if with_opt:
            ref.set_optimizer(ropt.SGD(learning_rate=0.1, momentum=0.9))
            kv.set_optimizer(opt_mod.SGD(learning_rate=0.1, momentum=0.9))
        for i in range(3):
            pair = grads[2 * i:2 * i + 2]
            ref.push("w", [mnp.array(g) for g in pair])
            kv.push("w", [torch.from_numpy(g.copy()) for g in pair])
        rout = mnp.zeros((64,))
        ref.pull("w", out=rout)
        out = torch.zeros(64)
        kv.pull("w", out=out)
        r = rout.asnumpy()
        assert onp.abs(out.numpy() - r).max() <= 1e-6 * onp.abs(r).max()
        if not with_opt:
            assert onp.array_equal(out.numpy(), r)


@pytest.mark.parametrize("kind", ["2bit", "1bit"])
def test_compression_codes_and_residuals_equal_the_reference(kind):
    """Five compressed pushes of seeded gradients with thresholds that
    fp32 cannot hold exactly: each quantized aggregate and the residual
    kept after it equal the reference's bit for bit."""
    thr = 0.3
    params = {"type": kind, "threshold": thr}
    ref, kv = rkvs.create("device"), kvs.create("device")
    ref.set_gradient_compression(params)
    kv.set_gradient_compression(params)
    for i, g in enumerate(_arrays(21, (7, 9), 5)):
        rout = mnp.zeros((7, 9))
        ref.pushpull("g", mnp.array(g * (i + 1)), out=rout)
        out = torch.zeros(7, 9)
        kv.pushpull("g", torch.from_numpy(g * (i + 1)), out=out)
        assert onp.array_equal(out.numpy(), rout.asnumpy()), i
        assert onp.array_equal(
            kv._compression._residual["g"].numpy(),
            onp.asarray(ref._compression._residual["g"])), i


def test_p3_slices_equal_the_reference(monkeypatch):
    """P3's slice-by-slice aggregate with 2-bit compression per slice is
    the reference's bit for bit."""
    monkeypatch.setenv("MXNET_KVSTORE_SLICE_THRESHOLD", "16")
    from mxnet_tpu.kvstore.p3 import P3StoreDist as RefP3
    from mxnet_tpu_torch.kvstore.p3 import P3StoreDist
    ref, kv = RefP3(), P3StoreDist()
    for s in (ref, kv):
        s.set_gradient_compression({"type": "2bit", "threshold": 0.4})
    xs = _arrays(31, (6, 7), 2)
    rout = mnp.zeros((6, 7))
    ref.pushpull(1, [mnp.array(x) for x in xs], out=rout)
    out = torch.zeros(6, 7)
    kv.pushpull(1, [torch.from_numpy(x.copy()) for x in xs], out=out)
    assert onp.array_equal(out.numpy(), rout.asnumpy())


def test_runtime_features():
    """``mx.runtime``: the reference's feature names, true for this
    build."""
    from mxnet_tpu import runtime as rrt
    from mxnet_tpu_torch import runtime
    f = runtime.Features()
    assert set(f) == set(rrt.Features())
    assert not f.is_enabled("tpu") and not f.is_enabled("XLA") and \
        not f.is_enabled("PALLAS")
    assert f.is_enabled("GPU") == torch.cuda.is_available()
    assert f.is_enabled("dist_kvstore") and f.is_enabled("CPU")
    assert repr(runtime.feature_list()[0]).endswith("TPU]")
