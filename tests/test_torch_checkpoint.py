"""Checkpoints of the PyTorch port (``mxnet_tpu_torch.checkpoint``, the
Trainer's ``export_checkpoint_state`` / ``import_checkpoint_state``)
against the JAX package's on the CPU.

- the format crosses both ways bit for bit: the JAX package's
  ``CheckpointManager`` writes (a bf16 leaf included) and the port
  restores; the port writes and the JAX package restores;
- a JAX-package ``save_trainer`` of SGD with momentum and of Adam
  resumes in the port's Trainer, and one more step matches the JAX
  package's own next step (``STEP_TOL``);
- ``ModelRegistry.load`` of a checkpoint root serves the JAX package's
  predictions (``SERVE_TOL``);
- the three fault modes fall back; version rejection, keep-K, the tmp
  sweep, a live tensor changed in place after ``save``, ``on_preempt``,
  ``feed=``; a fused trainer resumes bit for bit, its generators
  included;
- a training subprocess is SIGKILLed mid-run and resumed bit for bit
  (``ckpt`` marker: conftest's alarm bounds it)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import checkpoint as jck  # noqa: E402
from mxnet_tpu.gluon import Trainer as JTrainer  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JLoss  # noqa
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import checkpoint as tck  # noqa: E402
from mxnet_tpu_torch import telemetry as ttel  # noqa: E402
from mxnet_tpu_torch.gluon import Trainer as TTrainer  # noqa: E402
from mxnet_tpu_torch.gluon import load_numpy  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss as TLoss  # noqa

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, D, C = 8, 6, 4
STEP_TOL = 1e-6     # one more fp32 step: of the tensor's largest |value|
SERVE_TOL = 1e-4    # fp32 ResNet-18 logits: of the largest |logit|


def _bits(a):
    """A leaf's bytes and dtype name, whichever package restored it."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().tobytes(), "bfloat16"
        a = a.numpy()
    a = np.asarray(a)
    return a.tobytes(), str(a.dtype)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _tree_np(rs):
    return {"params": {"w": rs.randn(3, 4).astype(np.float32),
                       "b": rs.randn(4).astype(np.float32)},
            "states": {"w": {"mom": rs.randn(3, 4).astype(np.float32)}},
            "ctl": {"t": np.asarray(7, np.int32),
                    "rng": np.asarray([1, 2], np.uint32)}}


# ------------------------------------------------------- the format, crossed
def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    import jax.numpy as jnp
    tree = _tree_np(np.random.RandomState(0))
    jtree = {"params": {"w": jnp.asarray(tree["params"]["w"]),
                        "b": jnp.asarray(tree["params"]["b"],
                                         jnp.bfloat16)},
             "states": {"w": {"mom": jnp.asarray(
                 tree["states"]["w"]["mom"])}},
             "ctl": {k: jnp.asarray(v) for k, v in tree["ctl"].items()}}
    jck.CheckpointManager(tmp_path).save(jtree, step=3, meta={"a": 1},
                                         blocking=True)
    got, meta, step = tck.CheckpointManager(tmp_path).restore()
    want, _, _ = jck.CheckpointManager(tmp_path).restore()
    assert step == 3 and meta == {"a": 1}
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert _bits(g[k]) == _bits(w[k]), k
    assert got["params"]["b"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_reference_bit_for_bit(tmp_path):
    tree = _tree_np(np.random.RandomState(1))
    ttree = {"params": {"w": torch.as_tensor(tree["params"]["w"]),
                        "b": torch.as_tensor(tree["params"]["b"]).to(
                            torch.bfloat16)},
             "states": {"w": {"mom": tree["states"]["w"]["mom"]}},
             "ctl": {"t": torch.tensor(7, dtype=torch.int32),
                     "rng": tree["ctl"]["rng"]}}
    tck.CheckpointManager(tmp_path).save(ttree, step=5, meta={"x": [1]},
                                         blocking=True)
    got, meta, step = jck.CheckpointManager(tmp_path).restore()
    mine, _, _ = tck.CheckpointManager(tmp_path).restore()
    assert step == 5 and meta == {"x": [1]}
    g, m = _flat(got), _flat(mine)
    assert sorted(g) == sorted(m)
    for k in g:
        assert _bits(g[k]) == _bits(m[k]), k
    assert str(got["params"]["b"].dtype) == "bfloat16"
    # the manifests name leaves, shards and order as the reference does
    man = json.load(open(tmp_path / "ckpt-00000005" / "manifest.json"))
    assert man["version"] == 1 and man["format"] == "mxtpu-ckpt"
    assert [lm["key"] for lm in man["leaves"]] == [
        "ctl/rng", "ctl/t", "params/b", "params/w", "states/w/mom"]
    assert [lm["file"] for lm in man["leaves"]] == \
        [f"s{i:05d}.bin" for i in range(5)]


# ------------------------------------------------- trainers, crossed
def _jnet():
    mx.seed(0)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(16, activation="relu"), jnn.Dense(C))
    net.initialize()
    net(mx.np.array(np.zeros((1, D), np.float32)))      # deferred shapes
    net.hybridize()
    return net


def _tnet(arrays):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(16, activation="relu"), tnn.Dense(C))
    load_numpy(net, arrays)
    net.hybridize()
    return net


def _batch(i):
    rs = np.random.RandomState(1000 + i)
    return rs.randn(B, D).astype(np.float32), \
        rs.randint(0, C, (B,)).astype(np.int32)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01})], ids=["sgd_momentum", "adam"])
def test_reference_trainer_checkpoint_resumes_in_port(tmp_path, opt, kw):
    jnet = _jnet()
    jtr = JTrainer(jnet.collect_params(), opt, dict(kw))
    jstep = jtr.fuse_step(JLoss())
    for i in range(3):
        jstep(*(mx.np.array(a) for a in _batch(i)))
    jck.CheckpointManager(tmp_path).save_trainer(jtr, blocking=True)
    jstep(*(mx.np.array(a) for a in _batch(3)))       # the next step
    want = {k: np.asarray(p.data()._data)
            for k, p in jnet.collect_params().items()}
    want_states = {k: {s: np.asarray(v) for s, v in st.items()}
                   for k, st in jtr._states.items()}

    zeros = {k: np.zeros_like(v) for k, v in want.items()}
    tnet = _tnet(zeros)
    ttr = TTrainer(tnet.collect_params(), opt, dict(kw))
    tstep = ttr.fuse_step(TLoss())
    with pytest.warns(UserWarning, match="ctl/rng"):
        step, meta = tck.CheckpointManager(tmp_path).restore_trainer(ttr)
    assert step == 3 and meta["num_update"] == 3
    assert ttr.optimizer.num_update == 3
    tstep(*(torch.as_tensor(a) for a in _batch(3)))
    for k, t in tnet.collect_params().items():
        _close(t.detach().numpy(), want[k], STEP_TOL)
    for k, st in want_states.items():
        for s, v in st.items():
            _close(ttr._states[k][s].numpy(), v, STEP_TOL)


def test_port_trainer_checkpoint_resumes_in_reference(tmp_path):
    jnet = _jnet()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    tnet = _tnet(arrays)
    kw = {"learning_rate": 0.1, "momentum": 0.9}
    ttr = TTrainer(tnet.collect_params(), "sgd", dict(kw))
    tstep = ttr.fuse_step(TLoss())
    for i in range(2):
        tstep(*(torch.as_tensor(a) for a in _batch(i)))
    tck.CheckpointManager(tmp_path).save_trainer(ttr, blocking=True)
    tstep(*(torch.as_tensor(a) for a in _batch(2)))
    want = {k: t.detach().numpy().copy()
            for k, t in tnet.collect_params().items()}
    jtr = JTrainer(jnet.collect_params(), "sgd", dict(kw))
    jstep = jtr.fuse_step(JLoss())
    step, meta = jck.CheckpointManager(tmp_path).restore_trainer(jtr)
    assert step == 2 and int(jtr._optimizer.num_update) == 2
    jstep(*(mx.np.array(a) for a in _batch(2)))
    for k, p in jnet.collect_params().items():
        _close(np.asarray(p.data()._data), want[k], STEP_TOL)


def test_registry_load_of_a_checkpoint_serves_reference_predictions(
        tmp_path):
    from mxnet_tpu.models import get_model as jget
    from mxnet_tpu.serve import ModelRegistry as JRegistry
    from mxnet_tpu_torch.serve import ModelRegistry as TRegistry
    from test_torch_resnet import weights_for
    item = (48, 48, 3)
    mx.seed(0)
    jnet = jget("resnet18_v1", classes=10)
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1,) + item, np.float32)))
    params = jnet.collect_params()
    arrays = weights_for([(k, p.shape) for k, p in params.items()], 5)
    for k, p in params.items():
        p.set_data(mx.np.array(arrays[k])._data)
    jck.CheckpointManager(tmp_path).save(
        {"params": {k: p.data()._data for k, p in params.items()}},
        step=1, blocking=True)
    x = np.random.RandomState(3).rand(*item).astype(np.float32)
    jreg = JRegistry(max_models=1)
    treg = TRegistry(max_models=1, device="cpu")
    try:
        jreg.load("r", str(tmp_path), arch="resnet18_v1", classes=10,
                  item_shape=item, buckets=(1,))
        treg.load("r", str(tmp_path), arch="resnet18_v1", classes=10,
                  item_shape=item, buckets=(1,))
        want = jreg.predict("r", x)[0]
        got = treg.predict("r", x)[0]
    finally:
        jreg.close()
        treg.close()
    _close(got, want, SERVE_TOL)
    assert got.argmax() == want.argmax()


# ------------------------------------------------------------- the manager
def _small_tree(v):
    return {"params": {"w": torch.full((3, 4), float(v)),
                       "b": torch.full((4,), float(v)).to(torch.bfloat16)},
            "ctl": {"t": torch.tensor(v, dtype=torch.int32)}}


def _equal_tree(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert _bits(g[k]) == _bits(w[k]), k


@pytest.mark.parametrize("mode", ["torn_write", "bitflip",
                                  "crash_after_tmp"])
def test_fault_falls_back_to_intact(tmp_path, mode, monkeypatch):
    mgr = tck.CheckpointManager(tmp_path, keep=5)
    mgr.save(_small_tree(1), step=1, blocking=True)
    monkeypatch.setenv("MXNET_CKPT_FAULT", mode)
    c0 = ttel.raw_snapshot()["counters"].get(
        f"checkpoint.fault.commit.{mode}", 0)
    try:
        mgr.save(_small_tree(2), step=2, blocking=True)
    except tck._InjectedCrash:
        assert mode == "crash_after_tmp"
    monkeypatch.delenv("MXNET_CKPT_FAULT")
    assert ttel.raw_snapshot()["counters"][
        f"checkpoint.fault.commit.{mode}"] == c0 + 1
    tree, _, step = mgr.restore()
    assert step == 1
    _equal_tree(tree, {k: v for k, v in _small_tree(1).items()})
    assert mgr.steps() == ([1] if mode == "crash_after_tmp" else [1, 2])
    # the JAX package falls back the same way on the same directory
    assert jck.CheckpointManager(tmp_path).restore()[2] == 1
    mgr.close()


def test_version_rejected_keep_k_and_tmp_sweep(tmp_path):
    mgr = tck.CheckpointManager(tmp_path, keep=2)
    os.makedirs(tmp_path / ".tmp-ckpt-00000009-1")
    for s in (1, 2, 3):
        mgr.save(_small_tree(s), step=s, blocking=True)
    assert mgr.steps() == [2, 3]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    man = tmp_path / "ckpt-00000003" / "manifest.json"
    m = json.load(open(man))
    m["version"] = 2
    json.dump(m, open(man, "w"))
    tree, _, step = mgr.restore()
    assert step == 2
    with pytest.raises(tck.NoCheckpointError):
        mgr.restore(step=1)
    with pytest.raises(tck.NoCheckpointError):
        tck.CheckpointManager(tmp_path / "empty").restore()
    with pytest.raises(NotImplementedError, match="item 7"):
        mgr.restore(shardings={"params/w": None})
    mgr.close()


def test_saved_values_are_the_boundarys(tmp_path):
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    mgr = tck.CheckpointManager(tmp_path, async_write=True)
    mgr.save({"w": w}, step=1)
    w.mul_(-1.0)                    # what the next in-place step does
    assert mgr.wait() is None
    tree, _, _ = mgr.restore()
    assert np.array_equal(tree["w"], np.arange(12.0).reshape(3, 4))
    st = mgr.stats()
    assert st["saves"] == 1 and st["pending"] == 0
    assert st["bytes_written"] == 48 and st["pending_bytes"] == 0
    mgr.close()


def test_mixed_dtype_saves_restore_bit_for_bit(tmp_path):
    rs = np.random.RandomState(5)
    mgr = tck.CheckpointManager(tmp_path, keep=2, async_write=True)
    want = {}
    for s in (1, 2):
        tree = {k: torch.from_numpy(rs.randn(*shape).astype(np.float32))
                .to(dt) for k, shape, dt in (
                    ("w", (64, 33), torch.float32),
                    ("e", (17, 8), torch.bfloat16),
                    ("h", (5, 3), torch.float16),
                    ("b", (7,), torch.float32))}
        want[s] = {k: _bits(v.clone()) for k, v in tree.items()}
        mgr.save(tree, step=s)
        for v in tree.values():
            v.add_(1)
    assert mgr.wait() is None
    for s, leaves in want.items():
        got, _, step = mgr.restore(step=s)
        assert step == s
        assert {k: _bits(got[k]) for k in leaves} == leaves
    mgr.close()


def test_writer_stages_each_card_flat_in_a_region_of_its_own():
    from types import SimpleNamespace as NS

    def flat(dev, nbytes):
        return NS(buf=NS(device=NS(type=dev)), nbytes=nbytes)

    flats = [flat("cuda", 4000), flat("cuda", 1026), flat("cpu", 99),
             flat("cuda", 6), flat("cuda", 64)]
    offs, total = tck._host_offsets(flats)
    assert offs[2] is None
    spans = sorted((o, o + f.nbytes) for o, f in zip(offs, flats)
                   if o is not None)
    assert all(o % 64 == 0 for o, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert total == spans[-1][1]
    assert tck._host_offsets([flat("cpu", 8)]) == ([None], 0)


def test_template_subtree_and_step(tmp_path):
    mgr = tck.CheckpointManager(tmp_path, keep=5)
    src = {"a": (torch.zeros(2), torch.ones(3, dtype=torch.int32)),
           "b": [torch.full((2, 2), 3.0)]}
    mgr.save(src, step=1, blocking=True)
    mgr.save({"x": np.asarray(2)}, step=2, blocking=True)
    tree, _, _ = mgr.restore(template=src, step=1)
    assert isinstance(tree["a"], tuple) and isinstance(tree["b"], list)
    assert np.array_equal(tree["b"][0], np.full((2, 2), 3.0))
    sub, _, _ = mgr.restore(step=1, subtree="a")
    assert sorted(sub) == ["0", "1"]
    assert int(mgr.restore()[0]["x"]) == 2
    mgr.close()


def test_on_preempt_and_feed_position(tmp_path):
    class Feed:
        def position(self):
            return {"epoch": 2, "batch": 17}

    net = _tnet({k: np.ones(s, np.float32) for k, s in
                 (("0.weight", (16, D)), ("0.bias", (16,)),
                  ("1.weight", (C, 16)), ("1.bias", (C,)))})
    tr = TTrainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    mgr = tck.CheckpointManager(tmp_path)
    mgr.save_trainer(tr, step=4, feed=Feed(), blocking=True)
    assert mgr.restore()[1]["datafeed"] == {"epoch": 2, "batch": 17}
    tr.optimizer.num_update = 9
    mgr.on_preempt(tr.export_checkpoint_state)()
    assert mgr.steps() == [4, 9]
    mgr.close()


def test_fused_trainer_resumes_bit_for_bit_with_its_generators(tmp_path):
    def build():
        tmx.seed(0)
        net = tnn.HybridSequential()
        net.add(tnn.Dense(16, activation="relu"), tnn.Dropout(0.3),
                tnn.Dense(C))
        net.initialize(ctx="cpu")
        net.hybridize()
        tr = TTrainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9})
        return net, tr, tr.fuse_step(TLoss())

    net, tr, step = build()
    mgr = tck.CheckpointManager(tmp_path)
    for i in range(5):
        step(*(torch.as_tensor(a) for a in _batch(i)))
        if i == 2:
            mgr.save_trainer(tr)
    mgr.wait()
    want = {k: t.detach().clone() for k, t in net.collect_params().items()}
    tree, _, _ = mgr.restore()
    assert sorted(tree["ctl"]) == ["generators", "t"]
    assert tree["ctl"]["t"].dtype == np.int32 and int(tree["ctl"]["t"]) == 3
    net2, tr2, step2 = build()
    torch.manual_seed(123)              # a different stream, if unrestored
    tmx.random.seed(7)
    mgr.restore_trainer(tr2)
    for i in range(3, 5):
        step2(*(torch.as_tensor(a) for a in _batch(i)))
    for k, t in net2.collect_params().items():
        assert torch.equal(t, want[k]), k
    mgr.close()


# ------------------------------------------------- kill and resume
_WORKER = r'''
import os, sys, time
import numpy as np
import torch
sys.path.insert(0, os.environ["REPO"])
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.gluon import nn, Trainer
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
torch.set_num_threads(1)
mode, root, arg = sys.argv[1], sys.argv[2], sys.argv[3]
dev = sys.argv[sys.argv.index("--device") + 1]


def build():
    mx.seed(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dropout(0.2), nn.Dense(4))
    net.initialize(ctx=dev)
    net.hybridize()
    tr = Trainer(net.collect_params(), "sgd",
                 {"learning_rate": 0.1, "momentum": 0.9})
    return net, tr, tr.fuse_step(SoftmaxCrossEntropyLoss())


def batch(i):
    rs = np.random.RandomState(1000 + i)
    return (torch.as_tensor(rs.randn(8, 6).astype("float32"), device=dev),
            torch.as_tensor(rs.randint(0, 4, (8,)).astype("int32"),
                            device=dev))


def dump(net, tr, path, k):
    out = {"p/" + n: t.detach().cpu().numpy()
           for n, t in net.collect_params().items()}
    for n, st in tr._states.items():
        for s, v in st.items():
            out[f"s/{n}/{s}"] = v.cpu().numpy()
    out["__step__"] = np.asarray(k)
    np.savez(path, **out)


if mode == "victim":
    net, tr, step = build()
    mgr = CheckpointManager(root, keep=3)
    for i in range(int(arg)):
        step(*batch(i))
        mgr.save_trainer(tr)        # async: a kill may land mid-commit
        print("SAVED", int(tr.optimizer.num_update), flush=True)
        time.sleep(0.05)
elif mode == "resume":
    net, tr, step = build()
    k, meta = CheckpointManager(root).restore_trainer(tr)
    for i in range(k, k + 5):
        step(*batch(i))
    dump(net, tr, arg, k)
elif mode == "reference":
    net, tr, step = build()
    for i in range(int(os.environ["CKPT_TOTAL_STEPS"])):
        step(*batch(i))
    dump(net, tr, arg, int(os.environ["CKPT_TOTAL_STEPS"]))
'''


@pytest.mark.ckpt
def test_kill_and_resume_bit_for_bit(tmp_path):
    """SIGKILL a training subprocess mid-run; the resumed process
    continues from the newest intact checkpoint and matches an
    uninterrupted run bit for bit over 5 more fused steps (parameters,
    momentum, the Dropout generator's stream)."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    root = str(tmp_path / "ckpts")
    env = {**os.environ, "REPO": REPO}
    env.pop("MXNET_CKPT_FAULT", None)
    dev = ["--device", "cpu"]
    victim = subprocess.Popen(
        [sys.executable, str(worker), "victim", root, "200"] + dev,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    saved = 0
    try:
        for line in victim.stdout:
            if line.startswith("SAVED"):
                saved = int(line.split()[1])
                if saved >= 3:
                    break
    finally:
        victim.kill()
        victim.wait(timeout=30)
    assert saved >= 3, victim.stderr.read()
    got_npz = str(tmp_path / "resume.npz")
    r = subprocess.run([sys.executable, str(worker), "resume", root,
                        got_npz] + dev, capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    got = np.load(got_npz)
    k = int(got["__step__"])
    assert 1 <= k <= saved + 1
    want_npz = str(tmp_path / "reference.npz")
    r = subprocess.run([sys.executable, str(worker), "reference", root,
                        want_npz] + dev, capture_output=True, text=True,
                       timeout=120, env={**env, "CKPT_TOTAL_STEPS": str(k + 5)})
    assert r.returncode == 0, r.stderr
    want = np.load(want_npz)
    assert set(got.files) == set(want.files)
    for key in got.files:
        if key != "__step__":
            assert np.array_equal(got[key], want[key]), key


def test_checkpoint_telemetry_section(tmp_path):
    mgr = tck.CheckpointManager(tmp_path, keep=2)
    mgr.save({"x": torch.ones(8)}, step=1, blocking=True)
    mgr.restore()
    sec = ttel.snapshot()["checkpoint"]
    names = set(sec["counters"]) | set(sec["gauges"]) | \
        set(sec["histograms"])
    assert {"checkpoint.saves", "checkpoint.last_success_step",
            "checkpoint.save_us", "checkpoint.pause_us",
            "checkpoint.restore_us"} <= names
    mgr.close()
