"""Multi-process dist KVStore runs on the CPU (≙ the JAX package's
``tests/test_dist_kvstore.py``): the worker programs of
``mxnet_tpu_torch.kvstore.nightly`` and the port's two distributed
examples, each job started by ``python -m mxnet_tpu_torch.launch
--launcher local`` as the reference's nightly tier runs (gloo over the
CPU).  Also a two-process ``dist_sync`` step held against the JAX
package's ``KVStore("local")`` given the two ranks' gradients as a list,
then the same optimizer (within 1e-6 of the weights' largest magnitude:
each package's SGD arithmetic is its own), and the examples' runs gated
as the card's ``dist_sync_train`` and ``ps_train`` phases gate them.
Marked ``dist``: conftest's alarm bounds each test, and each job has its
own timeout."""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

pytestmark = pytest.mark.dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 240


def _start(cwd, n, *command, extra=(), env=None):
    """Start ``command`` (argv after ``python``) on ``n`` workers under
    the port's local launcher → its Popen (:func:`_wait` ends it)."""
    e = {k: v for k, v in os.environ.items()
         if not k.startswith(("MXNET_TPU_PS_ADDR", "MXNET_TPU_WM_"))}
    e["PYTHONPATH"] = ROOT
    for k in ("MXNET_KVSTORE_USE_WORKERS_MERGE",
              "MXNET_TELEMETRY_DUMP_ON_EXIT", "OMP_NUM_THREADS"):
        e.pop(k, None)
    e.update(env or {})
    return subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(n),
         *extra, "--launcher", "local", sys.executable, *command],
        cwd=str(cwd), env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _wait(p):
    """The job's CompletedProcess, within :data:`JOB_TIMEOUT_S` (killed
    when it overruns)."""
    try:
        out, err = p.communicate(timeout=JOB_TIMEOUT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def _launch(cwd, n, *command, extra=(), env=None):
    """:func:`_start`, then :func:`_wait`."""
    return _wait(_start(cwd, n, *command, extra=extra, env=env))


def _ok(r):
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"


def _nightly(tmp_path, n, program, extra=()):
    return _launch(tmp_path, n, "-m", "mxnet_tpu_torch.kvstore.nightly",
                   program, "--device", "cpu", extra=extra)


def _reports(stdout):
    return sorted((json.loads(ln.split(" ", 1)[1])
                   for ln in stdout.splitlines()
                   if ln.startswith("dist_report ")),
                  key=lambda d: d["rank"])


@pytest.mark.parametrize("sep", [[], ["--"]])
def test_launcher_keeps_the_commands_own_double_dash(tmp_path, sep):
    """The launcher drops only a ``--`` that separates its options from
    the command; a ``--`` inside the command reaches the worker's argv."""
    out = tmp_path / "argv.txt"
    code = "import sys; open(sys.argv[1], 'w').write(repr(sys.argv[1:]))"
    e = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "1",
         "--launcher", "local", *sep, sys.executable, "-c", code,
         str(out), "--", "x"], cwd=str(tmp_path), env=e,
        capture_output=True, text=True, timeout=JOB_TIMEOUT_S)
    _ok(r)
    assert out.read_text() == repr([str(out), "--", "x"])


def test_dist_sync_kvstore_four_workers(tmp_path):
    """4 workers: pushpull sums, the batched list in one all-reduce, the
    2-bit compression residual, row-sparse pulls over dist."""
    r = _nightly(tmp_path, 4, "dist_sync_kvstore")
    _ok(r)
    assert r.stdout.count("dist_sync_kvstore OK") == 4


def test_dist_async_training_two_workers(tmp_path):
    """dist_async: the parameter-server path, per-push server updates, no
    worker barrier (kvstore_dist_server.h:882)."""
    r = _nightly(tmp_path, 2, "dist_async_train")
    _ok(r)
    assert r.stdout.count("dist_async_train OK") == 2


def test_dist_sync_training_two_workers(tmp_path):
    """Trainer + dist_device_sync: parameters stay identical across
    workers while training on different data."""
    r = _nightly(tmp_path, 2, "dist_device_sync_train")
    _ok(r)
    assert r.stdout.count("dist sync training OK") == 2


def test_dist_async_multiserver_hosted(tmp_path):
    """4 workers × 2 worker-hosted servers: round-robin key ownership,
    big-array slicing, a sharded server-side optimizer."""
    r = _nightly(tmp_path, 4, "dist_async_multiserver", extra=("-s", "2"))
    _ok(r)
    assert r.stdout.count("dist_async_multiserver OK") == 4


def test_dist_async_multiserver_standalone_procs(tmp_path):
    """The same battery with DMLC_ROLE=server processes started by the
    launcher (--server-procs), the reference's scheduler + server
    layout.  (The JAX package's launcher fails this layout: it loads
    ``ps.py`` by file path, whose relative import then fails.)"""
    r = _nightly(tmp_path, 4, "dist_async_multiserver",
                 extra=("-s", "2", "--server-procs"))
    _ok(r)
    assert r.stdout.count("dist_async_multiserver OK") == 4
    assert r.stderr.count("[launch] server ") == 2


BERT_SMALL = ("--device", "cpu", "--layers", "2", "--hidden", "64",
              "--vocab", "1000", "--heads", "2", "--steps", "3",
              "--batch-size", "2", "--seq-len", "16")
IMAGE_SMALL = ("--device", "cpu", "--model", "resnet18_v1",
               "--image-size", "32", "--batch-size", "2", "--iters", "1",
               "--classes", "10")


def _bert_dist_sync(tmp_path):
    """``examples.bert_pretrain`` on two workers, started; :func:`_bert_ok`
    gates it."""
    return _start(tmp_path, 2, "-m", "mxnet_tpu_torch.examples.bert_pretrain",
                  *BERT_SMALL, "--dump-dir", str(tmp_path / "grads"))


def _bert_ok(tmp_path, job):
    """The BERT job gated as the card's ``dist_sync_train`` gates it → the
    two reports."""
    dump = tmp_path / "grads"
    r = _wait(job)
    _ok(r)
    reps = _reports(r.stdout)
    assert [d["rank"] for d in reps] == [0, 1]
    assert all(d["backend"] == "gloo" for d in reps)
    # after every step both ranks hold the same parameters, bit for bit
    assert reps[0]["params_sha256"] == reps[1]["params_sha256"]
    assert len(set(reps[0]["params_sha256"])) == 3
    assert all(np.isfinite(d["losses"]).all() for d in reps)
    # step 0's reduced gradient is (g_0 + g_1) / 2, bit for bit
    g = [np.load(dump / f"grads_rank{i}.npz") for i in (0, 1)]
    names = [k[len("local/"):] for k in g[0].files if k.startswith("local/")]
    assert "embed/tok" in names and "layers/1/qkv/kernel" in names
    for n in names:
        want = (g[0][f"local/{n}"] + g[1][f"local/{n}"]) / np.float32(2)
        assert not np.array_equal(g[0][f"local/{n}"], g[1][f"local/{n}"])
        for i in (0, 1):
            assert np.array_equal(g[i][f"reduced/{n}"], want), (n, i)
    return reps


def _image_dist_async(tmp_path, merge):
    """``examples.image_classification --kvstore dist_async`` on two
    workers and one server process, every process dumping its telemetry
    at exit, started; :func:`_image_ok` reads it."""
    run = tmp_path / f"merge{merge}"
    run.mkdir()
    return _start(run, 2, "-m",
                  "mxnet_tpu_torch.examples.image_classification",
                  *IMAGE_SMALL, "--kvstore", "dist_async",
                  extra=("-s", "1", "--server-procs"),
                  env={"MXNET_KVSTORE_USE_WORKERS_MERGE": str(merge),
                       "MXNET_TELEMETRY_DUMP_ON_EXIT": "1",
                       "MXNET_TPU_MERGE_TIMEOUT": "60"})


def _image_ok(tmp_path, merge, job):
    """→ (the two reports, the server's ``kvstore_server`` dump section,
    the workers' counters)."""
    run = tmp_path / f"merge{merge}"
    r = _wait(job)
    _ok(r)
    reps = _reports(r.stdout)
    dumps = [json.load(open(p)) for p in
             glob.glob(str(run / "mxtpu_telemetry_*.json"))]
    server = [d["kvstore_server"] for d in dumps if "kvstore_server" in d]
    workers = [d["snapshot"]["kvstore"]["counters"] for d in dumps
               if d["argv"][0].endswith("image_classification.py")]
    assert len(reps) == 2 and len(server) == 1 and len(workers) == 2, \
        (r.stdout, r.stderr)
    return reps, server[0], workers


def test_distributed_examples_run(tmp_path):
    """The port's distributed examples run end to end, gated as the card's
    ``dist_sync_train`` and ``ps_train`` phases gate them: BERT
    pretraining on ``dist_sync`` (the ranks' parameters equal bit for bit
    after every step, step 0's reduced gradient the mean of the local
    ones bit for bit), and ResNet-18 through ``dist_async`` with a server
    process, with WorkersMerge off and on: both workers' pulled weights
    equal the server's copy bit for bit, the server never made a CUDA
    context, and with the merge the server receives keys × steps push
    frames, exactly half of those without it, none flushed partially."""
    jobs = {m: _image_dist_async(tmp_path, m) for m in (0, 1)}
    bert = _bert_dist_sync(tmp_path)
    runs = {m: _image_ok(tmp_path, m, job) for m, job in jobs.items()}
    _bert_ok(tmp_path, bert)
    steps = 3                           # 2 warm-up steps + --iters 1
    from mxnet_tpu_torch.examples.image_classification import \
        digest_of_digests
    for reps, server, _ in runs.values():
        assert all(d["kvstore"] == "dist_async" for d in reps)
        assert not server["cuda_initialized"]
        assert server["cuda_visible_devices"] == ""
        keyed = {int(k.split("/", 1)[1]): v
                 for k, v in server["sha256"].items()}
        assert sorted(keyed) == list(range(len(keyed)))
        want = digest_of_digests(keyed[k] for k in sorted(keyed))
        for d in reps:
            assert d["keys"] == len(keyed)
            assert d["weights_sha256"] == want
            assert np.isfinite(d["losses"]).all()
    (_, s_off, _), (_, s_on, w_on) = runs[0], runs[1]
    keys = len(s_on["sha256"])          # ResNet-18 v1's 65 parameters
    assert keys == len(s_off["sha256"]) == 65
    assert s_on["stats"]["push_frames"] == keys * steps
    assert s_off["stats"]["push_frames"] == 2 * keys * steps
    assert s_on["stats"]["merged_pushes"] == keys * steps
    assert s_off["stats"]["merged_pushes"] == 0
    assert sum(c.get("kvstore.merge_rounds", 0) for c in w_on) == \
        keys * steps
    assert sum(c.get("kvstore.merge_partial_flushes", 0) for c in w_on) == 0


WORKER = r'''
import os, sys
import numpy as np
import torch
from mxnet_tpu_torch import autograd, gluon, seed
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.parallel import dist

dist.initialize()
rank, n = dist.rank(), dist.size()
seed(3)
net = nn.HybridSequential()
net.add(nn.Dense(8, activation="relu", in_units=6), nn.Dense(3, in_units=8))
net.initialize(ctx="cpu")
params = net.collect_params()
tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                   kvstore="dist_sync")
lf = gluon.loss.SoftmaxCrossEntropyLoss()
rng = np.random.RandomState(50 + rank)
out = {f"w0/{k}": p.detach().numpy().copy() for k, p in params.items()}
for step in range(2):
    x = torch.from_numpy(rng.rand(4, 6).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 3, 4))
    with autograd.record():
        l = lf(net(x), y)
    l.backward(torch.ones_like(l))
    for k, p in params.items():
        out[f"g{step}/{k}"] = p.grad.numpy().copy()
    tr.step(4 * n)
for k, p in params.items():
    out[f"w/{k}"] = p.detach().numpy().copy()
np.savez(os.path.join(sys.argv[1], f"rank{rank}.npz"), **out)
dist.finalize()
'''


def test_two_process_dist_sync_matches_the_reference_local_store(tmp_path):
    """Two ranks, two SGD-momentum steps through ``Trainer(kvstore=
    "dist_sync")`` on different data: each rank's weights equal the JAX
    package's ``KVStore("local")`` pushpull of the two ranks' gradients
    as a list, then its SGD with the same rescale, from the same start
    (within 1e-6 of the largest weight), and the ranks equal each other
    bit for bit."""
    from mxnet_tpu import kvstore as rkvs
    from mxnet_tpu import np as mnp
    from mxnet_tpu import optimizer as ropt
    from mxnet_tpu.ndarray import NDArray
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    _ok(_launch(tmp_path, 2, str(script), str(tmp_path)))
    ranks = [np.load(tmp_path / f"rank{i}.npz") for i in (0, 1)]
    names = [k[3:] for k in ranks[0].files if k.startswith("w0/")]
    for k in ranks[0].files:
        if k.startswith("w0/") or k.startswith("w/"):
            assert np.array_equal(ranks[0][k], ranks[1][k]), k
    kv = rkvs.create("local")
    opt = ropt.SGD(learning_rate=0.1, momentum=0.9)
    opt.rescale_grad = 1.0 / 8
    ws = {n: NDArray(mnp.array(ranks[0][f"w0/{n}"])._data) for n in names}
    states = {n: opt.create_state(n, ws[n]) for n in names}
    for step in range(2):
        for n in names:
            out = mnp.zeros(ranks[0][f"w0/{n}"].shape)
            kv.pushpull(n, [mnp.array(r[f"g{step}/{n}"]) for r in ranks],
                        out=out)
            states[n] = opt.update(n, ws[n], out, states[n])
    for n in names:
        ref = np.asarray(ws[n]._data)
        got = ranks[0][f"w/{n}"]
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max(), n
