"""The port's two fleet gates on the CPU, each once through its command
line: ``python -m mxnet_tpu_torch.obs --check --device cpu`` (a replica
and a decode worker as processes, the router, the fed fused trainer, the
recorder and watchdog: the fault fires and clears ``input_starved``, the
merged fleet report holds every role) and ``python -m
mxnet_tpu_torch.tracecheck --device cpu`` (one trace id across the
replica's and the router's processes, and across the worker's and the
trainer's; nesting; the batcher's links; the merged Chrome trace).
Marked ``dist``: subprocess fleets, bounded by conftest's alarm."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_TIMEOUT_S = 300


def _run(tmp_path, *argv):
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
    for k in ("MXNET_FEED_FAULT", "MXNET_SERVE_FAULT",
              "MXNET_OBS_INTERVAL_MS", "MXNET_OBS_DIR", "MXNET_TRACE_DIR"):
        env.pop(k, None)
    return subprocess.run([sys.executable, "-m", *argv], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=GATE_TIMEOUT_S)


@pytest.mark.dist
def test_obs_check_on_the_cpu(tmp_path):
    r = _run(tmp_path, "mxnet_tpu_torch.obs", "--check", "--device", "cpu")
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    lines = r.stdout.splitlines()
    assert lines[-1] == "[obs-check] OK"
    assert not [ln for ln in lines if ln.startswith("[obs-check] FAIL")]
    for gate in ("input_starved fires under feed fault",
                 "input_starved clears after fault removed",
                 "role serve merged", "role feed merged",
                 "role trainer merged", "signal mfu present"):
        assert any(ln.startswith("[obs-check] ok") and gate in ln
                   for ln in lines), gate


@pytest.mark.dist
def test_trace_check_on_the_cpu(tmp_path):
    r = _run(tmp_path, "mxnet_tpu_torch.tracecheck", "--device", "cpu")
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    lines = r.stdout.splitlines()
    assert lines[-1] == "[trace-check] OK"
    oks = [ln for ln in lines if ln.startswith("[trace-check] ok")]
    assert len(oks) == 10, lines
