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


def test_obs_check_budget_fits_the_gate_limit():
    """The check's waits have caps that add up to its budget, and the
    budget leaves 30 s of the test's limit for the interpreter's start:
    a slow run fails at the gate whose wait ran out, with a named
    ``[obs-check] FAIL`` line, instead of dying by ``TimeoutExpired``."""
    from mxnet_tpu_torch.obs import check
    caps = (check.READY_S, check.STEADY_S, check.FIRE_S, check.CLEAR_S,
            check.SCRAPE_S, check.TEARDOWN_S)
    assert check.BUDGET_S == sum(caps)
    assert check.BUDGET_S + 30.0 <= GATE_TIMEOUT_S


def _fault_timeline(period_ms, fetch_ms, cycles, healthy_ms):
    """The check's fault as the trainer lives it: each cycle of
    ``fault + fetch`` ms delivers ``PREFETCH`` batches, stepped a period
    apart (the step and the check's 10 ms pace), then the trainer waits
    for the next cycle; after ``cycles`` cycles the fault is removed and
    the steps run back to back.  → (events, the fault's end): ``("step",
    start, end)`` and ``("wait", start, end)`` in ms."""
    from mxnet_tpu_torch.obs import check
    step, pace = period_ms - 10.0, 10.0
    cycle = check._fault_delay_ms(period_ms, fetch_ms) + fetch_ms
    ev, t = [], 0.0
    for c in range(cycles):
        for _ in range(check.PREFETCH):
            ev.append(("step", t, t + step))
            t += period_ms
        ev.append(("wait", t, (c + 1) * cycle))
        t = (c + 1) * cycle
    t_off = t
    while t < t_off + healthy_ms:
        ev.append(("step", t, t + step))
        t += period_ms
    return ev, t_off


def _watch(events, t_end_ms, accrue=True):
    """Replay ``events`` into a registry of their own, sampled by a
    recorder every ``INTERVAL_MS`` (the datafeed's open-wait gauge set
    while a wait is open), and run ``input_starved`` over the frames.
    ``accrue=False`` drops the open part (only completed waits count, the
    signal before its repair).  → (frames, [(event, t s)])."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.obs import check, rules, signals
    from mxnet_tpu_torch.obs.recorder import Recorder
    reg = telemetry._PyRegistry()
    rec = Recorder(interval_s=check.INTERVAL_MS / 1e3, ring=4096)
    rule = [r for r in rules.seeded_rules() if r.name == "input_starved"][0]
    done, frames, fired = 0, [], []
    ends = sorted((e[2], i) for i, e in enumerate(events))
    k = 1
    while k * check.INTERVAL_MS <= t_end_ms:
        now = k * check.INTERVAL_MS
        while done < len(ends) and ends[done][0] <= now:
            kind, t0, t1 = events[ends[done][1]]
            reg.observe("fused.step_us" if kind == "step"
                        else "datafeed.wait_us", (t1 - t0) * 1e3)
            done += 1
        open_ = [e for e in events if e[0] == "wait" and e[1] <= now < e[2]]
        reg.gauge_set(signals.WAIT_SINCE,
                      int(open_[0][1] * 1e3) if open_ else 0)
        frame = rec.derive(reg.snapshot(), now / 1e3)
        if not accrue:
            frame["signals"] = signals.compute(
                dict(frame, accrued_us={}))
        frames.append(frame)
        ev = rule.update(frame["mono"], rules.frame_view(frame))
        if ev:
            fired.append((ev["event"], ev["t"]))
        k += 1
    return frames, fired


@pytest.mark.parametrize("period_ms", [30.0, 45.0, 60.0, 121.0])
def test_input_starved_fires_at_the_recorder_window(period_ms):
    """The fleet gate's fault at the recorder's own 250 ms window: the
    ``PREFETCH`` fetches sleep the delay together, so batches come in
    bursts of steps (at a 121 ms period, the card's full-width step, a
    burst outlasts the window) and the trainer waits between them.  With
    the open part of a wait accrued, every window inside a wait reads a
    stall above the threshold, ``input_starved`` fires within the first
    wait and clears once the fault is gone.  Counting completed waits
    only (the signal before its repair), a window inside a wait reads no
    stall and restarts the rule's clock: it does not fire within the
    first cycle."""
    from mxnet_tpu_torch.obs import check
    fetch = 15.0
    cycle = check._fault_delay_ms(period_ms, fetch) + fetch
    events, t_off = _fault_timeline(period_ms, fetch, 3, 3000.0)
    t_end = t_off + 3000.0
    frames, fired = _watch(events, t_end)
    assert [e for e, _ in fired] == ["firing", "cleared"]
    assert fired[0][1] * 1e3 <= cycle
    assert t_off / 1e3 < fired[1][1] <= t_off / 1e3 + 2.0
    for f in frames:
        lo = f["mono"] * 1e3 - check.INTERVAL_MS
        if any(e[0] == "wait" and e[1] <= lo and f["mono"] * 1e3 <= e[2]
               for e in events):
            assert f["signals"]["input_stall_frac"] > 0.5
    _, fired_before = _watch(events, cycle, accrue=False)
    assert fired_before == []
