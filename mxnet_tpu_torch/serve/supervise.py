"""Per-worker supervision of a serving fleet (≙
``supervise_respawn`` of ``tools/launch.py``, the port's own copy): the
chaos harness (serve/chaos.py) runs its replicas under it."""
from __future__ import annotations

import subprocess
import sys
import time

__all__ = ["supervise_respawn"]


def supervise_respawn(spawn, n, restarts=0, stop=None, poll_s=0.05,
                      on_respawn=None, procs_out=None):
    """Per-worker supervision for SERVING fleets — the complement of
    launch_sim's gang restart.  Training workers share coordination
    state, so one death must restart the whole gang; serving replicas
    are independent, so only the dead member is relaunched while its
    peers keep taking traffic (the chaos harness's SIGKILL+relaunch leg
    rides on this).

    ``spawn(rank, attempt)`` returns a Popen for that worker.  A worker
    exiting 0 is done (not respawned); a nonzero exit consumes one unit
    of the shared ``restarts`` budget and respawns that worker only.
    ``stop`` (threading.Event) ends supervision early: everything is
    terminated and 0 is returned.  ``procs_out`` (list) mirrors the
    live Popen per rank so a caller can inspect — or deliberately
    SIGKILL — fleet members.  Returns 0 when all workers exited 0 (or
    stop was set), 1 when the respawn budget is exhausted."""
    procs = [spawn(rank, 0) for rank in range(n)]
    if procs_out is not None:
        procs_out[:] = procs
    attempts = [0] * n
    used = 0
    try:
        while True:
            if stop is not None and stop.is_set():
                return 0
            alive = False
            for rank, p in enumerate(procs):
                if p is None:
                    continue
                rc = p.poll()
                if rc is None:
                    alive = True
                    continue
                if rc == 0:
                    procs[rank] = None
                    if procs_out is not None:
                        procs_out[rank] = None
                    continue
                if used >= restarts:
                    sys.stderr.write(
                        f"[launch respawn] worker {rank} exited {rc}; "
                        f"respawn budget ({restarts}) exhausted\n")
                    return 1
                used += 1
                attempts[rank] += 1
                sys.stderr.write(
                    f"[launch respawn] worker {rank} exited {rc}; "
                    f"respawning (attempt {attempts[rank]}, "
                    f"{restarts - used} left)\n")
                if on_respawn is not None:
                    on_respawn(rank, attempts[rank], rc)
                procs[rank] = spawn(rank, attempts[rank])
                if procs_out is not None:
                    procs_out[rank] = procs[rank]
                alive = True
            if not alive:
                return 0
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p is not None and p.poll() is None:
                p.terminate()
        deadline = time.time() + 10
        for p in procs:
            if p is None:
                continue
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
