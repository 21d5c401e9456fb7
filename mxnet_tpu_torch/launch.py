"""Distributed job launcher, local layout (≙ the JAX package's
``tools/launch.py``; reference ``tools/launch.py`` over dmlc-core's
trackers, ``:72-116``).

    python -m mxnet_tpu_torch.launch -n 2 [-s 1 [--server-procs]] \\
        --launcher local python -m mxnet_tpu_torch.examples.bert_pretrain

starts ``-n`` worker processes on this machine with the ``DMLC_*``
contract (``DMLC_ROLE=worker``, ``DMLC_PS_ROOT_URI`` /
``DMLC_PS_ROOT_PORT``: a free local port where rank 0's ``TCPStore``
listens, ``DMLC_NUM_WORKER``, ``DMLC_NUM_SERVER``, ``DMLC_WORKER_ID``);
``parallel.dist.initialize()`` maps them onto ``torch.distributed``, so
scripts written for the reference's ``--launcher local`` work unchanged.
With ``-s S --server-procs`` it also starts S standalone
``DMLC_ROLE=server`` processes (``kvstore.kvstore_server``, no card
visible) on ports it picks, and hands the workers their addresses in
``MXNET_TPU_PS_ADDRS``: the reference's scheduler + server + worker
layout (the reference's launcher waits for each server's handshake
first; here servers and workers start together, a worker's client
waiting for its server to listen).  Without ``--server-procs`` the
first S worker ranks host their round-robin server slots
(``DMLC_NUM_SERVER`` is forwarded either way).  Each worker's
``MXNET_TRACE_LABEL`` is ``trainer-rank<r>``, and with
``MXNET_OBS_INTERVAL_MS`` set every member records into one
``MXNET_OBS_DIR``.  Unless ``OMP_NUM_THREADS`` is set, every process gets
the host's cores divided among the workers and servers (at least one):
torch's thread pools, each as wide as the host, slow every process many
times over when several share the cores.

The launcher waits for the workers; when one fails, or a server dies,
it stops the others (a peer left in a collective would wait forever),
then it stops the servers (SIGTERM: they exit cleanly) and returns the
first non-zero exit code.  The reference's ``--sim``, ``--restarts`` / ``--respawn``,
``--feed-workers`` and ``ssh`` layouts are not ported.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

__all__ = ["main", "launch_local"]


def _free_ports(n: int) -> list:
    """``n`` distinct ports free on this host (held together while they
    are read, so none is handed out twice)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _worker_env(args, rank, port, host="127.0.0.1"):
    env = dict(os.environ)
    env.update({
        "DMLC_ROLE": "worker",
        "DMLC_PS_ROOT_URI": host,
        "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NUM_WORKER": str(args.num_workers),
        "DMLC_NUM_SERVER": str(args.num_servers),
        "DMLC_WORKER_ID": str(rank),
    })
    env.setdefault("MXNET_TRACE_LABEL", f"trainer-rank{rank}")
    return env


def _start_server_procs(args, ports):
    """Standalone DMLC_ROLE=server processes on ``ports``, started
    together through the helper the worker-hosted layout uses
    (``kvstore.ps.spawn_server_procs``: one spawn for both layouts).  The
    workers start beside them (a worker's client waits for its server to
    listen), so the servers' start is off the job's path; a server that
    dies while workers run stops the job."""
    from .kvstore.ps import spawn_server_procs
    started = spawn_server_procs(range(args.num_servers), args.num_servers,
                                 ports=ports)
    for sid, (p, addr) in enumerate(started):
        sys.stderr.write(f"[launch] server {sid} pid {p.pid} at {addr}\n")
    return [p for p, _ in started], ",".join(a for _, a in started)


def _stop(procs, grace_s: float = 10.0):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


_obs_base = None


def _wire_obs(env):
    """Point a member's obs recorder at one shared shard directory, only
    when the launcher itself was asked to record
    (``MXNET_OBS_INTERVAL_MS``)."""
    global _obs_base
    if not os.environ.get("MXNET_OBS_INTERVAL_MS"):
        return env
    if _obs_base is None:
        base = os.environ.get("MXNET_OBS_DIR") or \
            tempfile.mkdtemp(prefix="mxtpu-obs-")
        os.makedirs(base, exist_ok=True)
        _obs_base = base
        sys.stderr.write(f"[launch] obs shards under {base}\n")
    env["MXNET_OBS_DIR"] = _obs_base
    return env


def launch_local(args, command) -> int:
    if "OMP_NUM_THREADS" not in os.environ:
        procs_on_host = args.num_workers + \
            (args.num_servers if args.server_procs else 0)
        os.environ["OMP_NUM_THREADS"] = str(
            max(1, (os.cpu_count() or 1) // max(1, procs_on_host)))
    n_srv = args.num_servers if args.server_procs else 0
    port, *srv_ports = _free_ports(1 + n_srv)
    servers, ps_addrs, procs = [], None, []
    try:
        if n_srv > 0:
            servers, ps_addrs = _start_server_procs(args, srv_ports)
        for rank in range(args.num_workers):
            env = _worker_env(args, rank, port)
            if ps_addrs:
                env["MXNET_TPU_PS_ADDRS"] = ps_addrs
            _wire_obs(env)
            procs.append(subprocess.Popen(command, env=env))
        code = 0
        live = list(procs)
        while live:
            dead = [s for s in servers if s.poll() is not None]
            if dead and code == 0:
                code = 1
                sys.stderr.write(f"[launch] server pid {dead[0].pid} exited "
                                 f"{dead[0].returncode}: stopping the job\n")
                _stop(live)
            for p in list(live):
                rc = p.poll()
                if rc is None:
                    continue
                live.remove(p)
                if rc != 0 and code == 0:
                    code = rc
                    sys.stderr.write(f"[launch] worker pid {p.pid} exited "
                                     f"{rc}: stopping the job\n")
                    _stop(live)
            time.sleep(0.05)
        return code
    finally:
        _stop(procs)
        _stop(servers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.launch",
        description="Launch a distributed mxnet_tpu_torch job on this "
                    "machine")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="parameter-server count for dist_async "
                         "(DMLC_NUM_SERVER; keys round-robin across them)")
    ap.add_argument("--server-procs", action="store_true",
                    help="start standalone DMLC_ROLE=server processes "
                         "(default: the first s worker ranks host the "
                         "slots)")
    ap.add_argument("--launcher", choices=["local"], default="local")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    # only the separator before the command: the command's own "--"
    # stays in its argv
    command = args.command[1:] if args.command[:1] == ["--"] \
        else args.command
    if not command:
        ap.error("no command given")
    return launch_local(args, command)


if __name__ == "__main__":
    sys.exit(main())
