"""KVStore server role (≙ ``mxnet_tpu/kvstore/kvstore_server.py``;
reference ``python/mxnet/kvstore/kvstore_server.py``, the process main
loop driving MXKVStoreRunServer → KVStoreDistServer,
``kvstore_dist_server.h:162``).

A ``DMLC_ROLE=server`` process runs a real parameter server
(``ps.ParameterServer``) owning its round-robin key slot: it prints
``MXNET_TPU_PS_SERVER <sid> <addr>`` for the launcher, serves until told
to stop (an ``OP_STOP`` frame, or SIGTERM from the launcher at the end of
the job: it then stops and exits normally, so ``atexit`` work such as a
telemetry dump runs), and never touches the card.

``KVStoreServer(kv).controller()`` is the reference's command handler
over a local store.  Its ``kSetOptimizer`` takes an optimizer object, the
parameter server's JSON optimizer config (``ps._opt_to_wire``) or a
registry name; unlike the reference it unpickles nothing.
"""
from __future__ import annotations

import os

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    """≙ kvstore_server.KVStoreServer — wraps a store, runs the command
    loop."""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.init_logging()

    def init_logging(self):
        import logging
        self.logger = logging.getLogger("mxnet_tpu_torch.kvstore.server")

    def controller(self):
        """Command handler ≙ server_controller (kvstore_server.py)."""
        def server_controller(cmd_id, cmd_body):
            if cmd_id == 0:                  # kSetOptimizer
                from .. import optimizer as opt_mod
                if isinstance(cmd_body, opt_mod.Optimizer):
                    optimizer = cmd_body
                else:
                    body = cmd_body.decode() if isinstance(
                        cmd_body, bytes) else str(cmd_body)
                    if body.lstrip().startswith("{"):
                        from .ps import _opt_from_wire
                        optimizer = _opt_from_wire(body)[0]
                    else:
                        optimizer = opt_mod.create(body)
                self.kvstore.set_optimizer(optimizer)
            elif cmd_id == 1:                # kStopServer
                self._stop = True
            elif cmd_id == 2:                # kSetProfilerParams
                # ≙ KVStoreServerProfilerCommand (kvstore.h:48): body is
                # "kSetConfig:<json>" | "kState:run|stop" | "kDump"
                from .. import profiler
                body = cmd_body.decode() if isinstance(cmd_body, bytes) \
                    else str(cmd_body)
                kind, _, arg = body.partition(":")
                if kind == "kSetConfig":
                    import json
                    profiler.set_config(**(json.loads(arg) if arg else {}))
                elif kind == "kState":
                    (profiler.start if arg == "run" else profiler.stop)()
                elif kind == "kDump":
                    profiler.dump()
        return server_controller

    def run(self):
        """Server main loop: a REAL parameter server owning this process's
        round-robin key slot (≙ KVStoreDistServer::Run,
        kvstore_dist_server.h:162).  The server id comes from
        DMLC_SERVER_ID (the launcher numbers server roles 0..S-1); the
        address is printed for launchers that assemble MXNET_TPU_PS_ADDRS
        (and published into this process's environment).  A telemetry
        dump of this process carries ``kvstore_server``: its address,
        ``stats``, whether CUDA was initialized here, and a sha256 of
        each key's weights."""
        import signal
        import threading

        from .. import telemetry as _telemetry
        from .ps import ParameterServer
        sid = int(os.environ.get("DMLC_SERVER_ID", "0"))
        srv = ParameterServer(
            host=os.environ.get("MXNET_TPU_PS_BIND", "0.0.0.0"),
            port=int(os.environ.get("MXNET_TPU_PS_PORT", "0")))
        addr = srv.start(seq=0, sid=sid)
        _telemetry.register_dump_extra(
            "kvstore_server", lambda: _server_report(srv, sid, addr))
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM, lambda *a: threading.Thread(
                target=srv.stop, daemon=True).start())
        self.logger.info("kvstore server %d serving at %s", sid, addr)
        print(f"MXNET_TPU_PS_SERVER {sid} {addr}", flush=True)
        srv.serve_forever()


def _server_report(srv, sid, addr) -> dict:
    import hashlib

    import torch
    with srv._lock:
        digests = {k: hashlib.sha256(v.tobytes()).hexdigest()
                   for k, v in srv._store.items()}
        stats = dict(srv.stats)
    return {"sid": sid, "addr": addr, "pid": os.getpid(), "stats": stats,
            "cuda_initialized": torch.cuda.is_initialized(),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "sha256": digests}


def _init_kvstore_server_module():
    """≙ kvstore_server._init_kvstore_server_module: when DMLC_ROLE=server,
    run the blocking server loop."""
    role = os.environ.get("DMLC_ROLE", "worker").lower()
    if role == "server":
        server = KVStoreServer(None)
        server.run()
        return True
    return False
