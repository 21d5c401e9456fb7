"""WorkersMerge — worker-side hierarchical gradient aggregation for the
dist parameter-server path (≙ ``mxnet_tpu/kvstore/workers_merge.py``).

≙ the fork's `KVStoreDist::WorkersMerge` (kvstore_dist.h:84-146): workers
co-located on one host elect a leader (rank-0-on-host); follower pushes
go to the leader's LOCAL merge endpoint instead of the remote server; the
leader sums them into a per-key merge buffer (`merged += recved`,
≙ kvstore_dist.h:139-142) and forwards ONE combined push tagged with
`num_merge` (≙ the fork's `Send2` + `KVMeta::num_merge`).  The server
applies the merged update once and replays `num_merge` responses
(kvstore_dist_server.h:956); the leader consumes the replay and releases
every waiting worker.  Server-bound push traffic drops by a factor of
workers-per-host.

Compressed member pushes (2-bit/1-bit packed payloads) are DECODED before
summing — the exact tensors the server itself would have decoded and
summed had each worker pushed independently (kvstore_dist_server.h:867),
so merged and unmerged training apply identical updates.  The combined
push is dense; packed codes only cross the loopback hop.

Merge-buffer accumulation and forwarding run on the native engine's
thread pool (``csrc_host/engine.cc`` ThreadPool, ≙ the fork's
MyThreadPool used by kvstore_dist_server.h:42) via ``engine.push`` with a
per-key WRITE var: rounds of the same key serialize, different keys
pipeline across pool threads.  The sums are numpy sums on host buffers.

Election rides the same rendezvous the PS addresses use (the job's
``TCPStore``, ``parallel.dist.store()``): every rank publishes its
hostname, co-located ranks group by it, the minimum rank on each host
leads and publishes its merge-endpoint address.

Liveness: a round that never fills (a worker skipped a stale gradient,
or died) is flushed PARTIALLY after MXNET_TPU_MERGE_TIMEOUT seconds with
num_merge = the count actually absorbed — async semantics degrade to a
bounded latency bubble, never a deadlock.
"""
from __future__ import annotations

import os
import socket
import socketserver
import threading
from typing import Dict, Optional

import numpy as _onp

from .. import telemetry as _telemetry
from .ps import (OP_PUSH, OP_STOP, RE_ERR, RE_OK, PSClient, _dec_key,
                 _dec_payload, _enc_text, _no_delay, _recv_frame,
                 _send_frame, decode_payload)

__all__ = ["MergeLeader", "MergedPSGroup", "setup_workers_merge",
           "merge_enabled", "merge_timeout_s"]

_HOST_KEY = "mxnet_tpu/wm_host"
_ADDR_KEY = "mxnet_tpu/wm_addr"


def merge_enabled(explicit: Optional[bool] = None) -> bool:
    """MXNET_KVSTORE_USE_WORKERS_MERGE gate, default ON (fork behavior);
    an explicit kwarg (Trainer / create()) wins over the environment."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get("MXNET_KVSTORE_USE_WORKERS_MERGE", "1") \
        .strip().lower() not in ("0", "false", "off")


def merge_timeout_s() -> float:
    """Seconds a merge round may wait for stragglers before the leader
    forwards it partially (num_merge = members actually absorbed)."""
    return float(os.environ.get("MXNET_TPU_MERGE_TIMEOUT", "5"))


class _Round:
    """One in-flight merge round for one key (≙ the fork's
    update_buf_[key]: merged accumulator + pending request metas)."""

    __slots__ = ("acc", "count", "waiters", "closed")

    def __init__(self):
        self.acc = None          # running sum, dense host tensor
        self.count = 0
        self.waiters = []        # (done_event, errbox) per absorbed push
        self.closed = False


class MergeLeader:
    """Rank-0-on-host merge endpoint.

    Accepts the SAME typed push frames the real server speaks (members
    connect with a plain PSClient), so the merge hop adds no second wire
    format.  ``group`` is the leader's own PSGroup — the forward hop
    reuses its key routing, seq prefixing and big-array slicing.
    """

    def __init__(self, group, group_size: int, host: str = "127.0.0.1",
                 port: int = 0, timeout_s: Optional[float] = None):
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        self._group = group
        self.group_size = group_size
        self._timeout = merge_timeout_s() if timeout_s is None \
            else float(timeout_s)
        self._rounds: Dict[str, _Round] = {}
        self._mu = threading.Lock()
        self._vars: Dict[str, object] = {}     # key → engine write var
        from .. import engine as _engine_mod
        self._engine = _engine_mod.engine()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                _no_delay(self.request)
                try:
                    while True:
                        op, body = _recv_frame(self.request)
                        if op is None:
                            return
                        if op == OP_STOP:
                            _send_frame(self.request, RE_OK)
                            return
                        if op != OP_PUSH:
                            _send_frame(self.request, RE_ERR, _enc_text(
                                f"merge endpoint only accepts pushes, "
                                f"got op {op}"))
                            continue
                        try:
                            key, off = _dec_key(body, 0)
                            payload, _ = _dec_payload(body, off)
                            g = decode_payload(payload)
                        except Exception as e:
                            _send_frame(self.request, RE_ERR, _enc_text(
                                f"{type(e).__name__}: {e}"))
                            continue
                        done, errbox = outer._submit(key, g)
                        if not done.wait(outer._timeout):
                            # round stalled (a peer skipped this key or
                            # died) — flush what arrived so far, then
                            # give the forward itself time to finish
                            outer._request_partial_flush(key)
                            done.wait(60.0)
                        if not done.is_set():
                            _send_frame(self.request, RE_ERR, _enc_text(
                                "WorkersMerge round stalled — merged "
                                "forward did not complete"))
                        elif errbox:
                            e = errbox[0]
                            _send_frame(self.request, RE_ERR, _enc_text(
                                f"{type(e).__name__}: {e}"))
                        else:
                            _send_frame(self.request, RE_OK)
                except OSError:
                    return      # disconnects are normal

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.addr = "%s:%d" % self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="mxtpu-wm-leader",
            daemon=True)

    # -- lifecycle --
    def start(self) -> str:
        self._thread.start()
        return self.addr

    def stop(self):
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass

    # -- merge machinery --
    def _var(self, key: str):
        with self._mu:
            v = self._vars.get(key)
            if v is None:
                v = self._vars[key] = self._engine.new_variable()
            return v

    def _submit(self, key: str, g: _onp.ndarray):
        """Queue one member push into the key's round on the engine pool
        (per-key write var → same-key rounds serialize, distinct keys
        pipeline).  Returns (done_event, errbox) for the handler."""
        done, errbox = threading.Event(), []
        self._engine.push(
            lambda: self._accumulate(key, g, done, errbox),
            mutable_vars=[self._var(key)])
        return done, errbox

    def _accumulate(self, key, g, done, errbox):
        with self._mu, _telemetry.timed("kvstore.merge_sum_us"):
            r = self._rounds.get(key)
            if r is None or r.closed:
                r = self._rounds[key] = _Round()
            # merged += recved (≙ kvstore_dist.h:139-142); first arrival
            # copies so the caller's buffer is never aliased
            r.acc = g.copy() if r.acc is None else r.acc + g
            r.count += 1
            r.waiters.append((done, errbox))
            full = r.count >= self.group_size
            if full:
                r.closed = True
                self._rounds.pop(key, None)
        if full:
            self._flush(key, r)

    def _request_partial_flush(self, key: str):
        """Flush whatever the key's open round absorbed (engine op on the
        same key var, so it orders after in-flight accumulates).  Benign
        race: if a fresh round opened meanwhile it gets flushed early —
        a smaller merge factor for one step, never lost data."""
        def _flush_open():
            with self._mu:
                r = self._rounds.pop(key, None)
                if r is None or r.closed or r.count == 0:
                    return
                r.closed = True
            _telemetry.counter_add("kvstore.merge_partial_flushes")
            self._flush(key, r)
        self._engine.push(_flush_open, mutable_vars=[self._var(key)])

    def _flush(self, key, r: _Round):
        """Forward ONE combined push, then release every absorbed
        waiter.  Runs on the engine pool; holding only this key's write
        var, so other keys keep merging while the server applies."""
        _telemetry.counter_add("kvstore.merge_rounds")
        _telemetry.observe("kvstore.merge_fanin", float(r.count))
        try:
            self._group.push_merged(key, r.acc, num_merge=r.count)
        except Exception as e:
            for done, errbox in r.waiters:
                errbox.append(e)
                done.set()
            return
        for done, _errbox in r.waiters:
            done.set()


class MergedPSGroup:
    """PSGroup facade whose pushes route through the host's MergeLeader.

    Everything except push (init / pull / set_optimizer / slicing state)
    delegates to the underlying PSGroup — pulls are read-only and go
    straight to the server, exactly like the fork (WorkersMerge touches
    only the push path).
    """

    def __init__(self, group, leader_addr: str,
                 leader: Optional[MergeLeader] = None,
                 timeout_s: float = 60.0):
        self._group = group
        self._leader = leader        # non-None on the leading rank
        self._merge_client = PSClient(addr=leader_addr,
                                      timeout_s=timeout_s)

    # -- delegated surface (DistKVStore touches these directly) --
    @property
    def n(self):
        return self._group.n

    @property
    def clients(self):
        return self._group.clients

    @property
    def _shapes(self):
        return self._group._shapes

    @property
    def _slice_big(self):
        return self._group._slice_big

    @_slice_big.setter
    def _slice_big(self, v):
        self._group._slice_big = v

    def _sid(self, key):
        return self._group._sid(key)

    def init(self, key, val):
        self._group.init(key, val)

    def pull(self, key):
        return self._group.pull(key)

    def set_optimizer(self, optimizer):
        self._group.set_optimizer(optimizer)

    def stop_servers(self):
        self._group.stop_servers()

    # -- the merged push path --
    def push(self, key, payload):
        """Send this worker's push to the co-located leader; returns when
        the leader's combined push was applied by the server (the reply
        the server replayed for this member).  Packed payloads are fine
        even for sliced keys — the leader decodes before forwarding, so
        the server-bound hop is dense and re-chunkable."""
        self._merge_client.push(str(key), payload)

    def close(self):
        try:
            self._merge_client.close()
        except Exception:
            pass
        if self._leader is not None:
            self._leader.stop()
        self._group.close()


# ------------------------------------------------------------- rendezvous
def _kv_set(key: str, val: str):
    from .ps import _store
    st = _store()
    if st is not None:
        try:
            st.set(key, val)
            return
        except Exception:
            pass
    os.environ["MXNET_TPU_WM_" + key.replace("/", "_")] = val


def _kv_get(key: str, timeout_s: float = 60.0) -> str:
    from .ps import _store, store_get
    st = _store()
    if st is not None:
        return store_get(st, key, timeout_s)
    env = os.environ.get("MXNET_TPU_WM_" + key.replace("/", "_"))
    if env is not None:
        return env
    raise RuntimeError(f"no rendezvous path for {key}")


def setup_workers_merge(group, seq: int = 0, rank: Optional[int] = None,
                        nproc: Optional[int] = None,
                        timeout_s: float = 60.0):
    """Elect the per-host merge leader and wrap ``group`` so pushes merge.

    Returns the original group unchanged when this rank's host has no
    co-located peer (merging one push is a pure latency tax).  Keys are
    seq-scoped like the PS address keys — every process creates its
    stores in the same program order, so `seq` lines up across the job.
    """
    from ..parallel import dist as _dist
    if rank is None:
        rank = _dist.rank()
    if nproc is None:
        nproc = _dist.size()
    if nproc <= 1:
        return group
    host = socket.gethostname()
    _kv_set(f"{_HOST_KEY}/{seq}/{rank}", host)
    try:
        hosts = {r: _kv_get(f"{_HOST_KEY}/{seq}/{r}", timeout_s)
                 for r in range(nproc)}
    except Exception as e:
        import warnings
        warnings.warn(
            f"WorkersMerge disabled: host rendezvous failed ({e}); "
            "workers push to the server independently")
        return group
    peers = sorted(r for r, h in hosts.items() if h == host)
    leader_rank, group_size = peers[0], len(peers)
    if group_size <= 1:
        return group
    leader = None
    if rank == leader_rank:
        leader = MergeLeader(group, group_size)
        _kv_set(f"{_ADDR_KEY}/{seq}/{leader_rank}", leader.start())
    addr = _kv_get(f"{_ADDR_KEY}/{seq}/{leader_rank}", timeout_s)
    return MergedPSGroup(group, addr, leader=leader, timeout_s=timeout_s)
