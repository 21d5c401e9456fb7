"""TCP parameter server: the dist_async data path (≙
``mxnet_tpu/kvstore/ps.py``; reference ``KVStoreDistServer``,
``src/kvstore/kvstore_dist_server.h``).

In async mode the server applies each worker's push the moment it arrives
(no aggregation barrier, ``kvstore_dist_server.h:882``), and pulls return
whatever the weights are at that instant, so fast workers never wait for
slow ones.  A job runs DMLC_NUM_SERVER servers; keys are round-robined
across them (key % S, ≙ ``kvstore_dist.h:729`` EncodeDefaultKey) and big
tensors are sliced over ALL servers (MXNET_KVSTORE_BIGARRAY_BOUND).
Servers either run standalone (DMLC_ROLE=server processes,
``kvstore_server.py``) or are spawned by the first S worker ranks when the
launch layout starts no server role.  A server is a host process: it
holds numpy arrays, applies the port's optimizer to CPU tensors over
them, and is spawned with no card visible (``spawn_server_proc``).

Wire format: the JAX package's TYPED length-prefixed binary frames, byte
for byte (a port client and a JAX-package server, or the reverse, talk):
dtype/shape-tagged tensor buffers, packed-gradient payloads (2-bit codes
at 4/byte, 1-bit signs at 8/byte ≙ ``gradient_compression.h:115-122``),
the optional ``num_merge`` trailer of a WorkersMerge push, and a
restricted JSON optimizer config.  NO pickle crosses the socket in either
direction.

Rendezvous: each server publishes host:port through the job's store
(``parallel.dist.store()``, rank 0's ``TCPStore``, in place of the JAX
coordination service); MXNET_TPU_PS_ADDRS (comma list, indexed by server
id) or MXNET_TPU_PS_ADDR override it for launcher layouts.
"""
from __future__ import annotations

import json
import os
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as _onp

from .. import telemetry as _telemetry

__all__ = ["ParameterServer", "PSClient", "PSGroup", "pack_2bit",
           "unpack_2bit", "pack_1bit", "unpack_1bit", "publish_address",
           "lookup_address", "num_servers", "bigarray_bound",
           "decode_payload", "spawn_server_proc", "spawn_server_procs"]

_ADDR_KEY = "mxnet_tpu/ps_addr"


def num_servers() -> int:
    """Server count for the job ≙ DMLC_NUM_SERVER (tracker contract)."""
    return max(1, int(os.environ.get("DMLC_NUM_SERVER", "1") or 1))


def bigarray_bound() -> int:
    """Tensors with >= this many elements are sliced across ALL servers
    (≙ MXNET_KVSTORE_BIGARRAY_BOUND, default 1e6, kvstore_dist.h:87)."""
    return int(os.environ.get("MXNET_KVSTORE_BIGARRAY_BOUND", "1000000"))


# ---------------------------------------------------------------- packing
def pack_2bit(q: _onp.ndarray, threshold: float):
    """Pack a {-t, 0, +t} quantized gradient into 2-bit codes, 4 per byte
    (code 0 → 0, 1 → +t, 2 → −t) ≙ gradient_compression.h:115."""
    flat = q.ravel()
    codes = _onp.zeros(flat.shape, _onp.uint8)
    codes[flat > 0] = 1
    codes[flat < 0] = 2
    pad = (-len(codes)) % 4
    if pad:
        codes = _onp.concatenate([codes, _onp.zeros(pad, _onp.uint8)])
    c = codes.reshape(-1, 4)
    packed = (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6))
    return packed.astype(_onp.uint8), q.shape, float(threshold)


def unpack_2bit(packed: _onp.ndarray, shape, threshold: float):
    c = _onp.empty((len(packed), 4), _onp.uint8)
    c[:, 0] = packed & 3
    c[:, 1] = (packed >> 2) & 3
    c[:, 2] = (packed >> 4) & 3
    c[:, 3] = (packed >> 6) & 3
    codes = c.ravel()[: int(_onp.prod(shape))]
    out = _onp.zeros(codes.shape, _onp.float32)
    out[codes == 1] = threshold
    out[codes == 2] = -threshold
    return out.reshape(shape)


def pack_1bit(q: _onp.ndarray, threshold: float):
    """Sign-bit packing, 8 per byte (set bit → +t, clear → −t)."""
    bits = (q.ravel() >= 0)
    return _onp.packbits(bits), q.shape, float(threshold)


def unpack_1bit(packed: _onp.ndarray, shape, threshold: float):
    n = int(_onp.prod(shape))
    bits = _onp.unpackbits(packed)[:n]
    return _onp.where(bits, threshold, -threshold) \
        .astype(_onp.float32).reshape(shape)


# ------------------------------------------------------------- rendezvous
def _store():
    """The job's key-value store (``parallel.dist.store()``), or None."""
    from ..parallel import dist as _dist
    return _dist.store()


def store_get(st, key: str, timeout_s: float) -> str:
    """``key``'s value in ``st``, waiting up to ``timeout_s`` for some
    process to set it (≙ the coordination service's
    ``blocking_key_value_get``)."""
    import datetime
    st.wait([key], datetime.timedelta(seconds=timeout_s))
    return st.get(key).decode()


def publish_address(addr: str, seq: int = 0, sid: int = 0):
    """Publish under a per-instance/per-server key: a ``TCPStore.set``
    overwrites, so each store instance and server slot has its own key;
    every process creates its dist_async stores in the same program
    order, so `seq` lines up across the job; `sid` is the server's
    round-robin slot."""
    st = _store()
    if st is not None:
        try:
            st.set(f"{_ADDR_KEY}/{seq}/{sid}", addr)
            return
        except Exception:
            pass
    os.environ[f"MXNET_TPU_PS_ADDR_{seq}_{sid}"] = addr


def lookup_address(timeout_s: float = 60.0, seq: int = 0,
                   sid: int = 0) -> str:
    """Server ``sid``'s address for store instance ``seq``: the launcher's
    MXNET_TPU_PS_ADDRS, else the job's store (multi-process), else this
    process's MXNET_TPU_PS_ADDR_<seq>_<sid> (or MXNET_TPU_PS_ADDR)."""
    addrs = os.environ.get("MXNET_TPU_PS_ADDRS")
    if addrs:                       # launcher-provided comma list, by sid
        parts = [a.strip() for a in addrs.split(",") if a.strip()]
        if sid >= len(parts):
            raise RuntimeError(
                f"MXNET_TPU_PS_ADDRS has {len(parts)} entries but server "
                f"id {sid} was requested (DMLC_NUM_SERVER mismatch) — "
                "refusing to wrap onto the wrong server")
        return parts[sid]
    # a job's store is its own truth: an MXNET_TPU_PS_ADDR_* a worker
    # inherited from its parent's process may name a server long gone
    st = _store()
    if st is not None:
        return store_get(st, f"{_ADDR_KEY}/{seq}/{sid}", timeout_s)
    env = os.environ.get(f"MXNET_TPU_PS_ADDR_{seq}_{sid}") or \
        (os.environ.get("MXNET_TPU_PS_ADDR") if sid == 0 else None)
    if env:
        return env
    raise RuntimeError(
        "no parameter-server address: set MXNET_TPU_PS_ADDRS or run under "
        "torch.distributed (parallel/dist.py)")


# ------------------------------------------------------------------ wire
# Typed frames (≙ ps-lite's KVPairs: lens/keys/vals buffers, never code):
#   frame   := <I body_len> <B op> body
#   key     := <H len> utf8
#   tensor  := <B dtype_code> <B ndim> ndim*<I dim> raw C-order bytes
#   payload := <B 0> tensor                                      raw
#            | <B 1|2> <f thr> <B ndim> ndim*<I dim> <I n> bytes 2bit|1bit
#   text    := <I len> utf8                                      json/err
#   merge   := <B 'M'> <B ver=1> <I num_merge>    optional push trailer
#
# The merge trailer (≙ the fork's KVMeta::num_merge carried by Send2,
# kvstore_dist.h:90-94) rides AFTER the payload of OP_PUSH/OP_PUSHPULL.
# Backward compat both ways: a legacy client sends no trailer (the body
# ends at the payload → num_merge=1), and a new client with num_merge=1
# omits it, so either side may be old.  The server applies a merged push
# ONCE and replays num_merge response frames on the same connection
# (≙ kvstore_dist_server.h:956's request-replay loop), so the merging
# leader can unblock every co-located worker's pending push.

OP_INIT, OP_PUSH, OP_PULL, OP_PUSHPULL = 1, 2, 3, 4
OP_SET_OPT, OP_STOP = 5, 6
RE_OK, RE_VAL, RE_ERR = 0, 1, 255

_MERGE_MAGIC = 0x4D          # 'M'
_MERGE_VERSION = 1


def _enc_num_merge(n: int) -> bytes:
    """Versioned num_merge trailer; callers omit it for n == 1."""
    return struct.pack("<BBI", _MERGE_MAGIC, _MERGE_VERSION, n)


def _dec_num_merge(buf, off) -> int:
    """Trailing num_merge field; absent (legacy frame) → 1."""
    if off >= len(buf):
        return 1
    magic, ver = struct.unpack_from("<BB", buf, off)
    if magic != _MERGE_MAGIC or ver != _MERGE_VERSION:
        raise ValueError(
            f"bad push trailer (magic={magic:#x}, version={ver}) — "
            "client/server wire-protocol mismatch")
    (n,) = struct.unpack_from("<I", buf, off + 2)
    return max(1, n)

_DTYPES = ["float32", "float64", "float16", "int8", "int16", "int32",
           "int64", "uint8", "uint16", "uint32", "uint64", "bool",
           "bfloat16"]
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}


def _np_dtype(code):
    name = _DTYPES[code]
    if name == "bfloat16":
        import ml_dtypes
        return _onp.dtype(ml_dtypes.bfloat16)
    return _onp.dtype(name)


def _enc_key(key: str) -> bytes:
    b = str(key).encode()
    return struct.pack("<H", len(b)) + b


def _dec_key(buf, off):
    (n,) = struct.unpack_from("<H", buf, off)
    off += 2
    return buf[off:off + n].decode(), off + n


def _tensor_parts(a: _onp.ndarray) -> list:
    """A tensor's encoding as [header, the array's bytes (a view)]; the
    encoders join the parts of a whole frame body with one copy."""
    a = _onp.ascontiguousarray(a)
    code = _DTYPE_CODE[str(a.dtype)]
    hdr = struct.pack("<BB", code, a.ndim) + \
        struct.pack(f"<{a.ndim}I", *a.shape)
    return [hdr, memoryview(a.reshape(-1).view(_onp.uint8))]


def _enc_tensor(a: _onp.ndarray) -> bytes:
    return b"".join(_tensor_parts(a))


def _dec_tensor(buf, off):
    code, nd = struct.unpack_from("<BB", buf, off)
    off += 2
    shape = struct.unpack_from(f"<{nd}I", buf, off)
    off += 4 * nd
    dt = _np_dtype(code)
    n = int(_onp.prod(shape)) if nd else 1
    nbytes = n * dt.itemsize
    a = _onp.frombuffer(buf, dt, count=n, offset=off).reshape(shape).copy()
    return a, off + nbytes


def _payload_parts(payload) -> list:
    kind = payload[0]
    if kind == "raw":
        return [b"\x00"] + _tensor_parts(payload[1])
    code = b"\x01" if kind == "2bit" else b"\x02"
    packed, shape, thr = payload[1], payload[2], payload[3]
    packed = _onp.ascontiguousarray(packed, _onp.uint8).reshape(-1)
    return [code + struct.pack("<fB", thr, len(shape))
            + struct.pack(f"<{len(shape)}I", *shape)
            + struct.pack("<I", packed.size), memoryview(packed)]


def _enc_payload(payload) -> bytes:
    return b"".join(_payload_parts(payload))


def _dec_payload(buf, off):
    kind = buf[off]
    off += 1
    if kind == 0:
        a, off = _dec_tensor(buf, off)
        return ("raw", a), off
    thr, nd = struct.unpack_from("<fB", buf, off)
    off += 5
    shape = struct.unpack_from(f"<{nd}I", buf, off)
    off += 4 * nd
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    packed = _onp.frombuffer(buf, _onp.uint8, count=n, offset=off).copy()
    return (("2bit" if kind == 1 else "1bit"), packed, shape, thr), off + n


def decode_payload(payload) -> _onp.ndarray:
    """Payload → dense host tensor (server-side decode semantics,
    ≙ kvstore_dist_server.h:867 decompress-before-apply).  Shared by the
    server's apply path and the WorkersMerge leader's merge buffer."""
    kind = payload[0]
    if kind == "raw":
        return _onp.asarray(payload[1])
    if kind == "2bit":
        return unpack_2bit(*payload[1:])
    if kind == "1bit":
        return unpack_1bit(*payload[1:])
    raise ValueError(f"bad payload kind {kind}")


def _enc_text(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _dec_text(buf, off):
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n].decode(), off + n


def _send_frame(sock, op: int, body: bytes = b"", times: int = 1):
    """Send the frame ``(op, body)`` ``times`` times: a small one in one
    write, a big body without copying it behind its header."""
    hdr = struct.pack("<IB", len(body), op)
    if len(body) < 65536:
        sock.sendall((hdr + body) * times)
        return
    for _ in range(times):
        sock.sendall(hdr)
        sock.sendall(body)


def _no_delay(sock):
    """Send small frames at once (no Nagle batching): every exchange on
    these sockets is a request waiting for its reply."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


def _recv_frame(sock):
    hdr = _recv_exact(sock, 5)
    if hdr is None:
        return None, None
    n, op = struct.unpack("<IB", hdr)
    body = _recv_exact(sock, n) if n else b""
    if n and body is None:
        return None, None
    return op, body


def _recv_exact(sock, n):
    """``n`` bytes from ``sock`` into one buffer (None if the peer
    closed first); a big frame arrives in many chunks, each received in
    place."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return buf


# ------------------------------------------ optimizer over the wire (no pickle)
def _opt_to_wire(opt, key_prefix: str = "") -> str:
    """Restricted JSON config: registry name + scalar attributes + per-key
    step counts.  lr_schedulers and device state stay worker-side (the
    worker re-sends the config whenever its effective lr changes —
    Trainer.set_learning_rate).  `key_prefix` maps worker-side step-count
    keys onto the store's wire-key namespace (PSGroup seq prefix).  The
    port's optimizers keep the reference's attribute names, so either
    package's server reads either's config."""
    attrs = {k: v for k, v in vars(opt).items()
             if isinstance(v, (int, float, bool, str)) or v is None}
    attrs.pop("_jit_multi", None)
    counts = getattr(opt, "_index_update_count", {}) or {}
    return json.dumps({
        "name": type(opt).__name__.lower(),
        "attrs": attrs,
        "counts": [[key_prefix + str(k), int(v)] for k, v in counts.items()],
        "num_update": int(getattr(opt, "num_update", 0)),
        # the optimizer applies ONLY to this namespace's keys — a second
        # store sharing standalone servers keeps its own update semantics
        "prefix": key_prefix,
    })


def _opt_from_wire(blob: str):
    """→ (optimizer, namespace_prefix)."""
    from .. import optimizer as opt_mod
    cfg = json.loads(blob)
    opt = opt_mod.create(cfg["name"])
    for k, v in cfg["attrs"].items():
        setattr(opt, k, v)
    opt._index_update_count = {k: v for k, v in cfg["counts"]}
    opt.num_update = cfg["num_update"]
    return opt, cfg.get("prefix", "")


# ---------------------------------------------------------------- server
class ParameterServer:
    """Canonical-weight owner. apply-on-push, serve-on-pull.

    With an optimizer set (update_on_kvstore, kvstore_dist_server.h:496
    ApplyUpdates) each push runs one optimizer step on the server copy;
    otherwise pushes accumulate (+=), matching KVStore.push semantics.
    """

    def __init__(self, host="127.0.0.1", port=0):
        self._store: Dict[str, _onp.ndarray] = {}
        # observability for the WorkersMerge path: push frames/bytes the
        # server actually received, merged pushes, and replayed replies.
        # Read by the merge tests and bench.py --row ps_merge; mutated
        # only under self._lock.
        self.stats = {"push_frames": 0, "push_bytes": 0,
                      "merged_pushes": 0, "replayed_replies": 0}
        # optimizers are scoped by wire-key namespace ("<seq>/" prefix, ""
        # for unprefixed keys) so stores sharing standalone servers can't
        # impose their update rule on each other's keys
        self._opts: Dict[str, object] = {}
        self._opt_states: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._conns = set()      # live client sockets, closed on stop()
        self._stopping = False
        # optimizer steps run on ONE dedicated thread, never on RPC handler
        # threads (≙ kvstore_dist_server.h:999: the updater owns a
        # single-thread Executor exec_; handlers block on CExecute), and a
        # wedged step shows up as a watchdog RE_ERR frame instead of a
        # silent client hang.
        self._updates = None      # queue.Queue, created with the thread
        self._upd_thread = None
        self._upd_lock = threading.Lock()   # guards updater creation
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                with outer._lock:
                    if outer._stopping:      # TOCTOU: accepted before
                        return               # stop() swept the registry
                    outer._conns.add(self.request)
                _no_delay(self.request)
                try:
                    while True:
                        op, body = _recv_frame(self.request)
                        if op is None:
                            return
                        rop, rbody, nrep = outer._dispatch(op, body)
                        # reply replay (≙ kvstore_dist_server.h:956): a
                        # merged push gets num_merge identical responses
                        # so the leader can release every worker whose
                        # push it absorbed; errors always reply once.  The
                        # replies leave in one send: small frames sent one
                        # by one stall ~40 ms each behind the peer's
                        # delayed ACK
                        _send_frame(self.request, rop, rbody, nrep)
                        if op == OP_STOP:
                            # reply already on the wire; deregister BEFORE
                            # triggering stop so the close sweep cannot
                            # race our own (just-used) socket
                            with outer._lock:
                                outer._conns.discard(self.request)
                            threading.Thread(target=outer.stop,
                                             daemon=True).start()
                            return
                except OSError:
                    # disconnects (incl. stop()'s sweep) are normal —
                    # never traceback-spam from a handler thread
                    return
                finally:
                    with outer._lock:
                        outer._conns.discard(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.addr = "%s:%d" % self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="mxtpu-ps", daemon=True)

    # -- lifecycle --
    def start(self, publish=True, seq=0, sid=0):
        self._thread.start()
        if publish:
            publish_address(self.addr, seq, sid)
        return self.addr

    def stop(self):
        with self._lock:
            self._stopping = True
        if self._updates is not None:
            self._updates.put(None)          # updater-thread shutdown
        self._server.shutdown()
        self._server.server_close()
        # sever live connections too: workers must observe server death as
        # a connection error, not serve forever off a zombie thread
        # (failure-detection contract, SURVEY §5.3)
        with self._lock:
            conns, self._conns = set(self._conns), set()
        for s in conns:
            try:
                s.shutdown(2)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def serve_forever(self):
        """Blocking variant for standalone DMLC_ROLE=server processes."""
        self._thread.join()

    # -- request dispatch --
    def _dispatch(self, op, body):
        """→ (reply_op, reply_body, n_replies).  n_replies > 1 only for a
        merged push (num_merge trailer): the update is applied ONCE, the
        reply is replayed num_merge times (≙ the fork's server pushing
        req_meta back num_merge times, kvstore_dist_server.h:956)."""
        try:
            if op == OP_INIT:
                key, off = _dec_key(body, 0)
                val, _ = _dec_tensor(body, off)
                with self._lock:
                    self._store.setdefault(key, val)
                return RE_OK, b"", 1
            if op == OP_PUSH:
                key, off = _dec_key(body, 0)
                payload, off = _dec_payload(body, off)
                nm = _dec_num_merge(body, off)
                self._count_push(len(body), nm)
                self._apply(key, self._decode(payload))
                return RE_OK, b"", nm
            if op == OP_PULL:
                key, _ = _dec_key(body, 0)
                with self._lock:
                    return RE_VAL, _enc_tensor(self._store[key]), 1
            if op == OP_PUSHPULL:
                key, off = _dec_key(body, 0)
                payload, off = _dec_payload(body, off)
                nm = _dec_num_merge(body, off)
                self._count_push(len(body), nm)
                self._apply(key, self._decode(payload))
                with self._lock:
                    return RE_VAL, _enc_tensor(self._store[key]), nm
            if op == OP_SET_OPT:
                blob, _ = _dec_text(body, 0)
                new, prefix = _opt_from_wire(blob)
                with self._lock:
                    old = self._opts.get(prefix)
                    if old is not None:
                        # keep per-key step counts across re-sends
                        new._index_update_count = old._index_update_count
                        new.num_update = old.num_update
                # pre-warm on the updater thread: the rule's first run lands
                # here, not under the first worker push.  Install only
                # AFTER the warm succeeds — a client that got RE_ERR must
                # not leave a half-set optimizer behind.
                self._exec_update(lambda a: self._warm_optimizer(new, a))
                with self._lock:
                    self._opts[prefix] = new
                return RE_OK, b"", 1
            if op == OP_STOP:
                # the HANDLER triggers stop() after the reply is sent
                # (ordering: client sees RE_OK before the close sweep)
                return RE_OK, b"", 1
            return RE_ERR, _enc_text(f"unknown op {op}"), 1
        except Exception as e:       # surface worker-side
            return RE_ERR, _enc_text(f"{type(e).__name__}: {e}"), 1

    def _count_push(self, nbytes, num_merge):
        with self._lock:
            self.stats["push_frames"] += 1
            self.stats["push_bytes"] += nbytes + 5     # body + frame hdr
            if num_merge > 1:
                self.stats["merged_pushes"] += 1
                self.stats["replayed_replies"] += num_merge
        # registry copies (server process scope — they surface in THAT
        # process's snapshot/dump, e.g. SIGUSR2 against a stuck server)
        _telemetry.counter_add("kvstore.server_push_frames")
        _telemetry.counter_add("kvstore.server_push_bytes", nbytes + 5)
        if num_merge > 1:
            _telemetry.counter_add("kvstore.server_merged_pushes")

    _decode = staticmethod(decode_payload)

    # -- update execution ---------------------------------------------------
    # One dedicated thread serializes every optimizer step; RPC handlers
    # block until their update is applied (apply-on-push semantics intact)
    # but never run the rule themselves and never hold the store lock
    # across it.  Accumulate (+=) pushes stay inline — cheap numpy.

    def _ensure_updater(self):
        with self._upd_lock:      # two first-callers must not spawn twice
            if self._upd_thread is None or not self._upd_thread.is_alive():
                import queue
                self._updates = queue.Queue()
                self._upd_thread = threading.Thread(
                    target=self._update_loop, name="mxtpu-ps-updater",
                    daemon=True)
                self._upd_thread.start()

    def _update_loop(self):
        while True:
            item = self._updates.get()
            if item is None:
                return
            fn, done, errbox, abandoned = item
            if abandoned.is_set():
                # the waiter already timed out and told its client RE_ERR;
                # applying now would double-apply a retried gradient
                done.set()
                continue
            try:
                fn(abandoned)
            except BaseException as e:   # surfaced by _exec_update
                errbox.append(e)
            finally:
                done.set()

    def _exec_update(self, fn):
        """Run fn on the updater thread; block with a watchdog.  A wedged
        apply (e.g. an accelerator backend init hanging — servers must run
        CPU) becomes a RuntimeError → RE_ERR frame, never a client hang."""
        self._ensure_updater()
        done, errbox = threading.Event(), []
        abandoned = threading.Event()
        self._updates.put((fn, done, errbox, abandoned))
        # default stays BELOW PSClient's 60s socket timeout: the RE_ERR
        # diagnostic must reach the client before its socket gives up
        # (a late reply would also desync the reply stream)
        timeout = float(os.environ.get("MXNET_TPU_PS_UPDATE_TIMEOUT", "50"))
        if not done.wait(timeout):
            abandoned.set()       # still queued → will be skipped, not run
            raise RuntimeError(
                f"parameter-server updater wedged (> {timeout:.0f}s) — the "
                "server-side optimizer step did not complete "
                "(MXNET_TPU_PS_UPDATE_TIMEOUT overrides the watchdog)")
        if errbox:
            raise errbox[0]

    @staticmethod
    def _warm_optimizer(opt, _abandoned=None):
        """The rule's first run on the updater thread, out of band."""
        import torch
        w = torch.zeros(1)
        st = opt.create_state("__warm__", w)
        saved = opt.num_update
        opt.update("__warm__", w, torch.zeros(1), st)
        # the warm key must not leak into real step accounting
        opt._index_update_count.pop("__warm__", None)
        opt.num_update = saved

    def _opt_for(self, key):
        """Namespace-scoped optimizer lookup ("<seq>/key" → "<seq>/").

        Falls back to the root-namespace ("") optimizer so a direct
        PSClient whose parameter names happen to contain "/" keeps the
        pre-namespacing behavior (one optimizer for the whole server)
        instead of silently degrading to accumulate."""
        i = key.find("/")
        if i >= 0:
            opt = self._opts.get(key[:i + 1])
            if opt is not None:
                return opt
        return self._opts.get("")

    def _apply(self, key, g):
        with _telemetry.timed("kvstore.server_apply_us"):
            with self._lock:
                opt = self._opt_for(key)
                if opt is None:
                    w = self._store.get(key)
                    self._store[key] = g.copy() if w is None else w + g
                    return
            self._exec_update(
                lambda abandoned: self._opt_step(key, opt, g, abandoned))

    def _opt_step(self, key, opt, g, abandoned=None):
        """Body of one server-side optimizer step (updater thread only):
        the port's rule on CPU tensors over copies of the weight and its
        states, committed together unless the step was abandoned."""
        import torch
        with self._lock:
            w = self._store.get(key)
            if w is None:
                self._store[key] = g.copy()
                return
        wt = torch.from_numpy(w.copy())
        st = self._opt_states.get(key)
        st = opt.create_state(key, wt) if st is None else \
            {k: v.clone() for k, v in st.items()}
        opt.update(key, wt, torch.from_numpy(_onp.ascontiguousarray(g)), st)
        # a step that wedged mid-update and recovered AFTER its client was
        # told RE_ERR must not commit — the worker may have re-sent it
        if abandoned is not None and abandoned.is_set():
            return
        self._opt_states[key] = st
        with self._lock:
            self._store[key] = wt.numpy()


# ---------------------------------------------------------------- client
class PSClient:
    """One persistent connection to ONE server (≙ ps-lite customer)."""

    def __init__(self, addr: Optional[str] = None, timeout_s: float = 60.0,
                 seq: int = 0, sid: int = 0):
        if addr is None:
            addr = lookup_address(timeout_s, seq, sid)
        host, _, port = addr.rpartition(":")
        # a server the launcher started beside the workers may not listen
        # yet: a refused connection is tried again until the timeout
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                self._sock = socket.create_connection((host, int(port)),
                                                      timeout=timeout_s)
                break
            except ConnectionRefusedError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        _no_delay(self._sock)
        self._lock = threading.Lock()

    def _rpc(self, op, body=b""):
        with self._lock:
            _send_frame(self._sock, op, body)
            rop, rbody = _recv_frame(self._sock)
        if rop is None:
            raise ConnectionError("parameter server closed the connection")
        if rop == RE_ERR:
            raise RuntimeError(
                f"parameter server error: {_dec_text(rbody, 0)[0]}")
        return rop, rbody

    def init(self, key, val: _onp.ndarray):
        self._rpc(OP_INIT, b"".join([_enc_key(key)] +
                                    _tensor_parts(_onp.asarray(val))))

    def push(self, key, payload, num_merge: int = 1):
        """Push one payload.  num_merge > 1 marks it as a WorkersMerge
        combined push: the frame carries the num_merge trailer and the
        server replays that many responses, ALL consumed here (the caller
        — the merge leader — then releases its local waiters).  num_merge
        == 1 sends a legacy frame, so old servers stay compatible."""
        parts = [_enc_key(key)] + _payload_parts(payload)
        if num_merge <= 1:
            self._rpc(OP_PUSH, b"".join(parts))
            return
        body = b"".join(parts + [_enc_num_merge(num_merge)])
        with self._lock:
            _send_frame(self._sock, OP_PUSH, body)
            rop, rbody = _recv_frame(self._sock)
            if rop == RE_OK:
                # drain the replayed responses atomically — a reply left
                # unread would desync the next RPC on this socket.  An
                # error replies exactly ONCE (dispatch contract), so
                # there is nothing further to drain on that path.
                for _ in range(num_merge - 1):
                    rop2, _b = _recv_frame(self._sock)
                    if rop2 is None:
                        rop = None
                        break
        if rop is None:
            raise ConnectionError("parameter server closed the connection")
        if rop == RE_ERR:
            raise RuntimeError(
                f"parameter server error: {_dec_text(rbody, 0)[0]}")

    def pull(self, key) -> _onp.ndarray:
        _, body = self._rpc(OP_PULL, _enc_key(key))
        return _dec_tensor(body, 0)[0]

    def pushpull(self, key, payload) -> _onp.ndarray:
        _, body = self._rpc(OP_PUSHPULL, b"".join(
            [_enc_key(key)] + _payload_parts(payload)))
        return _dec_tensor(body, 0)[0]

    def set_optimizer(self, optimizer, key_prefix: str = ""):
        self._rpc(OP_SET_OPT, _enc_text(_opt_to_wire(optimizer, key_prefix)))

    def stop_server(self):
        self._rpc(OP_STOP)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def spawn_server_proc(sid: int, n_servers: Optional[int] = None):
    """Spawn ONE standalone DMLC_ROLE=server subprocess and wait for its
    'MXNET_TPU_PS_SERVER <sid> <addr>' handshake line; returns
    (Popen, addr).  Shared by DistKVStore's worker-hosted slots and the
    launcher's --server-procs layout (``mxnet_tpu_torch.launch``) so the
    spawn env/handshake can never diverge between the two layouts.  The
    server sees no card (``CUDA_VISIBLE_DEVICES`` empty): it is a host
    process and never makes a CUDA context."""
    return spawn_server_procs([sid], n_servers)[0]


def spawn_server_procs(sids, n_servers: Optional[int] = None, ports=None):
    """:func:`spawn_server_proc` for each of ``sids``, the processes
    started together (each takes seconds to import) → [(Popen, addr)]
    in ``sids``' order.  A server that dies before its handshake stops
    the others and raises.  With ``ports`` (one a server, free on this
    host) each server binds its own and the call returns at once: the
    addresses are known, and a client that connects before its server
    listens tries again (:class:`PSClient`)."""
    import subprocess
    import sys as _sys
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for sid in sids:
        env = dict(os.environ)
        env.update({
            "DMLC_ROLE": "server",
            "DMLC_SERVER_ID": str(sid),
            "DMLC_NUM_SERVER": str(n_servers if n_servers is not None
                                   else num_servers()),
            # servers never touch the card; keys hash with crc32 so no
            # PYTHONHASHSEED pinning is needed
            "CUDA_VISIBLE_DEVICES": "",
            "MXNET_TPU_PS_BIND": env.get("MXNET_TPU_PS_BIND", "127.0.0.1"),
            # a user-exported fixed port would EADDRINUSE the 2nd slot on
            # the same host; spawned slots take the port given them, or an
            # ephemeral one
            "MXNET_TPU_PS_PORT": str(ports[len(procs)] if ports else 0),
            "PYTHONPATH": repo_root + os.pathsep + env.get("PYTHONPATH", ""),
        })
        procs.append(subprocess.Popen(
            [_sys.executable, "-c",
             "from mxnet_tpu_torch.kvstore.kvstore_server import "
             "_init_kvstore_server_module as m; m()"],
            env=env, stdout=subprocess.PIPE, text=True))
    if ports:
        return [(p, f"{env['MXNET_TPU_PS_BIND']}:{port}")
                for p, port in zip(procs, ports)]
    out = []
    for sid, p in zip(sids, procs):
        addr = None
        for line in p.stdout:
            if line.startswith("MXNET_TPU_PS_SERVER"):
                addr = line.split()[2]
                break
        if addr is None:
            for q in procs:
                q.terminate()
            raise RuntimeError(
                f"kvstore server {sid} died before publishing its address "
                f"(exit code {p.poll()})")
        out.append((p, addr))
    return out


# ----------------------------------------------------------- server group
class PSGroup:
    """Round-robin key router over DMLC_NUM_SERVER servers.

    ≙ kvstore_dist.h:729 EncodeDefaultKey (key % num_servers owns the
    key) + the big-array slicing of EncodeCompressedKey: tensors with
    >= MXNET_KVSTORE_BIGARRAY_BOUND elements are split into S contiguous
    flat chunks, chunk s living on server s under key "<key>#s", so one
    hot tensor's bandwidth spreads over every server.
    """

    def __init__(self, timeout_s: float = 60.0, seq: int = 0,
                 n: Optional[int] = None, slice_big: bool = True):
        self.n = n if n is not None else num_servers()
        self.clients: List[PSClient] = [
            PSClient(timeout_s=timeout_s, seq=seq, sid=s)
            for s in range(self.n)]
        self._bound = bigarray_bound()
        self._slice_big = slice_big
        self._shapes: Dict[str, tuple] = {}   # sliced keys → full shape
        # Wire keys are namespaced by store seq: in standalone-server mode
        # (MXNET_TPU_PS_ADDRS) every store instance reaches the SAME server
        # set, and without the prefix a second store's keys/set_optimizer
        # silently collide with the first.  Worker-hosted layouts spawn
        # fresh servers per seq, where the prefix is harmless.
        self._prefix = f"{seq}/"

    def _wk(self, key) -> str:
        """Worker key → wire key (seq-namespaced)."""
        return self._prefix + str(key)

    def _sid(self, key) -> int:
        k = str(key)
        if k.lstrip("-").isdigit():
            return int(k) % self.n
        # crc32, NOT hash(): python string hashing is per-process
        # randomized (PYTHONHASHSEED) and every worker must agree on the
        # owner (≙ EncodeDefaultKey's deterministic key % S)
        import zlib
        return zlib.crc32(k.encode()) % self.n

    def _sliced(self, key, size) -> bool:
        return self.n > 1 and self._slice_big and size >= self._bound

    @staticmethod
    def _chunks(arr: _onp.ndarray, n):
        return _onp.array_split(arr.ravel(), n)

    def init(self, key, val: _onp.ndarray):
        val = _onp.asarray(val)
        if self._sliced(key, val.size):
            self._shapes[str(key)] = val.shape
            for s, ch in enumerate(self._chunks(val, self.n)):
                self.clients[s].init(self._wk(f"{key}#{s}"), ch)
        else:
            self.clients[self._sid(key)].init(self._wk(key), val)

    def push(self, key, payload):
        _telemetry.counter_add("kvstore.ps_push_total")
        with _telemetry.timed("kvstore.ps_push_us"):
            self._push(key, payload)

    def _push(self, key, payload):
        if str(key) in self._shapes:
            if payload[0] != "raw":
                # packed codes can't be resliced at byte granularity; the
                # store disables slicing when compression is on (init
                # order), so reaching here means compression was enabled
                # AFTER keys were init'd — fail loudly instead of silently
                # updating a phantom unsliced key while pulls read shards
                raise RuntimeError(
                    f"key {key} was init'd sliced across servers but the "
                    "push is compressed; call set_gradient_compression "
                    "BEFORE init so slicing is disabled for this store")
            for s, ch in enumerate(self._chunks(payload[1], self.n)):
                self.clients[s].push(self._wk(f"{key}#{s}"), ("raw", ch))
        else:
            self.clients[self._sid(key)].push(self._wk(key), payload)

    def push_merged(self, key, arr: _onp.ndarray, num_merge: int):
        """Forward ONE combined push on behalf of num_merge co-located
        workers (the WorkersMerge leader's server-bound hop, ≙ the fork's
        Send2 with KVMeta::num_merge).  The merge buffer is always dense
        (compressed member pushes were decoded before summing), so sliced
        keys re-chunk exactly like an uncompressed push; every shard's
        frame carries the num_merge trailer and this call drains every
        shard's replayed responses before returning."""
        arr = _onp.asarray(arr)
        _telemetry.counter_add("kvstore.ps_merged_push_total")
        with _telemetry.timed("kvstore.ps_push_us"):
            if str(key) in self._shapes:
                for s, ch in enumerate(self._chunks(arr, self.n)):
                    self.clients[s].push(self._wk(f"{key}#{s}"), ("raw", ch),
                                         num_merge=num_merge)
            else:
                self.clients[self._sid(key)].push(self._wk(key),
                                                  ("raw", arr),
                                                  num_merge=num_merge)

    def pull(self, key) -> _onp.ndarray:
        _telemetry.counter_add("kvstore.ps_pull_total")
        with _telemetry.timed("kvstore.ps_pull_us"):
            shape = self._shapes.get(str(key))
            if shape is not None:
                parts = [self.clients[s].pull(self._wk(f"{key}#{s}"))
                         for s in range(self.n)]
                return _onp.concatenate(parts).reshape(shape)
            return self.clients[self._sid(key)].pull(self._wk(key))

    def set_optimizer(self, optimizer):
        for c in self.clients:
            c.set_optimizer(optimizer, key_prefix=self._prefix)

    def stop_servers(self):
        for c in self.clients:
            try:
                c.stop_server()
            except Exception:
                pass

    def close(self):
        for c in self.clients:
            c.close()
