"""Distributed data service (≙ ``mxnet_tpu/io/data_service.py``): decode
fanned out across worker processes, merged back into one deterministic
stream by a resilient feed client.

Topology::

    decode worker 0..N-1                 training host
    ┌──────────────────┐   GET /batch   ┌──────────────────────────┐
    │ source.read_shard│◄───────────────│ FeedClient (prefetch pool │
    │  (epoch, shard)  │───────────────►│  + ordered merge buffer)  │
    │ /healthz /spec   │   uint8 wire   │   └─ DataFeed staging ring│
    └──────────────────┘                └──────────────────────────┘

**Determinism.**  A *shard* is one batch of the seeded global epoch
permutation: shard ``k`` of epoch ``e`` is the records
``perm(seed, e)[k*B:(k+1)*B]``, and every worker (and the client's local
fallback) computes the identical bytes for a given ``(epoch, shard)``.
Workers are stateless decode capacity, so every recovery is safe:

- a failed fetch is replayed on any survivor (same bytes);
- a worker dying mid-epoch leaves its unacknowledged shards unmerged, so
  survivors fetch them again;
- when every worker is unroutable the client decodes the shard itself
  (counted ``feed_service.local_fallback_batches``, warned once): a
  slower feed, never a different one;
- a restored job re-enters mid-epoch through the cursor (``position()``
  / ``seek()``, which ``DataFeed.seek`` uses) and replays the exact
  remaining stream.

The client's gates are the router's: ``/healthz`` probes with
consecutive-failure ejection and reinstatement, request failures on the
same ladder, bounded retries with full-jitter exponential backoff under
a per-batch deadline, and ``MXNET_FEED_FAULT=[site:]mode:prob[:ms]``
(sites ``worker`` | ``client``) through the shared fault registry
(``faults.py``).  ``notify_respawn(rank)`` (a supervisor's
``on_respawn``) reinstates a returned worker at once; across processes
the same notice arrives as ``worker<rank>-attempt<k>`` files in
``MXNET_FEED_NOTIFY_DIR``.

For ``DataFeed`` the client is a ``next_raw(out=)`` source of ``dtype``
``"uint8"``: the shard's bytes go straight into the ring's pinned buffer
(read off the socket into it when ``prefetch=0``, one copy from the
fetched body otherwise).  Everything is counted under the
``feed_service`` telemetry section.  Workers are host processes: they
import no CUDA state and touch no card.

Worker CLI::

    python -m mxnet_tpu_torch.io.data_service --worker \\
        --spec synthetic:8x3x32x32:10:256 --port 7070 [--seed 0]

Source specs (``register_source`` adds kinds):

- ``synthetic:BxCxHxW:classes:records`` — pseudo-images whose bytes are
  a pure function of (seed, record index);
- ``rec:PATH:BxCxHxW[:label_width]`` — a RecordIO pack read by record id
  through the indexed reader and the python decode tier, each image
  center-cropped / zero-padded to HxW, CHW.
"""
from __future__ import annotations

import http.client
import json
import os
import random as _random
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import faults as _faults
from .. import telemetry as _telemetry

__all__ = ["FeedClient", "DecodeWorker", "FeedServiceError",
           "make_source", "register_source", "epoch_permutation",
           "SyntheticSource", "RecSource", "FAULT_ENV"]

FAULT_ENV = "MXNET_FEED_FAULT"
FAULT_SITES = ("worker", "client")

_DOMAIN = _faults.register(FAULT_ENV, sites=FAULT_SITES,
                           counter_prefix="feed_service.fault")


def _env_int(name, default):
    try:
        return int(os.environ.get(name, ""))
    except (TypeError, ValueError):
        return default


def _env_float(name, default):
    try:
        return float(os.environ.get(name, ""))
    except (TypeError, ValueError):
        return default


class FeedServiceError(RuntimeError):
    """A batch could not be produced (every worker unroutable or the
    retry budget spent, and the local fallback off or impossible)."""


# ------------------------------------------------------------- sources --

def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """The seeded global-shuffle permutation of record ids for one
    epoch, identical in every process (explicit integer mixing: Python's
    ``hash()`` is salted per process)."""
    mixed = (int(seed) * 2654435761 + (int(epoch) + 1) * 40503) % (1 << 32)
    return np.random.RandomState(mixed).permutation(int(n))


class SyntheticSource:
    """``synthetic:BxCxHxW:classes:records`` — every sample is a pure
    function of its global record index, so the shuffled stream is
    checkable bit for bit anywhere."""

    kind = "synthetic"

    def __init__(self, rest: str, seed: int = 0):
        try:
            shape_s, classes_s, records_s = rest.split(":")
            b, c, h, w = (int(v) for v in shape_s.split("x"))
            self.classes = int(classes_s)
            self.num_records = int(records_s)
        except ValueError:
            raise ValueError(
                f"bad synthetic spec {rest!r}: want BxCxHxW:classes:records")
        if b <= 0 or self.num_records < b:
            raise ValueError(f"synthetic spec {rest!r}: need records >= "
                             f"batch > 0")
        self.batch_size = b
        self.data_shape = (c, h, w)
        self.label_width = 1
        self.seed = int(seed)
        self.spec = f"synthetic:{rest}"
        self.num_batches = self.num_records // b
        self._mu = threading.Lock()
        self._perm_epoch: Optional[int] = None
        self._perm: Optional[np.ndarray] = None

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        with self._mu:
            if self._perm_epoch != epoch:
                self._perm = epoch_permutation(self.seed, epoch,
                                               self.num_records)
                self._perm_epoch = epoch
            return self._perm

    def _sample(self, rec: int) -> Tuple[np.ndarray, float]:
        mixed = (self.seed * 977 + int(rec) * 2246822519 + 3) % (1 << 32)
        rs = np.random.RandomState(mixed)
        c, h, w = self.data_shape
        data = rs.randint(0, 256, (c, h, w)).astype(np.uint8)
        return data, float(rec % max(self.classes, 1))

    def read_shard(self, epoch: int, shard: int):
        b = self.batch_size
        if not 0 <= shard < self.num_batches:
            raise IndexError(f"shard {shard} out of range "
                             f"[0,{self.num_batches})")
        recs = self._epoch_perm(epoch)[shard * b:(shard + 1) * b]
        data = np.empty((b,) + self.data_shape, np.uint8)
        label = np.empty((b, self.label_width), np.float32)
        for i, r in enumerate(recs):
            data[i], label[i, 0] = self._sample(int(r))
        return data, label, 0

    def describe(self) -> dict:
        return {"spec": self.spec, "batch_size": self.batch_size,
                "data_shape": list(self.data_shape),
                "label_width": self.label_width,
                "num_batches": self.num_batches,
                "num_records": self.num_records, "seed": self.seed}


class RecSource:
    """``rec:PATH:BxCxHxW[:label_width]`` — a RecordIO pack served by
    record id through the indexed reader and the python decode tier
    (``recordio.unpack_img``; ``.npy`` payloads need no codec).  Images
    are center-cropped / zero-padded to HxW, the native loader's output
    geometry without its augmentations."""

    kind = "rec"

    def __init__(self, rest: str, seed: int = 0):
        parts = rest.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"bad rec spec {rest!r}: want PATH:BxCxHxW[:label_width]")
        path, shape_s = parts[0], parts[1]
        b, c, h, w = (int(v) for v in shape_s.split("x"))
        from ..recordio import MXIndexedRecordIO
        idx = os.path.splitext(path)[0] + ".idx"
        if not os.path.exists(idx):
            raise FileNotFoundError(
                f"rec source needs the .idx twin of {path} "
                "(im2rec writes both)")
        self._rio = MXIndexedRecordIO(idx, path, "r")
        self._keys = sorted(self._rio.keys)
        self.batch_size = b
        self.data_shape = (c, h, w)
        self.label_width = int(parts[2]) if len(parts) == 3 else 1
        self.seed = int(seed)
        self.spec = f"rec:{rest}"
        self.num_records = len(self._keys)
        self.num_batches = self.num_records // b
        if self.num_batches == 0:
            raise ValueError(f"{path}: {self.num_records} records < "
                             f"batch {b}")
        self._mu = threading.Lock()
        self._perm_epoch: Optional[int] = None
        self._perm: Optional[np.ndarray] = None

    _epoch_perm = SyntheticSource._epoch_perm
    describe = SyntheticSource.describe

    def _fit(self, img: np.ndarray) -> np.ndarray:
        """HWC uint8 → CHW uint8 at the target geometry (center crop,
        zero pad)."""
        c, h, w = self.data_shape
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] < c:
            img = np.repeat(img[:, :, :1], c, axis=2)
        img = img[:, :, :c]
        ih, iw = img.shape[:2]
        top = max(0, (ih - h) // 2)
        left = max(0, (iw - w) // 2)
        img = img[top:top + h, left:left + w]
        out = np.zeros((h, w, c), np.uint8)
        out[:img.shape[0], :img.shape[1]] = img
        return np.ascontiguousarray(out.transpose(2, 0, 1))

    def read_shard(self, epoch: int, shard: int):
        from ..recordio import unpack_img
        b = self.batch_size
        if not 0 <= shard < self.num_batches:
            raise IndexError(f"shard {shard} out of range "
                             f"[0,{self.num_batches})")
        recs = self._epoch_perm(epoch)[shard * b:(shard + 1) * b]
        data = np.empty((b,) + self.data_shape, np.uint8)
        label = np.zeros((b, self.label_width), np.float32)
        for i, r in enumerate(recs):
            with self._mu:      # one file handle: read_idx seeks it
                raw = self._rio.read_idx(self._keys[int(r)])
            header, img = unpack_img(raw)
            data[i] = self._fit(np.asarray(img, np.uint8))
            lab = np.atleast_1d(np.asarray(header.label, np.float32))
            label[i, :min(self.label_width, lab.size)] = \
                lab[:self.label_width]
        return data, label, 0


_SOURCE_KINDS = {"synthetic": SyntheticSource, "rec": RecSource}


def register_source(kind: str, factory):
    """Plug a new worker source kind: ``factory(rest, seed) -> source``
    with :class:`SyntheticSource`'s attributes and methods."""
    _SOURCE_KINDS[kind] = factory


def make_source(spec: str, seed: int = 0):
    kind, sep, rest = spec.partition(":")
    if not sep or kind not in _SOURCE_KINDS:
        raise ValueError(f"unknown source spec {spec!r} "
                         f"(kinds: {sorted(_SOURCE_KINDS)})")
    return _SOURCE_KINDS[kind](rest, seed=seed)


# -------------------------------------------------------------- worker --

class DecodeWorker:
    """One decode worker: an HTTP server over a shard-addressable
    source.  Endpoints: ``/healthz`` (readiness), ``/spec`` (the source's
    descriptor: discovery and seed check), ``/stats`` (counters),
    ``/metrics`` (the registry in Prometheus text), and
    ``/batch?epoch=E&shard=S`` (the uint8 wire: data bytes then float32
    label bytes, shapes and pad in headers).  Faults at site ``worker``
    (``MXNET_FEED_FAULT``) impair replies."""

    def __init__(self, spec: str, host: str = "127.0.0.1", port: int = 0,
                 seed: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.source = make_source(spec, seed=seed)
        self._stats = {"batches": 0, "bytes": 0, "errors": 0}
        self._mu = threading.Lock()
        worker = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "mxtpu-feed-worker/1"

            def log_message(self, *a):   # noqa: N802 — stdlib name
                pass

            def _reply(self, status, body: bytes,
                       ctype="application/json", headers=None):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):            # noqa: N802 — stdlib name
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    self._reply(200, b'{"status":"ok"}')
                    return
                if path == "/spec":
                    self._reply(200, json.dumps(
                        worker.source.describe()).encode())
                    return
                if path == "/stats":
                    with worker._mu:
                        st = dict(worker._stats)
                    self._reply(200, json.dumps(st).encode())
                    return
                if path == "/metrics":
                    self._reply(200, _telemetry.dump_prometheus().encode(),
                                ctype="text/plain; version=0.0.4")
                    return
                if path != "/batch":
                    self._reply(404, b'{"error":"no route"}')
                    return
                fault = _DOMAIN.maybe("worker")
                if fault is not None:
                    mode, secs = fault
                    if mode == "delay":
                        _faults.apply_delay(secs)
                    elif mode == "black_hole":
                        # hold the socket, then drop it unanswered
                        _faults.apply_delay(secs)
                        self.close_connection = True
                        return
                    else:       # error
                        with worker._mu:
                            worker._stats["errors"] += 1
                        self._reply(500, b'{"error":"injected fault '
                                         b'(MXNET_FEED_FAULT)"}')
                        return
                # the decode span joins the client's fetch span, and it
                # closes before the reply goes out, so decode lies
                # within fetch on the merged timeline
                trace_hdr = self.headers.get(_telemetry.TRACE_HEADER)
                bad = None
                with _telemetry.span("feed_worker.batch",
                                     parent=(trace_hdr or None)) as _sp:
                    try:
                        kv = dict(p.split("=", 1)
                                  for p in query.split("&") if "=" in p)
                        epoch, shard = int(kv["epoch"]), int(kv["shard"])
                        _sp.set(epoch=epoch, shard=shard)
                        data, label, pad = worker.source.read_shard(
                            epoch, shard)
                    except (KeyError, ValueError, IndexError) as e:
                        with worker._mu:
                            worker._stats["errors"] += 1
                        bad = json.dumps(
                            {"error": f"bad batch request: {e}"}).encode()
                        _sp.set(error=type(e).__name__)
                    else:
                        body = data.tobytes() + label.astype(
                            np.float32, copy=False).tobytes()
                        with worker._mu:
                            worker._stats["batches"] += 1
                            worker._stats["bytes"] += len(body)
                        _telemetry.counter_add(
                            "feed_service.worker.batches")
                        _telemetry.counter_add(
                            "feed_service.worker.bytes", len(body))
                if bad is not None:
                    self._reply(400, bad)
                    return
                self._reply(200, body,
                            ctype="application/octet-stream",
                            headers={
                                "X-Feed-Data-Shape": ",".join(
                                    str(d) for d in data.shape),
                                "X-Feed-Label-Shape": ",".join(
                                    str(d) for d in label.shape),
                                "X-Feed-Pad": str(int(pad)),
                            })

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "DecodeWorker":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"feed-worker-{self.port}")
        self._thread.start()
        return self

    def serve_forever(self):
        self._httpd.serve_forever()

    def stop(self):
        if self._thread is not None:     # shutdown() hangs unless
            self._httpd.shutdown()       # serve_forever is running
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# -------------------------------------------------------------- client --

class _WorkerState:
    """The client's view of one worker's routability."""

    __slots__ = ("addr", "host", "port", "rank", "ejected",
                 "probe_fails", "req_fails", "ok_streak", "inflight")

    def __init__(self, addr: str, rank: int):
        self.addr = addr
        host, _, port = addr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.rank = rank
        self.ejected = False
        self.probe_fails = 0
        self.req_fails = 0
        self.ok_streak = 0
        self.inflight = 0


def _read_exact(r, view) -> int:
    """Fill ``view`` from the response ``r`` → the bytes read (fewer
    only when the body ends early)."""
    got, n = 0, len(view)
    while got < n:
        k = r.readinto(view[got:])
        if not k:
            break
        got += k
    return got


class FeedClient:
    """The resilient feed: an ordered prefetch pool over N decode
    workers with the ``next_raw()`` / ``reset()`` / ``position()`` /
    ``seek()`` source contract ``DataFeed`` stages from.

    Parameters (environment defaults ``MXNET_FEED_*``):

    workers        ["host:port", ...]; default ``MXNET_FEED_WORKERS``.
    spec           source spec for shapes and the local fallback; when
                   None it is read from a worker's ``/spec``.
    seed           global-shuffle seed — must equal the workers' (checked
                   against ``/spec``: a mismatch raises).
    prefetch       fan-out window (concurrent shard fetches merged back
                   in cursor order); 0 fetches on the caller's thread.
    local_fallback False forbids in-process decode: spent retries raise
                   :class:`FeedServiceError` instead.
    """

    dtype = "uint8"         # the wire's data type, for DataFeed

    def __init__(self, workers: Optional[List[str]] = None,
                 spec: Optional[str] = None, seed: int = 0,
                 prefetch: Optional[int] = None,
                 probe_ms: Optional[float] = None,
                 probe_timeout_ms: Optional[float] = None,
                 unhealthy_after: Optional[int] = None,
                 healthy_after: Optional[int] = None,
                 retries: Optional[int] = None,
                 backoff_ms: Optional[float] = None,
                 timeout_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None,
                 local_fallback: Optional[bool] = None,
                 start_probing: bool = True, name: str = "feed"):
        if workers is None:
            raw = os.environ.get("MXNET_FEED_WORKERS", "")
            workers = [w.strip() for w in raw.split(",") if w.strip()]
        if not workers and spec is None:
            raise ValueError("FeedClient needs workers (or "
                             "MXNET_FEED_WORKERS) and/or a spec")
        self._workers = [_WorkerState(a, i)
                         for i, a in enumerate(workers)]
        self._seed = int(seed)
        self._name = name
        self._probe_s = (probe_ms if probe_ms is not None else
                         _env_float("MXNET_FEED_PROBE_MS", 500.0)) / 1e3
        self._probe_timeout_s = (
            probe_timeout_ms if probe_timeout_ms is not None else
            _env_float("MXNET_FEED_PROBE_TIMEOUT_MS", 1000.0)) / 1e3
        self._unhealthy_after = (
            unhealthy_after if unhealthy_after is not None else
            _env_int("MXNET_FEED_UNHEALTHY_AFTER", 3))
        self._healthy_after = (
            healthy_after if healthy_after is not None else
            _env_int("MXNET_FEED_HEALTHY_AFTER", 1))
        self._retries = (retries if retries is not None else
                         _env_int("MXNET_FEED_RETRIES", 3))
        self._backoff_s = (backoff_ms if backoff_ms is not None else
                           _env_float("MXNET_FEED_BACKOFF_MS", 25.0)) / 1e3
        self._timeout_s = (timeout_ms if timeout_ms is not None else
                           _env_float("MXNET_FEED_TIMEOUT_MS", 5000.0)) / 1e3
        self._deadline_s = (
            deadline_ms if deadline_ms is not None else
            _env_float("MXNET_FEED_DEADLINE_MS", 15000.0)) / 1e3
        if local_fallback is None:
            local_fallback = _env_int("MXNET_FEED_LOCAL_FALLBACK", 1) != 0
        self._local_fallback_ok = bool(local_fallback)
        self._notify_dir = os.environ.get("MXNET_FEED_NOTIFY_DIR") or None
        self._seen_notices: set = set()

        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._stats: Dict[str, int] = {
            "remote_batches": 0, "local_fallback_batches": 0,
            "fetch_retries": 0, "fetch_failures": 0,
            "deadline_exceeded": 0, "ejections": 0,
            "reinstatements": 0, "respawn_notices": 0,
        }
        self._warned_fallback = False
        self._rr = 0
        self._closed = False

        # discovery: shapes and cursor bounds from the spec or a worker
        self._spec = spec
        self._local_source = None
        if spec is not None:
            self._local_source = make_source(spec, seed=self._seed)
            self._meta = self._local_source.describe()
        else:
            self._meta = self._discover()
            self._spec = self._meta["spec"]
        if int(self._meta.get("seed", self._seed)) != self._seed:
            raise FeedServiceError(
                f"seed mismatch: client {self._seed} vs workers "
                f"{self._meta.get('seed')} — global shuffle would "
                f"diverge")
        self._num_batches = int(self._meta["num_batches"])

        # cursor and ordered merge buffer
        self._epoch = 0
        self._cursor = 0          # next shard handed to the consumer
        self._next_claim = 0      # next shard a fetcher may claim
        self._gen = 0             # bumped by reset/seek: voids claims
        self._results: Dict[int, object] = {}

        if prefetch is None:
            prefetch = _env_int("MXNET_FEED_PREFETCH",
                                max(2, len(self._workers)))
        self._window = max(0, int(prefetch))
        self._fetchers: List[threading.Thread] = []
        for i in range(min(self._window, 8)):
            t = threading.Thread(target=self._fetch_loop, daemon=True,
                                 name=f"{name}-fetch{i}")
            t.start()
            self._fetchers.append(t)

        self._prober: Optional[threading.Thread] = None
        self._probe_now = threading.Event()
        if start_probing and self._workers:
            self._prober = threading.Thread(target=self._probe_loop,
                                            daemon=True,
                                            name=f"{name}-probe")
            self._prober.start()

    # ------------------------------------------------------ bookkeeping
    def _count(self, key: str, n: int = 1):
        with self._mu:
            self._stats[key] = self._stats.get(key, 0) + n
        _telemetry.counter_add(f"feed_service.{key}", n)

    def _routable(self) -> List[_WorkerState]:
        return [w for w in self._workers if not w.ejected]

    def _eject(self, w: _WorkerState, why: str):
        # the caller does not hold _mu
        with self._mu:
            if w.ejected:
                return
            w.ejected = True
            w.ok_streak = 0
        self._count("ejections")
        _telemetry.gauge_set("feed_service.routable_workers",
                             len(self._routable()))
        sys.stderr.write(f"[{self._name}] worker {w.addr} ejected "
                         f"({why})\n")

    def _reinstate(self, w: _WorkerState):
        with self._mu:
            if not w.ejected:
                return
            w.ejected = False
            w.probe_fails = 0
            w.req_fails = 0
        self._count("reinstatements")
        _telemetry.gauge_set("feed_service.routable_workers",
                             len(self._routable()))
        sys.stderr.write(f"[{self._name}] worker {w.addr} "
                         f"reinstated\n")

    # ---------------------------------------------------------- probing
    def _probe_one(self, w: _WorkerState) -> bool:
        try:
            conn = http.client.HTTPConnection(
                w.host, w.port, timeout=self._probe_timeout_s)
            try:
                conn.request("GET", "/healthz")
                r = conn.getresponse()
                r.read()        # closing with the body unread resets
                ok = r.status == 200
            finally:
                conn.close()
        except OSError:
            ok = False
        return ok

    def _probe_loop(self):
        while not self._closed:
            self._check_notify_dir()
            for w in self._workers:
                if self._closed:
                    return
                if self._probe_one(w):
                    w.probe_fails = 0
                    w.ok_streak += 1
                    if w.ejected and w.ok_streak >= self._healthy_after:
                        self._reinstate(w)
                else:
                    w.ok_streak = 0
                    w.probe_fails += 1
                    if (not w.ejected and
                            w.probe_fails >= self._unhealthy_after):
                        self._eject(w, f"{w.probe_fails} consecutive "
                                       f"probe failures")
            self._probe_now.wait(self._probe_s)
            self._probe_now.clear()

    def notify_respawn(self, rank: int, attempt: int = 0, rc: int = 0):
        """Worker ``rank`` was relaunched (a supervisor's
        ``on_respawn(rank, attempt, rc)``): reset its failure ladder and
        probe now, so reinstatement does not wait out the probe
        period."""
        if 0 <= rank < len(self._workers):
            w = self._workers[rank]
            with self._mu:
                w.probe_fails = 0
                w.req_fails = 0
            self._count("respawn_notices")
            self._probe_now.set()

    def _check_notify_dir(self):
        """Respawn notices from other processes: ``worker<rank>-
        attempt<k>`` files in ``MXNET_FEED_NOTIFY_DIR``."""
        d = self._notify_dir
        if not d:
            return
        try:
            names = os.listdir(d)
        except OSError:
            return
        for fname in names:
            if fname in self._seen_notices or \
                    not fname.startswith("worker"):
                continue
            self._seen_notices.add(fname)
            try:
                rank = int(fname[len("worker"):].split("-", 1)[0])
            except ValueError:
                continue
            self.notify_respawn(rank)

    # ---------------------------------------------------------- fetches
    def _pick(self) -> Optional[_WorkerState]:
        with self._mu:
            live = [w for w in self._workers if not w.ejected]
            if not live:
                return None
            self._rr += 1
            rr = self._rr
            # least loaded, with a rotating tiebreak so equal loads
            # spread instead of all landing on worker 0
            return min(live, key=lambda w: (w.inflight,
                                            (w.rank - rr) %
                                            max(len(self._workers), 1)))

    def _http_fetch(self, w: _WorkerState, epoch: int, shard: int,
                    timeout_s: float, out=None):
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection(w.host, w.port,
                                          timeout=max(timeout_s, 0.001))
        try:
            # the wire hop's span id rides to the worker in the trace
            # header: the worker's decode span nests under it
            with _telemetry.span("feed.http_fetch", worker=w.addr,
                                 epoch=epoch, shard=shard) as _hsp:
                th = _hsp.header()
                conn.request(
                    "GET", f"/batch?epoch={epoch}&shard={shard}",
                    headers=({_telemetry.TRACE_HEADER: th} if th else {}))
                r = conn.getresponse()
                if r.status != 200:
                    raise FeedServiceError(f"{w.addr}: HTTP {r.status}")
                dshape = tuple(int(v) for v in
                               r.getheader("X-Feed-Data-Shape").split(","))
                lshape = tuple(
                    int(v) for v in
                    r.getheader("X-Feed-Label-Shape").split(","))
                pad = int(r.getheader("X-Feed-Pad", "0"))
                dn = int(np.prod(dshape))
                ln = int(np.prod(lshape)) * 4
                # the body read off the socket once: the data into the
                # caller's buffer when one is given
                if out is None:
                    body = np.empty(dn + ln, np.uint8)
                    data = body[:dn].reshape(dshape)
                    label = body[dn:].view(np.float32).reshape(lshape)
                    got = _read_exact(r, memoryview(body))
                else:
                    data = _view(out, dshape)
                    label = np.empty(lshape, np.float32)
                    got = _read_exact(r, memoryview(data).cast("B")) + \
                        _read_exact(r, memoryview(label).cast("B"))
        finally:
            conn.close()
        if got != dn + ln:
            raise FeedServiceError(
                f"{w.addr}: short wire body {got} != {dn + ln}")
        _telemetry.observe("feed_service.fetch_us",
                           (time.perf_counter() - t0) * 1e6)
        return data, label, pad

    def _ensure_local_source(self):
        if self._local_source is None:
            if self._spec is None:
                raise FeedServiceError(
                    "no local fallback: source spec unknown")
            self._local_source = make_source(self._spec,
                                             seed=self._seed)
        return self._local_source

    def _fetch(self, epoch: int, shard: int, out=None):
        """One shard, resiliently: attempts on routable workers with
        full-jitter exponential backoff under the per-batch deadline,
        then the counted local decode."""
        with _telemetry.span("feed.fetch", epoch=epoch,
                             shard=shard) as _fsp:
            return self._fetch_traced(epoch, shard, _fsp, out)

    def _fetch_traced(self, epoch: int, shard: int, _fsp, out):
        deadline = time.monotonic() + self._deadline_s
        last_err: Optional[BaseException] = None
        for attempt in range(max(self._retries, 1)):
            fault = _DOMAIN.maybe("client")
            if fault is not None:
                mode, secs = fault
                if mode == "delay":
                    _faults.apply_delay(secs)
                elif mode == "black_hole":
                    _faults.apply_delay(
                        min(secs, max(deadline - time.monotonic(), 0)))
                    last_err = FeedServiceError(
                        "injected client black_hole")
                    break
                else:
                    last_err = FeedServiceError("injected client error")
                    self._count("fetch_failures")
                    continue
            w = self._pick()
            if w is None:
                break                        # nobody routable
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._count("deadline_exceeded")
                break
            with self._mu:
                w.inflight += 1
            try:
                res = self._http_fetch(w, epoch, shard,
                                       min(self._timeout_s, remaining),
                                       out)
            except (OSError, http.client.HTTPException,
                    FeedServiceError, ValueError, AttributeError) as e:
                last_err = e
                self._count("fetch_failures")
                with self._mu:
                    w.req_fails += 1
                    fails = w.req_fails
                if fails >= self._unhealthy_after:
                    self._eject(w, f"{fails} consecutive request "
                                   f"failures")
                if attempt + 1 < max(self._retries, 1):
                    self._count("fetch_retries")
                    back = min(1.0, self._backoff_s * (2 ** attempt)) \
                        * _random.random()
                    if time.monotonic() + back >= deadline:
                        self._count("deadline_exceeded")
                        break
                    time.sleep(back)
            else:
                with self._mu:
                    w.req_fails = 0
                self._count("remote_batches")
                _fsp.set(source="remote", worker=w.addr)
                return res
            finally:
                with self._mu:
                    w.inflight -= 1
        # the floor of the degradation ladder: decode in process
        if self._local_fallback_ok and (self._spec or
                                        self._local_source):
            src = self._ensure_local_source()
            if not self._warned_fallback:
                self._warned_fallback = True
                sys.stderr.write(
                    f"[{self._name}] no routable decode worker "
                    f"({last_err}); falling back to local in-process "
                    f"decode (counted, throughput degraded)\n")
            self._count("local_fallback_batches")
            _fsp.set(source="local")
            with _telemetry.span("feed.local_decode", epoch=epoch,
                                 shard=shard):
                return _into(out, src.read_shard(epoch, shard))
        raise FeedServiceError(
            f"shard (epoch={epoch}, shard={shard}) unfetchable and "
            f"local fallback unavailable: {last_err}")

    def _fetch_loop(self):
        """Prefetch pool body: claim the next unclaimed shard inside the
        window, fetch it, merge the result under its shard index.  A
        reset or seek bumps the generation and stale results are dropped
        on merge, so a dead worker's shard is simply fetched again."""
        while True:
            with self._mu:
                while not self._closed and not self._claimable_locked():
                    self._cv.wait()
                if self._closed:
                    return
                gen, epoch, shard = self._gen, self._epoch, \
                    self._next_claim
                self._next_claim += 1
            try:
                res: object = self._fetch(epoch, shard)
            except BaseException as e:   # raised at the consumer
                res = e
            with self._mu:
                if gen == self._gen:
                    self._results[shard] = res
                    self._cv.notify_all()

    def _claimable_locked(self) -> bool:
        return (self._window > 0 and
                self._next_claim < min(self._cursor + self._window,
                                       self._num_batches))

    # --------------------------------------------------------- consume
    def next_raw(self, out=None):
        """The next batch of the deterministic stream as host numpy
        ``(data, label, pad)``; ``out`` (a uint8 host tensor of at least
        the batch's bytes, such as ``DataFeed``'s pinned buffer) receives
        the data when given."""
        with self._mu:
            if self._closed:
                raise RuntimeError("FeedClient is closed")
            if self._cursor >= self._num_batches:
                raise StopIteration
            shard, epoch = self._cursor, self._epoch
            if self._window == 0:
                self._cursor += 1
            else:
                self._cv.notify_all()      # wake fetchers for the window
                while shard not in self._results and not self._closed:
                    self._cv.wait()
                if self._closed:
                    raise RuntimeError("FeedClient is closed")
                res = self._results.pop(shard)
                self._cursor += 1
                self._cv.notify_all()
                if isinstance(res, BaseException):
                    raise res
                return _into(out, res)
        # synchronous mode: fetch outside the lock
        return self._fetch(epoch, shard, out)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_raw()

    def reset(self):
        """End of epoch: advance to the next seeded permutation."""
        with self._mu:
            self._gen += 1
            self._epoch += 1
            self._cursor = 0
            self._next_claim = 0
            self._results.clear()
            self._cv.notify_all()

    # ---------------------------------------------------------- cursor
    def position(self) -> dict:
        with self._mu:
            return {"epoch": self._epoch, "batch": self._cursor}

    def seek(self, batch, epoch=None) -> dict:
        """Jump the cursor.  ``batch`` past the epoch's end rolls through
        it: ``seek(nb + 3)`` from epoch e lands at (e + 1, 3)."""
        with self._mu:
            self._gen += 1
            e = self._epoch if epoch is None else int(epoch)
            b = int(batch)
            if b < 0:
                raise ValueError(f"negative batch {b}")
            if self._num_batches > 0:
                e += b // self._num_batches
                b = b % self._num_batches
            self._epoch, self._cursor, self._next_claim = e, b, b
            self._results.clear()
            self._cv.notify_all()
        return self.position()

    # ----------------------------------------------------------- misc
    @property
    def batch_size(self) -> int:
        return int(self._meta["batch_size"])

    @property
    def num_batches(self) -> int:
        return self._num_batches

    @property
    def provide_data(self):
        from . import DataDesc
        return [DataDesc("data", (self.batch_size,) +
                         tuple(self._meta["data_shape"]))]

    @property
    def provide_label(self):
        from . import DataDesc
        return [DataDesc("softmax_label",
                         (self.batch_size,
                          int(self._meta["label_width"])))]

    def stats(self) -> dict:
        with self._mu:
            out = dict(self._stats)
            out["workers"] = [
                {"addr": w.addr, "ejected": w.ejected,
                 "probe_fails": w.probe_fails,
                 "req_fails": w.req_fails, "inflight": w.inflight}
                for w in self._workers]
            out["routable_workers"] = sum(
                1 for w in self._workers if not w.ejected)
            out["epoch"] = self._epoch
            out["cursor"] = self._cursor
            out["num_batches"] = self._num_batches
            out["prefetch"] = self._window
        return out

    def close(self):
        with self._mu:
            self._closed = True
            self._cv.notify_all()
        self._probe_now.set()
        for t in self._fetchers:
            t.join(timeout=10)
        if self._prober is not None:
            self._prober.join(timeout=10)
        self._fetchers = []
        self._prober = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _discover(self) -> dict:
        """No spec given: the source's descriptor from the first worker
        that answers ``/spec`` (within the fetch deadline)."""
        deadline = time.monotonic() + self._deadline_s
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            for w in self._workers:
                try:
                    conn = http.client.HTTPConnection(
                        w.host, w.port, timeout=self._probe_timeout_s)
                    try:
                        conn.request("GET", "/spec")
                        r = conn.getresponse()
                        if r.status == 200:
                            return json.loads(r.read())
                    finally:
                        conn.close()
                except (OSError, ValueError) as e:
                    last = e
            time.sleep(0.2)
        raise FeedServiceError(
            f"could not discover source spec from workers "
            f"{[w.addr for w in self._workers]}: {last}")


def _view(out, shape) -> np.ndarray:
    """The first bytes of the uint8 host tensor ``out`` as a uint8 array
    of ``shape``."""
    n = int(np.prod(shape))
    return out[:n].numpy().reshape(shape)


def _into(out, res):
    """``(data, label, pad)`` with the data copied into ``out`` when
    one is given (and not already there)."""
    if out is None:
        return res
    data, label, pad = res
    dst = _view(out, data.shape)
    if dst.ctypes.data != data.ctypes.data:
        np.copyto(dst, data)
    return dst, label, pad


# ------------------------------------------------------------------ CLI --

def _main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.io.data_service",
        description="decode worker of the distributed data service")
    ap.add_argument("--worker", action="store_true",
                    help="run one decode worker (HTTP server)")
    ap.add_argument("--spec", default=None,
                    help="source spec (synthetic:... | rec:...)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--seed", type=int,
                    default=_env_int("MXNET_FEED_SEED", 0))
    args = ap.parse_args(argv)
    if not args.worker:
        ap.error("only --worker mode is runnable from the CLI")
    if not args.spec:
        ap.error("--worker needs --spec")
    w = DecodeWorker(args.spec, host=args.host, port=args.port,
                     seed=args.seed)
    print(f"[feed-worker] serving {args.spec} on {w.addr}", flush=True)
    try:
        w.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(_main())
