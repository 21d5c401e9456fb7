"""mx.checkpoint — durable async checkpointing of live training state
(≙ ``mxnet_tpu/checkpoint.py``; the on-disk format is the reference's,
byte for byte, so either package restores the other's checkpoints).

The unit of survival is the Trainer's tree: parameters (running
statistics included), optimizer states, the fused step's control block
and ``num_update`` / the learning rate in the manifest's meta.

- ``save(tree, step)`` runs at a step boundary and pays only for the
  copies on the card (``checkpoint.pause_us``): the tensor leaves of each
  device and dtype go into one buffer by one multi-tensor copy, queued
  on the calling thread's current stream, with an event recorded after
  it.  The copy is what makes async safe: the fused step replays a CUDA
  graph that writes the parameters and states in place, as the
  reference's next donated step invalidates its buffers.  The writer
  thread waits on that event, copies each buffer to the host through a
  pinned buffer it reuses (synchronously, so a snapshot is freed only
  after its copy ended), then hashes and writes each leaf from a view
  of it, without copying it again.  The snapshot queue is unbounded, as the
  reference's: a writer slower than the step holds card memory for every
  pending save (``stats()["pending_bytes"]``, ``["pending_bytes_max"]``).
- The commit is ATOMIC: per-leaf raw shards ``s%05d.bin`` land in a
  hidden ``.tmp-ckpt-*`` directory, every shard and ``manifest.json``
  (``version`` 1, ``format`` ``mxtpu-ckpt``, each leaf's ``key`` /
  ``file`` / ``shape`` / ``dtype`` / ``nbytes`` / ``sha256``, ``meta``) is
  fsynced, and one ``rename`` publishes ``ckpt-%08d/``.
- ``restore()`` validates the manifest version, shard sizes (torn writes)
  and sha256s (bit rot), and falls back to the newest intact checkpoint;
  ``MXNET_CKPT_FAULT`` (``torn_write`` / ``bitflip`` /
  ``crash_after_tmp``, the shared ``[site:]mode[:prob]`` grammar of
  ``faults.py``) exercises those branches.
- keep-last-K retention (``MXNET_CKPT_KEEP``, 5) bounds the disk;
  ``MXNET_CKPT_ASYNC=0`` makes every save synchronous.

Keys are the reference's slash paths (``params/<name>``,
``states/<name>/mom``, ``ctl/t``) in JAX's flatten order (dict keys
sorted at every level, sequences by index).  Leaves saved may be torch
tensors on any device, numpy arrays or Python scalars; restored leaves
are host numpy arrays, but a ``bfloat16`` leaf, which numpy cannot hold
without ``ml_dtypes``, is a CPU ``torch.bfloat16`` tensor (its bits read
and written through torch).

Observable as in the reference: histograms ``checkpoint.save_us`` /
``restore_us`` / ``pause_us``, counters ``checkpoint.saves``,
``bytes_written``, ``save_failures``, ``corrupt.<reason>``,
``restore_fallbacks``, ``gc_removed``, gauges
``checkpoint.last_success_step``, ``last_bytes``.  ``stats()`` also
splits the commit time into the copy to the host, the sha256 and the
write + fsync (``d2h_us_total``, ``sha256_us_total``,
``write_us_total``).
"""
from __future__ import annotations

import hashlib
import json
import os
import queue as _q
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import faults as _faults
from . import telemetry as _telemetry

__all__ = ["CheckpointManager", "CorruptCheckpoint", "NoCheckpointError",
           "atomic_write", "MANIFEST_VERSION"]

MANIFEST_VERSION = 1
_DIR_RE = re.compile(r"^ckpt-(\d{8})$")
_TMP_PREFIX = ".tmp-ckpt-"
_FAULT_ENV = "MXNET_CKPT_FAULT"
_FAULT_MODES = ("torn_write", "bitflip", "crash_after_tmp")

_FAULT_DOMAIN = _faults.register(
    _FAULT_ENV, sites=("commit",), modes=_FAULT_MODES,
    counter_prefix="checkpoint.fault")


class CorruptCheckpoint(Exception):
    """A published checkpoint failed validation (torn shard, checksum
    mismatch, unreadable/over-versioned manifest)."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"{reason}: {detail}" if detail else reason)


class NoCheckpointError(Exception):
    """No intact checkpoint could be restored from the root."""


class _InjectedCrash(Exception):
    """MXNET_CKPT_FAULT=crash_after_tmp: the simulated process death
    between the tmp-dir fsync and the publishing rename."""


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _fsync_dir(path: str):
    """Persist a directory entry (the rename); best-effort on platforms
    whose filesystems reject directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def atomic_write(path: str, data: bytes):
    """tmp + fsync + rename publish of a single file: a crash at any
    point leaves either the old file or the new one."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


# ------------------------------------------------------------------ trees
def _walk(tree, path=()):
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted, lists
    and tuples by index, None holding no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _path_key(path) -> str:
    """'a/b/0/c' key for one leaf path ('/' inside a name becomes '|')."""
    return "/".join(str(p).replace("/", "|") for p in path)


def _flatten(tree) -> Tuple[List[str], List[Any]]:
    """(keys, leaves) with deterministic slash-path keys."""
    flat = list(_walk(tree))
    keys = [_path_key(p) for p, _ in flat]
    if len(set(keys)) != len(keys):
        raise ValueError("checkpoint tree has colliding leaf paths")
    return keys, [leaf for _, leaf in flat]


def _unflatten(template, leaves: List[Any]):
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            return type(node)(vals) if not hasattr(node, "_fields") \
                else type(node)(*vals)
        return next(it)

    return build(template)


def _unflatten_nested(keys: List[str], leaves: List[Any]) -> dict:
    """Nested string-keyed dicts from slash paths (the no-template
    restore: exact for trainer trees, which are dicts all the way
    down)."""
    root: dict = {}
    for key, leaf in zip(keys, leaves):
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    return root


_TORCH_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32", torch.float64: "float64",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.int16: "int16", torch.int32: "int32",
                torch.int64: "int64", torch.bool: "bool"}


class _Flat:
    """The snapshot of every tensor leaf of one (device, dtype): one
    buffer, filled by one multi-tensor copy, and each leaf's (offset,
    numel, shape) in it."""

    __slots__ = ("buf", "spans")

    def __init__(self, leaves):
        sizes = [t.numel() for t in leaves]
        self.buf = torch.empty(sum(sizes), dtype=leaves[0].dtype,
                               device=leaves[0].device)
        views, self.spans, off = [], [], 0
        for t, n in zip(leaves, sizes):
            views.append(self.buf[off:off + n].view(t.shape))
            self.spans.append((off, n, list(t.shape)))
            off += n
        with torch.no_grad():
            torch._foreach_copy_(views, [t.detach() for t in leaves])

    @property
    def nbytes(self) -> int:
        return self.buf.numel() * self.buf.element_size()


def _snapshot(leaves):
    """Copies of ``leaves`` that the next step cannot change: the tensors
    of each (device, dtype) into one :class:`_Flat` (queued on the
    current stream), anything else as a numpy copy.  → (flats, the
    snapshot of each leaf: ``(flat index, span index)`` or an array)."""
    groups: Dict[tuple, List[int]] = {}
    snap: List[Any] = [None] * len(leaves)
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype not in _TORCH_NAMES:
                raise TypeError(f"checkpoint leaf of dtype {leaf.dtype}")
            groups.setdefault((leaf.device, leaf.dtype), []).append(i)
        else:
            snap[i] = np.array(leaf, copy=True, order="C")
    flats = []
    for idx in groups.values():
        for k, i in enumerate(idx):
            snap[i] = (len(flats), k)
        flats.append(_Flat([leaves[i] for i in idx]))
    return flats, snap


def _host_offsets(flats, align: int = 64):
    """Where each card flat lands in the writer's pinned buffer: byte
    offsets, ``align``-aligned and disjoint (None for a flat already on
    the host), and the bytes the buffer needs."""
    offs, total = [], 0
    for f in flats:
        if f.buf.device.type != "cuda":
            offs.append(None)
            continue
        total = -(-total // align) * align
        offs.append(total)
        total += f.nbytes
    return offs, total


def _numpy_bits(t: torch.Tensor) -> np.ndarray:
    """A host tensor's numpy view (a bf16 one by its bits)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _from_bytes(raw: bytes, dtype: str, shape):
    """One restored leaf: a numpy array, or a CPU bf16 tensor."""
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


class _Saved:
    """One queued save: its flat snapshots and each leaf's place in them,
    the event after their copies (None when no leaf is on a card) and the
    card bytes they hold."""

    __slots__ = ("keys", "flats", "snap", "event", "card_bytes", "step",
                 "meta", "done", "box", "sync")


class CheckpointManager:
    """Crash-consistent save/restore over a checkpoint root directory.

    ::

        mgr = CheckpointManager("/ckpts/run0", keep=5)
        for i, (x, y) in enumerate(batches):
            loss = step(x, y)                       # fused, one replay
            if i % 100 == 99:
                mgr.save_trainer(trainer, step=i + 1)   # µs pause, async

        # after a crash or preemption, possibly in a new process:
        step_resumed, meta = mgr.restore_trainer(trainer)

    ``save`` accepts a tree (dicts, lists, tuples) of tensors and arrays;
    ``restore`` rebuilds nested dicts, or any structure via
    ``template=``.  One manager owns one writer thread; saves commit in
    submission order.
    """

    def __init__(self, root: str, keep: Optional[int] = None,
                 async_write: Optional[bool] = None, name: str = "ckpt"):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.keep = _env_int("MXNET_CKPT_KEEP", 5) if keep is None \
            else int(keep)
        if async_write is None:
            async_write = os.environ.get(
                "MXNET_CKPT_ASYNC", "1").lower() not in ("0", "false", "off")
        self.async_write = bool(async_write)
        self._name = name
        self._mu = threading.Lock()
        self._queue: "_q.Queue" = _q.Queue()
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None
        self._async_errors: List[Exception] = []
        self._pinned: Optional[torch.Tensor] = None     # the writer's
        self._stats = {
            "saves": 0, "save_failures": 0, "bytes_written": 0,
            "last_step": None, "pause_us_total": 0.0, "pause_us_max": 0.0,
            "restores": 0, "restore_fallbacks": 0, "gc_removed": 0,
            "d2h_us_total": 0.0, "sha256_us_total": 0.0,
            "write_us_total": 0.0, "pending_bytes": 0,
            "pending_bytes_max": 0,
        }

    # ------------------------------------------------------------ listing
    def _dir_for(self, step: int) -> str:
        return os.path.join(self.root, f"ckpt-{int(step):08d}")

    def steps(self) -> List[int]:
        """Published checkpoint steps, ascending (tmp dirs excluded)."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for n in names:
            m = _DIR_RE.match(n)
            if m and os.path.isdir(os.path.join(self.root, n)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def stats(self) -> dict:
        """Counts and totals; ``pending`` saves not yet committed and the
        card bytes their snapshots hold (``pending_bytes``, its
        high-water mark ``pending_bytes_max``)."""
        with self._mu:
            out = dict(self._stats)
        out["pending"] = self._queue.unfinished_tasks
        return out

    # ------------------------------------------------------------- saving
    def save(self, tree, step: int, meta: Optional[dict] = None,
             blocking: bool = False) -> int:
        """Snapshot ``tree`` at this step boundary and commit it durably.

        The synchronous part (the step loop's pause) is one copy per
        leaf, queued on the card, and an event after them.  Everything
        else (the copies to the host, hashing, fsync, rename, GC) runs on
        the writer thread unless ``blocking=True`` (or the manager is
        synchronous), which waits for the commit and re-raises its
        failure."""
        step = int(step)
        meta = dict(meta or {})
        json.dumps(meta)    # surface a non-serializable meta now
        t0 = time.perf_counter_ns()
        job = _Saved()
        with _telemetry.span("checkpoint.pause", step=step):
            job.keys, leaves = _flatten(tree)
            job.flats, job.snap = _snapshot(leaves)
            cards = [f.buf for f in job.flats if f.buf.device.type == "cuda"]
            job.card_bytes = sum(f.nbytes for f in job.flats
                                 if f.buf.device.type == "cuda")
            job.event = None
            if cards:
                job.event = torch.cuda.Event()
                job.event.record(torch.cuda.current_stream(cards[0].device))
        pause_us = (time.perf_counter_ns() - t0) / 1000.0
        _telemetry.observe("checkpoint.pause_us", pause_us)
        with self._mu:
            self._stats["pause_us_total"] += pause_us
            self._stats["pause_us_max"] = max(self._stats["pause_us_max"],
                                              pause_us)
            self._stats["pending_bytes"] += job.card_bytes
            self._stats["pending_bytes_max"] = max(
                self._stats["pending_bytes_max"],
                self._stats["pending_bytes"])
        job.step, job.meta = step, meta
        job.done, job.box = threading.Event(), {}
        job.sync = blocking or not self.async_write
        self._ensure_thread()
        self._queue.put(job)
        if job.sync:
            job.done.wait()
            err = job.box.get("error")
            if err is not None:
                raise err
        return step

    def save_trainer(self, trainer, step: Optional[int] = None,
                     meta: Optional[dict] = None, feed=None,
                     blocking: bool = False) -> int:
        """Checkpoint a ``gluon.Trainer`` (parameters + optimizer states +
        the fused step's control block + ``num_update``); ``feed=`` also
        records a DataFeed's epoch/batch position in the manifest's
        meta."""
        tree, tmeta = trainer.export_checkpoint_state()
        tmeta.update(meta or {})
        if feed is not None:
            try:
                tmeta["datafeed"] = feed.position()
            except Exception:
                pass
        if step is None:
            step = int(tmeta.get("num_update", 0))
        return self.save(tree, step, meta=tmeta, blocking=blocking)

    def wait(self) -> Optional[Exception]:
        """Drain every pending async save; returns the most recent
        undelivered async-save error (sync saves already raised theirs),
        or None.  Consumes what it returns; ``last_error`` keeps the
        sticky record."""
        self._queue.join()
        with self._mu:
            errs = self._async_errors
            self._async_errors = []
        return errs[-1] if errs else None

    def close(self):
        if self._thread is not None:
            self._queue.join()
            self._queue.put(None)
            self._thread.join(timeout=10)
            self._thread = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True,
                name=f"{self._name}-writer")
            self._thread.start()

    def _writer_loop(self):
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                with _telemetry.timed("checkpoint.save_us"):
                    nbytes = self._commit(job)
                with self._mu:
                    self._stats["saves"] += 1
                    self._stats["bytes_written"] += nbytes
                    self._stats["last_step"] = job.step
                _telemetry.counter_add("checkpoint.saves")
                _telemetry.counter_add("checkpoint.bytes_written", nbytes)
                _telemetry.gauge_set("checkpoint.last_success_step",
                                     job.step)
                _telemetry.gauge_set("checkpoint.last_bytes", nbytes)
            except Exception as e:  # noqa: BLE001 — surfaced via box/stats
                reason = "injected_crash" if isinstance(e, _InjectedCrash) \
                    else type(e).__name__
                _telemetry.counter_add("checkpoint.save_failures")
                _telemetry.counter_add("checkpoint.save_failure." + reason)
                with self._mu:
                    self._stats["save_failures"] += 1
                    if not job.sync:
                        self._async_errors.append(e)
                self.last_error = e
                job.box["error"] = e
            finally:
                job.flats = job.snap = None     # the card memory goes back
                with self._mu:
                    self._stats["pending_bytes"] -= job.card_bytes
                job.done.set()
                self._queue.task_done()

    def _commit(self, job: _Saved) -> int:
        """Copies to the host + shard writes + manifest + atomic publish
        + retention GC, on the writer thread.  Returns bytes written."""
        hit = _FAULT_DOMAIN.maybe("commit")
        fault = hit[0] if hit else ""
        step = job.step
        tmp = os.path.join(self.root,
                           f"{_TMP_PREFIX}{step:08d}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        if job.event is not None:
            job.event.synchronize()     # the snapshots' copies are done
        sha = wr = 0
        t0 = time.perf_counter_ns()     # one copy to the host a buffer
        hosts = [_numpy_bits(h) for h in self._to_host(job.flats)]
        d2h = time.perf_counter_ns() - t0
        leaves_meta = []
        total = 0
        for i, (key, snap) in enumerate(zip(job.keys, job.snap)):
            if isinstance(snap, tuple):
                off, n, shape = job.flats[snap[0]].spans[snap[1]]
                arr = hosts[snap[0]][off:off + n]
                dtype = _TORCH_NAMES[job.flats[snap[0]].buf.dtype]
            else:                       # a fresh C-ordered numpy copy
                arr = snap
                shape, dtype = list(arr.shape), str(arr.dtype)
            # no copy: hashed and written from the view
            raw = memoryview(arr).cast("B") if arr.size else b""
            t1 = time.perf_counter_ns()
            digest = hashlib.sha256(raw).hexdigest()
            t2 = time.perf_counter_ns()
            fname = f"s{i:05d}.bin"
            with open(os.path.join(tmp, fname), "wb") as fh:
                fh.write(raw)
                fh.flush()
                os.fsync(fh.fileno())
            t3 = time.perf_counter_ns()
            sha, wr = sha + t2 - t1, wr + t3 - t2
            leaves_meta.append({
                "key": key, "file": fname, "shape": shape, "dtype": dtype,
                "nbytes": len(raw), "sha256": digest,
            })
            total += len(raw)
        with self._mu:
            self._stats["d2h_us_total"] += d2h / 1000.0
            self._stats["sha256_us_total"] += sha / 1000.0
            self._stats["write_us_total"] += wr / 1000.0
        manifest = {
            "version": MANIFEST_VERSION, "format": "mxtpu-ckpt",
            "step": step, "time": time.time(), "pid": os.getpid(),
            "leaves": leaves_meta, "meta": job.meta,
        }
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        # ---- fault injection: exercise every recovery branch for real
        if fault == "torn_write" and leaves_meta:
            # a torn shard: half the recorded bytes survive "the crash"
            p = os.path.join(tmp, leaves_meta[0]["file"])
            with open(p, "r+b") as f:
                f.truncate(max(0, leaves_meta[0]["nbytes"] // 2))
        elif fault == "bitflip" and leaves_meta:
            p = os.path.join(tmp, leaves_meta[0]["file"])
            with open(p, "r+b") as f:
                b = f.read(1)
                f.seek(0)
                f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        elif fault == "crash_after_tmp":
            # the process "dies" with the tmp dir fully written but the
            # publishing rename never issued: restore must not see it
            raise _InjectedCrash(
                "MXNET_CKPT_FAULT=crash_after_tmp before publish")
        final = self._dir_for(step)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.root)
        self._gc()
        return total

    def _to_host(self, flats) -> List[torch.Tensor]:
        """Each flat on the host: a card one copied into one pinned host
        buffer that the writer keeps and reuses (grown as needed), at an
        offset of its own so that no flat's copy overwrites another's; a
        CPU one as it is.  The copies are synchronous, without the GIL."""
        offs, total = _host_offsets(flats)
        if total and (self._pinned is None or self._pinned.numel() < total):
            self._pinned = torch.empty(total, dtype=torch.uint8,
                                       pin_memory=True)
        out = []
        for f, off in zip(flats, offs):
            if off is None:
                out.append(f.buf)
                continue
            host = self._pinned[off:off + f.nbytes].view(f.buf.dtype)
            host.copy_(f.buf)
            out.append(host)
        return out

    def _gc(self):
        """Retention: keep the newest K published checkpoints; sweep
        orphaned tmp dirs of crashed writers."""
        if self.keep and self.keep > 0:
            steps = self.steps()
            for s in steps[:-self.keep]:
                shutil.rmtree(self._dir_for(s), ignore_errors=True)
                with self._mu:
                    self._stats["gc_removed"] += 1
                _telemetry.counter_add("checkpoint.gc_removed")
        try:
            for n in os.listdir(self.root):
                if n.startswith(_TMP_PREFIX):
                    shutil.rmtree(os.path.join(self.root, n),
                                  ignore_errors=True)
        except OSError:
            pass

    # ----------------------------------------------------------- restoring
    def _validate(self, step: int) -> dict:
        """Manifest + checksum validation of one published checkpoint;
        raises CorruptCheckpoint with the failing reason."""
        d = self._dir_for(step)
        mpath = os.path.join(d, "manifest.json")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CorruptCheckpoint("manifest", f"{mpath}: {e}")
        if manifest.get("version", 0) > MANIFEST_VERSION:
            raise CorruptCheckpoint(
                "version", f"manifest v{manifest.get('version')} > "
                           f"reader v{MANIFEST_VERSION}")
        for lm in manifest.get("leaves", []):
            p = os.path.join(d, lm["file"])
            try:
                size = os.path.getsize(p)
            except OSError:
                raise CorruptCheckpoint("torn", f"missing shard {p}")
            if size != lm["nbytes"]:
                raise CorruptCheckpoint(
                    "torn", f"{p}: {size} bytes, manifest says "
                            f"{lm['nbytes']}")
            h = hashlib.sha256()
            with open(p, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            if h.hexdigest() != lm["sha256"]:
                raise CorruptCheckpoint("checksum", p)
        return manifest

    def _load_leaves(self, step: int, leaf_meta: List[dict]) -> list:
        d = self._dir_for(step)
        out = []
        for lm in leaf_meta:
            with open(os.path.join(d, lm["file"]), "rb") as f:
                raw = f.read()
            out.append(_from_bytes(raw, lm["dtype"], lm["shape"]))
        return out

    def restore(self, template=None, step: Optional[int] = None,
                subtree: Optional[str] = None,
                shardings: Optional[dict] = None):
        """Load the newest intact checkpoint (or the newest at or below
        ``step=``, still falling back to older intact ones when it is
        torn or corrupt).

        Returns ``(tree, meta, step)`` with host leaves (numpy arrays; a
        bf16 leaf as a CPU tensor): callers move them to their devices.
        Without ``template`` the tree is nested dicts from the manifest
        paths; with ``template`` (the structure the save flattened) the
        leaves are checked against its paths and put into it.
        ``subtree="params"`` restores only the leaves under that prefix
        (stripped from the returned keys): an inference server loads the
        parameters of a trainer checkpoint without its optimizer states
        and without a Trainer.  Intactness is still validated over every
        shard.  ``shardings=`` (restoring straight into a tensor-parallel
        layout) raises: sharded state belongs to the mesh item of the
        port's queue (ROADMAP Queue 1 item 7)."""
        if shardings:
            raise NotImplementedError(
                "restore(shardings=): sharded restores belong to the "
                "tensor-parallel slice of the port (ROADMAP Queue 1 item "
                "7), not ported yet")
        candidates = [s for s in reversed(self.steps())
                      if step is None or s <= step]
        if not candidates:
            raise NoCheckpointError(f"no checkpoints under {self.root}")
        prefix = subtree.rstrip("/") if subtree is not None else None
        errors = []
        for i, s in enumerate(candidates):
            try:
                with _telemetry.timed("checkpoint.restore_us"):
                    manifest = self._validate(s)
                    leaf_meta = manifest["leaves"]
                    keys = [lm["key"] for lm in leaf_meta]
                    if prefix is not None:
                        sel = [lm for lm in leaf_meta
                               if lm["key"] == prefix or
                               lm["key"].startswith(prefix + "/")]
                        if not sel:
                            raise CorruptCheckpoint(
                                "subtree",
                                f"no leaves under {prefix!r} "
                                f"(step {s} has {len(leaf_meta)} leaves)")
                        leaf_meta = sel
                        keys = [lm["key"][len(prefix):].lstrip("/")
                                for lm in leaf_meta]
                    leaves = self._load_leaves(s, leaf_meta)
                    if prefix is not None and keys == [""]:
                        # the prefix named a single leaf, not a subtree
                        tree = leaves[0]
                        if template is not None:
                            tkeys, _ = _flatten(template)
                            if len(tkeys) != 1:
                                raise CorruptCheckpoint(
                                    "keys_mismatch",
                                    f"template {len(tkeys)} leaves vs "
                                    f"single-leaf subtree {prefix!r}")
                            tree = _unflatten(template, leaves)
                    elif template is not None:
                        tkeys, _ = _flatten(template)
                        if tkeys != keys:
                            raise CorruptCheckpoint(
                                "keys_mismatch",
                                f"template {len(tkeys)} leaves vs "
                                f"manifest {len(keys)}")
                        tree = _unflatten(template, leaves)
                    else:
                        tree = _unflatten_nested(keys, leaves)
            except CorruptCheckpoint as e:
                errors.append(f"step {s}: {e}")
                _telemetry.counter_add("checkpoint.corrupt." + e.reason)
                if i + 1 < len(candidates):
                    _telemetry.counter_add("checkpoint.restore_fallbacks")
                    with self._mu:
                        self._stats["restore_fallbacks"] += 1
                continue
            _telemetry.counter_add("checkpoint.restores")
            with self._mu:
                self._stats["restores"] += 1
            return tree, manifest.get("meta", {}), s
        raise NoCheckpointError(
            "no intact checkpoint under %s: %s" % (self.root,
                                                   "; ".join(errors)))

    def restore_trainer(self, trainer, step: Optional[int] = None):
        """Restore a ``gluon.Trainer`` saved with :meth:`save_trainer`:
        parameters (in place, so a live fused step keeps its graph),
        optimizer states, ``num_update`` and the control block.  Returns
        ``(step, meta)``."""
        tree, meta, s = self.restore(step=step)
        trainer.import_checkpoint_state(tree, meta)
        return s, meta

    # ---------------------------------------------------------- preemption
    def on_preempt(self, export_fn: Callable[[], Tuple[Any, dict]],
                   step_fn: Optional[Callable[[], int]] = None):
        """A zero-arg callback for a preemption hook: drains pending
        async saves, then takes one final blocking save of what
        ``export_fn`` returns (``(tree, meta)``); ``step_fn`` defaults to
        ``meta["num_update"]``."""
        def _cb():
            self.wait()
            tree, meta = export_fn()
            step = step_fn() if step_fn is not None \
                else int(meta.get("num_update", 0))
            self.save(tree, step, meta=meta, blocking=True)
        return _cb
