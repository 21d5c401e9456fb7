"""``mx.kv``: the KVStore, a key → tensor store with aggregation (≙
``mxnet_tpu/kvstore/__init__.py``; reference ``include/mxnet/kvstore.h:56``,
``src/kvstore/``).  Factory strings ``local`` / ``device`` / ``nccl``,
``dist_sync`` / ``dist_device_sync`` / ``dist_async`` (``kvstore.cc:50-72``)
and the plugins ``p3``, ``horovod`` and ``byteps``.

Values are torch tensors; a store writes results into the caller's
tensors in place (``pull(k, out=t)``, ``pushpull(k, g, out=g)``), where
the reference rebinds its arrays.

- ``local`` / ``device``: one process's aggregation of per-device copies
  (≙ Comm::Reduce, ``comm.h:57``): a sum of the list.
- ``dist_sync`` / ``dist_device_sync``: the processes of a
  ``torch.distributed`` group (``parallel.dist``); a pushpull is one
  all-reduce over a flat buffer of the whole key list
  (``collective.CollectiveAllReduce``), NCCL on the card where each rank
  has its own, gloo through pinned host memory otherwise.
- ``dist_async``: the parameter server (``ps.py``): each push is applied
  by the server the moment it arrives (``kvstore_dist_server.h:882``),
  with ``set_optimizer`` running the optimizer there (update_on_kvstore),
  and, where several workers share a host, the fork's WorkersMerge
  (``workers_merge.py``, MXNET_KVSTORE_USE_WORKERS_MERGE, default on).
- 1-bit / 2-bit gradient compression with the error-feedback residual
  (≙ ``gradient_compression.h:37-122``), packed on the sync and async
  wires alike.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as _onp
import torch

from .. import telemetry as _telemetry
from ..sparse import RowSparseNDArray

__all__ = ["KVStore", "KVStoreBase", "DistKVStore", "create",
           "register", "GradientCompression", "KVStoreServer"]

_BACKENDS = {}


def register(name):
    def deco(cls):
        _BACKENDS[name] = cls
        return cls
    return deco


def create(name="local", **kwargs):
    """≙ mx.kv.create / KVStore::Create (src/kvstore/kvstore.cc:41)."""
    name = name.lower()
    if name in _BACKENDS:
        return _BACKENDS[name](name, **kwargs)
    if name.startswith("dist"):
        return _BACKENDS["dist"](name, **kwargs)
    raise ValueError(f"unknown kvstore type {name}")


# ------------------------------------------------------ gradient compression
class GradientCompression:
    """1-bit / 2-bit quantization with error feedback.

    ≙ src/kvstore/gradient_compression.{h,cc}: a compressed push adds the
    key's residual to the gradient, quantizes the sum (2-bit: +t at or
    above t, −t at or below −t, else 0; 1-bit: +t at or above 0, else
    −t) and keeps the quantization error as the next residual."""

    def __init__(self, type="2bit", threshold=0.5):
        if type not in ("1bit", "2bit"):
            raise ValueError(f"gradient compression type {type!r}: "
                             f"'1bit' or '2bit'")
        self.type = type
        self.threshold = float(threshold)
        self._residual: Dict[str, torch.Tensor] = {}

    def compress(self, key, g: torch.Tensor) -> torch.Tensor:
        res = self._residual.get(key)
        if res is None or res.shape != g.shape or res.device != g.device:
            res = torch.zeros_like(g)
        acc = g + res
        t = self.threshold
        if self.type == "2bit":
            q = torch.where(acc >= t, t, torch.where(acc <= -t, -t, 0.0))
        else:
            q = torch.where(acc >= 0, t, -t)
        q = q.to(acc.dtype)
        self._residual[key] = acc - q
        return q.to(g.dtype)


class KVStoreBase:
    """Plugin base ≙ python/mxnet/kvstore/base.py:74 (capability registry)."""

    OPTIMIZER = "optimizer"
    PUSHPULL = "pushpull"
    BROADCAST = "broadcast"

    def __init__(self, name="base", **kwargs):
        self.type = name

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def is_capable(self, capability):
        return True

    def barrier(self):
        pass


def _listify(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _sum_list(vals: List[torch.Tensor]) -> torch.Tensor:
    """Reduce of per-device gradient copies (≙ Comm::Reduce comm.h:57), in
    list order, on the first copy's device."""
    out = vals[0]
    for v in vals[1:]:
        out = out + v.to(out.device)
    return out


def _write(targets, value: torch.Tensor):
    """Copy ``value`` into each target tensor (a RowSparseNDArray target
    takes the rows of ``value`` whose entries are not all zero)."""
    with torch.no_grad():
        for t in targets:
            if isinstance(t, RowSparseNDArray):
                rs = RowSparseNDArray.from_dense(value.to(t.data.device))
                t.data, t.indices, t.shape = rs.data, rs.indices, rs.shape
            elif t is not value:
                t.copy_(value)


def _dense(v):
    return v.tostype("default") if isinstance(v, RowSparseNDArray) else v


@register("local")
@register("device")
@register("nccl")
class KVStore(KVStoreBase):
    """Single-process store; ``device`` (≙ the GPU peer-to-peer reduce)
    and ``local`` both sum the list of copies."""

    def __init__(self, name="local", **kwargs):
        super().__init__(name, **kwargs)
        self._store: Dict[str, torch.Tensor] = {}
        self._updater = None
        self._optimizer = None
        self._opt_states: Dict[str, dict] = {}
        self._compression: Optional[GradientCompression] = None

    # -- core ---------------------------------------------------------------
    def init(self, key, value):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        self._store[str(key)] = _dense(value).detach().clone()

    def push(self, key, value, priority=0):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.push(k, v, priority)
            return
        _telemetry.counter_add("kvstore.push_total")
        with _telemetry.timed("kvstore.push_us"), torch.no_grad():
            vals = [_dense(v) for v in _listify(value)]
            k = str(key)
            w = self._store[k]
            agg = _sum_list(vals).to(w.device)
            if self._compression is not None:
                agg = self._compression.compress(k, agg)
            if self._optimizer is not None:
                # update_on_kvstore: run the optimizer inside the store
                # (server-side update semantics, kvstore_dist_server.h:496)
                st = self._opt_states.get(k)
                if st is None:
                    st = self._opt_states[k] = \
                        self._optimizer.create_state(k, w)
                self._optimizer.update(k, w, agg, st)
            elif self._updater is not None:
                self._updater(k, agg, w)
            else:
                w.add_(agg)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if isinstance(key, (list, tuple)):
            for k, o in zip(key, out):
                self.pull(k, o, priority)
            return
        _telemetry.counter_add("kvstore.pull_total")
        with _telemetry.timed("kvstore.pull_us"):
            _write(_listify(out), self._store[str(key)])
        return out

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """≙ KVStore::PullRowSparse (kvstore.h PullRowSparse; dist path
        kvstore_dist.h PullRowSparse_): pull only the rows in ``row_ids``
        (sorted, each once) as a RowSparseNDArray — the embedding-table
        pattern where each worker fetches just the rows its batch
        touches.  A RowSparseNDArray ``out`` takes them; a dense one is
        the table with only those rows."""
        if row_ids is None:
            raise ValueError("row_sparse_pull requires row_ids")
        data = self._store[str(key)]
        rid = torch.unique(torch.as_tensor(row_ids).reshape(-1).long())
        rid = rid.to(data.device)
        result = RowSparseNDArray(data.index_select(0, rid), rid,
                                  tuple(data.shape))
        if out is not None:
            for o in _listify(out):
                if isinstance(o, RowSparseNDArray):
                    o.data, o.indices, o.shape = \
                        result.data, result.indices, result.shape
                else:
                    with torch.no_grad():
                        o.zero_()
                        o.index_copy_(0, rid.to(o.device),
                                      result.data.to(o.device))
        return result

    def pushpull(self, key, value, out=None, priority=0):
        """Aggregate value(s) and write the aggregate to ``out`` (default:
        the values themselves) — the Trainer's gradient-allreduce path
        (≙ KVStoreLocal::PushPull kvstore_local.h:141)."""
        if isinstance(key, (list, tuple)):
            for i, k in enumerate(key):
                self.pushpull(k, value[i], None if out is None else out[i],
                              priority)
            return
        _telemetry.counter_add("kvstore.pushpull_total")
        with _telemetry.timed("kvstore.pushpull_us"), torch.no_grad():
            vals = _listify(value)
            agg = _sum_list([_dense(v) for v in vals])
            if self._compression is not None:
                agg = self._compression.compress(str(key), agg)
            _write(vals if out is None else _listify(out), agg)
        return out

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out, priority)

    # -- optimizer ----------------------------------------------------------
    def set_optimizer(self, optimizer):
        if self._optimizer is not None:
            # re-sent optimizer (e.g. lr change): keep the per-key step
            # counts so Adam/LAMB bias correction doesn't restart
            optimizer._index_update_count = \
                self._optimizer._index_update_count
            optimizer.num_update = self._optimizer.num_update
        self._optimizer = optimizer

    def set_updater(self, updater):
        """``updater(key, grad, weight)`` updates ``weight`` in place."""
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        self._compression = GradientCompression(
            type=compression_params.get("type", "2bit"),
            threshold=float(compression_params.get("threshold", 0.5)))

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The store's optimizer states as an ``.npz``: ``<key>/<state>``
        arrays (no pickle), written to the exact path."""
        arrays = {f"{k}/{n}": t.detach().cpu().numpy()
                  for k, st in self._opt_states.items()
                  for n, t in st.items()}
        with open(fname, "wb") as f:
            _onp.savez(f, **arrays)

    def load_optimizer_states(self, fname):
        """Restore what :meth:`save_optimizer_states` wrote, or the JAX
        package's file (a pickle of ``{key: {state: array}}``, read by an
        unpickler that builds nothing but numpy arrays and containers);
        each state lands on its key's device."""
        with open(fname, "rb") as f:
            zipped = f.read(4) == b"PK\x03\x04"
        states: Dict[str, dict] = {}
        if zipped:
            with _onp.load(fname, allow_pickle=False) as z:
                for name in z.files:
                    k, n = name.rsplit("/", 1)
                    states.setdefault(k, {})[n] = z[name]
        else:
            from ..gluon.trainer import _StatesUnpickler
            with open(fname, "rb") as f:
                blob = _StatesUnpickler(f).load()
            states = {str(k): dict(v) for k, v in blob.items()}
        self._opt_states = {
            k: {n: torch.as_tensor(_onp.asarray(a),
                                   device=self._store[k].device
                                   if k in self._store else "cpu")
                for n, a in st.items()}
            for k, st in states.items()}


@register("dist")
@register("dist_sync")
@register("dist_async")
@register("dist_device_sync")
@register("dist_sync_device")
@register("dist_async_device")
class DistKVStore(KVStore):
    """Multi-process store (see the module docstring).

    - sync modes: one all-reduce over a flat buffer of the whole key list
      (``collective.py``; ≙ kvstore_dist.h:682 PushPullDefault, the
      engine pipelining all key RPCs).
    - dist_async: server-mediated (``ps.py``): every push is applied the
      moment it arrives, no worker barrier (≙ kvstore_dist_server.h:882).
      Requires update_on_kvstore (push grads / pull weights) exactly like
      the reference.
    """

    batched_pushpull = True

    def __init__(self, name="dist_sync", use_workers_merge=None, **kwargs):
        super().__init__(name, **kwargs)
        from ..parallel import dist as _dist
        # None → MXNET_KVSTORE_USE_WORKERS_MERGE decides (default on,
        # ≙ fork behavior); an explicit bool wins (tests / Trainer)
        self._use_workers_merge = use_workers_merge
        self._async = "async" in name
        self._nproc = _dist.size()
        self._rank = _dist.rank()
        self._coll = None
        if self._nproc > 1:
            from .collective import CollectiveAllReduce
            self._coll = CollectiveAllReduce()
        # sync push enters a cross-process collective once per key — every
        # worker must push the same key sequence or the job deadlocks
        # (Trainer pushes zeros for stale grads when this is set)
        self.collective_push = self._coll is not None and not self._async
        self._client = None
        if self._async:
            self._setup_async()

    _async_seq = 0   # per-process instance counter (same order everywhere)

    # -- async (parameter server) ------------------------------------------
    def _setup_async(self):
        """DMLC_NUM_SERVER servers; keys round-robined across them
        (ps.PSGroup ≙ kvstore_dist.h:729).  Standalone DMLC_ROLE=server
        processes (kvstore_server.py, started by the launcher with
        --server-procs, which hands out MXNET_TPU_PS_ADDRS) own the stores
        when the layout provides them; otherwise the first S worker ranks
        each spawn their round-robin slots as subprocesses (rank r owns
        sids ≡ r mod nproc)."""
        import os
        from .ps import PSGroup, num_servers, publish_address, \
            spawn_server_procs
        seq = DistKVStore._async_seq
        DistKVStore._async_seq += 1
        n = num_servers()
        self._server_procs = []
        standalone = bool(os.environ.get("MXNET_TPU_PS_ADDRS")) or \
            os.environ.get("MXNET_TPU_PS_STANDALONE", "") == "1"
        if standalone and not os.environ.get("MXNET_TPU_PS_ADDRS"):
            # a standalone server process publishes into its OWN environ —
            # workers can't see it, so this layout must hand out addresses
            raise RuntimeError(
                "MXNET_TPU_PS_STANDALONE=1 requires MXNET_TPU_PS_ADDRS "
                "(comma list of host:port, one per DMLC_SERVER_ID — "
                "python -m mxnet_tpu_torch.launch --server-procs "
                "assembles it)")
        if not standalone:
            mine = [sid for sid in range(n) if sid % self._nproc == self._rank]
            for sid, (p, addr) in zip(mine, spawn_server_procs(mine, n)):
                publish_address(addr, seq, sid)
                self._server_procs.append(p)
            if self._server_procs:
                import atexit
                atexit.register(self._stop_servers)
        self._client = PSGroup(seq=seq, n=n)
        # WorkersMerge (≙ kvstore_dist.h:84-146): co-located workers
        # funnel pushes through a per-host leader; one combined frame
        # reaches the server per key per round
        from .workers_merge import merge_enabled, setup_workers_merge
        if self._nproc > 1 and merge_enabled(self._use_workers_merge):
            self._client = setup_workers_merge(self._client, seq=seq)

    def _stop_servers(self):
        for p in getattr(self, "_server_procs", []):
            try:
                p.terminate()
            except Exception:
                pass

    def _pack(self, key, agg: torch.Tensor):
        """Compress and pack a gradient for the wire (host side)."""
        if self._compression is None:
            return ("raw", agg.detach().cpu().numpy())
        from .ps import pack_1bit, pack_2bit
        q = self._compression.compress(str(key), agg)
        qh = q.detach().cpu().numpy()
        if self._compression.type == "2bit":
            return ("2bit",) + pack_2bit(qh, self._compression.threshold)
        return ("1bit",) + pack_1bit(qh, self._compression.threshold)

    # -- identity -----------------------------------------------------------
    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._nproc

    def _global_sum(self, x):
        return x if self._coll is None else self._coll.sum(x)

    def set_gradient_compression(self, compression_params):
        super().set_gradient_compression(compression_params)
        if self._client is not None:
            # big-array slicing and wire compression are mutually
            # exclusive (packed codes can't be resliced per server);
            # compression must be configured before any key is init'd
            if self._client._shapes:
                raise RuntimeError(
                    "set_gradient_compression must be called before init: "
                    f"keys {sorted(self._client._shapes)} are already "
                    "sliced across servers")
            self._client._slice_big = False

    def sync_live_mask(self, mask):
        """Element-wise sum of a small host vector across workers (one tiny
        collective).  Lets Trainer agree on which gradients are live
        anywhere before entering the per-key collective push — keys stale
        on EVERY rank can then be skipped symmetrically (reference
        semantics: untouched params don't drift through zero-grad updates),
        while mixed keys get zero contributions from stale ranks."""
        m = _onp.asarray(mask, _onp.float32)
        return m if self._coll is None else self._coll.sum_host(m)

    # -- data path ----------------------------------------------------------
    def init(self, key, value):
        super().init(key, value)
        if self._async and isinstance(key, (int, str)):
            self._client.init(key, _dense(value).detach().cpu().numpy())

    def pushpull(self, key, value, out=None, priority=0):
        if self._async:
            raise RuntimeError(
                "dist_async has no gradient-aggregate pushpull — the server "
                "applies each push immediately (kvstore_dist_server.h:882); "
                "use update_on_kvstore=True (push grads, pull weights)")
        keys = key if isinstance(key, (list, tuple)) else [key]
        values = value if isinstance(key, (list, tuple)) else [value]
        outs = out if isinstance(key, (list, tuple)) else \
            (None if out is None else [out])
        _telemetry.counter_add("kvstore.pushpull_total")
        with _telemetry.timed("kvstore.pushpull_us"), torch.no_grad():
            aggs, packable = [], []
            for i, (k, v) in enumerate(zip(keys, values)):
                agg = _sum_list([_dense(x) for x in _listify(v)])
                if self._compression is not None and \
                        agg.is_floating_point():
                    agg = self._compression.compress(str(k), agg)
                    packable.append(i)
                aggs.append(agg)
            if self._coll is not None:
                if self._compression is not None and packable:
                    # compressed sync wire: each worker's quantized codes
                    # cross PACKED and every peer unpacks and sums them —
                    # ≙ the reference's compressed push + server-side
                    # decompress-sum (kvstore_dist_server.h:867)
                    bits = 2 if self._compression.type == "2bit" else 1
                    thr = self._compression.threshold
                    summed = self._coll.sum_packed(
                        [aggs[i] for i in packable], [thr] * len(packable),
                        bits)
                    for i, s in zip(packable, summed):
                        aggs[i] = s
                    rest = sorted(set(range(len(aggs))) - set(packable))
                    if rest:
                        rsum = self._coll.sum_batch([aggs[i] for i in rest])
                        for i, s in zip(rest, rsum):
                            aggs[i] = s
                else:
                    aggs = self._coll.sum_batch(aggs)   # ONE reduce
            for i in range(len(keys)):
                o = outs[i] if outs is not None else None
                _write(_listify(values[i]) if o is None else _listify(o),
                       aggs[i])
        return out

    def push(self, key, value, priority=0):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.push(k, v, priority)
            return
        agg = _sum_list([_dense(v) for v in _listify(value)])
        if self._async:
            # worker-local aggregate goes to the server as-is; the server
            # applies it immediately — no cross-worker aggregation
            self._client.push(key, self._pack(key, agg))
            return
        super().push(key, self._global_sum(agg), priority)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if self._async and not isinstance(key, (list, tuple)):
            data = torch.from_numpy(self._client.pull(key))
            _write(_listify(out), data)
            return out
        return super().pull(key, out, priority, ignore_sparse)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        if self._async and not isinstance(key, (list, tuple)):
            # refresh the local mirror from the server first — async
            # pushes bypass the local store entirely
            k = str(key)
            fresh = torch.from_numpy(self._client.pull(key))
            self._store[k] = fresh.to(self._store[k].device) \
                if k in self._store else fresh
        return super().row_sparse_pull(key, out, priority, row_ids)

    def set_optimizer(self, optimizer):
        if self._async:
            # the config goes to the server ≙ kSetOptimizer command
            # (kvstore_dist_server.h:232); rank 0's copy wins
            if self._rank == 0:
                self._client.set_optimizer(optimizer)
            # barrier ONLY on the first send (during trainer init, which is
            # naturally collective) so the server has an optimizer before
            # any worker pushes.  Re-sends (e.g. Trainer.set_learning_rate
            # on one rank mid-run) must NOT barrier: ranks change lr at
            # different steps and a barrier here deadlocks the job; async
            # mode's contract is eventual application anyway.
            if not getattr(self, "_opt_sent", False):
                self._opt_sent = True
                self.barrier()
            return
        super().set_optimizer(optimizer)

    def barrier(self):
        if self._nproc > 1:
            from ..parallel import dist as _dist
            _dist.barrier("kvstore_barrier")


# plugin backends + server role (imported last: they register themselves)
from . import p3 as _p3              # noqa: E402,F401  P3StoreDist ('p3')
from . import horovod as _horovod    # noqa: E402,F401  ('horovod', gated)
from . import byteps as _byteps      # noqa: E402,F401  ('byteps', gated)
from . import kvstore_server         # noqa: E402,F401  server-role loop
from .kvstore_server import KVStoreServer  # noqa: E402,F401
