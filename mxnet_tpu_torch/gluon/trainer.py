"""gluon.Trainer (≙ ``mxnet_tpu/gluon/trainer.py``).

``Trainer(net.collect_params(), "sgd", {...})`` trains the parameters
that take gradients: the ``nn.Parameter``s with ``requires_grad``.  The
running statistics are buffers and are left out, as the reference marks
them ``grad_req="null"``.  ``step(batch_size)`` sets the optimizer's
``rescale_grad`` to ``1 / batch_size`` and applies one multi-tensor
update of every parameter that has a gradient; a ``row_sparse``
parameter (``Embedding(sparse_grad=True)``) takes the optimizer's lazy
update of the rows its gradient touches first (``_update``).

Gradients follow the reference's ``grad_req="write"``: a step consumes
them.  PyTorch accumulates into ``.grad``, so ``step`` clears each
gradient it used (sets it to None); the next ``backward`` writes a fresh
one.  A step that finds a parameter without a fresh gradient raises
``UserWarning``, as the reference does, unless ``ignore_stale_grad``.

``kvstore`` is a store name or a ``kvstore`` object (≙ the reference's
``_init_kvstore``, trainer.py:195).  ``step`` reduces the gradients
through it (``allreduce_grads``: one batched ``pushpull`` of every live
gradient for the dist stores, into the gradients in place), then
updates; a one-process ``device`` / ``local`` store without compression
has nothing to reduce and is skipped.  The collective stores agree first
on which gradients are live on some rank (``sync_live_mask``): a key
stale on one rank takes zeros there, so every rank enters the same
collectives and applies the same update.  With ``update_on_kvstore``
(the default for ``dist_async``, which requires it) the store runs the
optimizer: ``step`` pushes each gradient, scaled by ``1 / batch_size``,
and pulls the updated weight back (``_step_on_kvstore``), and the first
step sends the store a copy of the optimizer with ``rescale_grad`` 1.
``dist`` stores enable WorkersMerge as ``MXNET_KVSTORE_USE_WORKERS_MERGE``
says (default on).  ``compression_params`` go to the store.

``fuse_step(loss_fn)`` returns the whole-step executor
(``parallel.TrainerFusedStep``): forward, loss, backward and update as
one captured CUDA graph a step, sharing this Trainer's state.  The
optimizer's arguments (``lr_scheduler``, ``clip_gradient``, ...) pass
through ``optimizer_params``.

``export_checkpoint_state`` / ``import_checkpoint_state`` are the tree
``checkpoint.CheckpointManager.save_trainer`` / ``restore_trainer``
carry, under the reference's keys: ``params/<name>`` (running
statistics included), ``states/<name>/<key>`` (the optimizer's state
names, which are the reference's), and, once a fused step has run,
``ctl/t`` (int32, the step count) and ``ctl/generators/<i>`` (the
states of the ``torch.Generator`` s the captured step draws from:
Dropout's, SGLD's).  A reference checkpoint's ``ctl/rng`` (a JAX key)
has no torch counterpart and is skipped with a warning.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import warnings
import weakref
from typing import Dict, List

import numpy as np
import torch

from .. import kvstore as kvs
from .. import optimizer as opt_mod
from ..sparse import RowSparseNDArray
from .parameter import _pending_device, _spec, assign, is_initialized

__all__ = ["Trainer"]


class Trainer:
    """≙ ``gluon.Trainer``."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, mesh=None, sharding_plan=None):
        if mesh is not None or sharding_plan is not None:
            raise NotImplementedError(
                "Trainer(mesh=, sharding_plan=): sharded training belongs "
                "to the tensor-parallel slice of the port (item 7 of its "
                "queue of modules), not ported yet")
        # collect_params() stamps a weak reference to its block on the
        # dict: fuse_step finds the net by it
        self._net = getattr(params, "_block_ref", None)
        kv_type = kvstore.lower() if isinstance(kvstore, str) else \
            getattr(kvstore, "type", "")
        if update_on_kvstore is None:
            # ≙ trainer.py _init_kvstore defaults: async stores REQUIRE
            # server-side updates (there is no gradient aggregate to apply
            # locally); sync stores use the local multi-tensor update
            update_on_kvstore = "async" in kv_type
        elif not update_on_kvstore and "async" in kv_type:
            # refused before a named store (and its server) is made
            raise ValueError(
                "dist_async requires update_on_kvstore=True (the server "
                "applies each push immediately, kvstore_dist_server.h:882)")
        if isinstance(kvstore, str):
            kw = {}
            if kv_type.startswith("dist"):
                # WorkersMerge default-on for dist stores (≙ fork
                # behavior); MXNET_KVSTORE_USE_WORKERS_MERGE=0 opts out
                from ..kvstore.workers_merge import merge_enabled
                kw["use_workers_merge"] = merge_enabled()
            kvstore = kvs.create(kvstore, **kw)
        self._kvstore = kvstore
        self._update_on_kvstore = bool(update_on_kvstore) and \
            kvstore is not None
        if compression_params is not None and kvstore is not None:
            kvstore.set_gradient_compression(compression_params)
        self._kv_initialized = False
        items = list(params.items()) if isinstance(params, dict) else \
            [(str(i), p) for i, p in enumerate(params)]
        self._items = items         # parameters and running statistics
        self._trainable = [(n, p) for n, p in items
                           if isinstance(p, torch.nn.Parameter) and
                           p.requires_grad]
        self._optimizer = opt_mod.create(optimizer,
                                         **(optimizer_params or {}))
        self._states: Dict[str, dict] = {}
        self._scale = 1.0
        # the fused executors sharing this trainer's state, held weakly:
        # load_states resyncs them
        self._fused_execs: List[weakref.ref] = []
        # generator states of a restored checkpoint's ctl, for a fused
        # executor built after the restore
        self._restored_generators = None

    # -- properties -----------------------------------------------------
    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)
        if self._update_on_kvstore and self._kv_initialized:
            # the store holds its own optimizer copy — re-send so the lr
            # change is not silently ignored (per-key step counts are
            # preserved by set_optimizer on the store/server side)
            self._kvstore.set_optimizer(self._store_optimizer())

    # -- kvstore --------------------------------------------------------
    def _store_optimizer(self):
        """The store's copy of the optimizer: ``rescale_grad`` 1.0, as the
        workers scale gradients before pushing (the scale may change per
        step, the store's copy cannot)."""
        import copy
        opt = copy.copy(self._optimizer)
        opt.rescale_grad = 1.0
        return opt

    def _init_kvstore(self):
        """≙ trainer.py:195 _init_kvstore for the update_on_kvstore path:
        register every parameter under its index and send the store its
        optimizer."""
        if self._kv_initialized or self._kvstore is None:
            return
        for i, (name, p) in enumerate(self._trainable):
            self._kvstore.init(i, p.detach())
        self._kvstore.set_optimizer(self._store_optimizer())
        self._kv_initialized = True

    def _reduces(self) -> bool:
        """Whether ``allreduce_grads`` has work: any store but a
        one-process local one without compression (whose pushpull of a
        single copy is that copy)."""
        kv = self._kvstore
        if kv is None:
            return False
        if type(kv) is kvs.KVStore and kv.num_workers == 1:
            return kv._compression is not None
        return True

    def _collective_live_counts(self, local_live):
        """Per-key count of workers holding a fresh gradient (ONE tiny
        mask all-reduce), or None when the store isn't collective.

        Collective stores enter a cross-process reduce per key, so every
        rank must agree on the key list: keys live on SOME rank get zero
        contributions from stale ranks, keys stale EVERYWHERE are skipped
        symmetrically, and any stale-grad error must be raised from these
        shared counts (a local raise on one rank strands its peers in the
        next collective)."""
        if not getattr(self._kvstore, "collective_push", False):
            return None
        return self._kvstore.sync_live_mask(
            np.array(local_live, dtype=np.float32))

    def _allreduce_grads(self):
        """≙ trainer.py:392: pushpull the live gradients, in place.
        Stores advertising ``batched_pushpull`` (the dist stores) take the
        whole set in ONE call, one all-reduce over a flat buffer; the
        others one pushpull a key with priority −i (P3 inside its
        ``batch()`` window, drained highest priority first)."""
        if not self._reduces():
            return
        kv = self._kvstore
        live, local_live = [], []
        for i, (name, p) in enumerate(self._trainable):
            local_live.append(is_initialized(p) and p.grad is not None)
            if local_live[-1]:
                live.append((i, p))
        counts = self._collective_live_counts(local_live)
        if counts is not None:
            # zero-fill stale-here/live-elsewhere keys; the reduced grad is
            # written into the stale rank's gradient too, so every rank's
            # _update applies the SAME update and replicas stay
            # bit-identical
            have = {i for i, _ in live}
            for i, (name, p) in enumerate(self._trainable):
                if counts[i] > 0 and i not in have and is_initialized(p):
                    p.grad = torch.zeros_like(p)
                    live.append((i, p))
            live.sort(key=lambda t: t[0])
        if not live:
            return
        if getattr(kv, "batched_pushpull", False):
            gs = [p.grad for _, p in live]
            kv.pushpull([i for i, _ in live], gs, out=gs)
            return
        batch = getattr(kv, "batch", None)
        with (batch() if batch is not None else contextlib.nullcontext()):
            for i, p in live:
                kv.pushpull(i, p.grad, out=p.grad, priority=-i)

    def _step_on_kvstore(self, ignore_stale_grad=False):
        """update_on_kvstore data path: push scaled grads, pull back the
        store-updated weights (≙ trainer.py _update when
        update_on_kvstore; dist_async's server applies each push)."""
        self._init_kvstore()
        kv = self._kvstore
        scale = self._optimizer.rescale_grad
        collective = getattr(kv, "collective_push", False)
        entries = []
        for i, (name, p) in enumerate(self._trainable):
            live = is_initialized(p) and p.grad is not None
            if (not live and not ignore_stale_grad and not collective
                    and is_initialized(p)):
                raise UserWarning(
                    f"Gradient of Parameter `{name}` has not been "
                    "updated by backward since last step")
            entries.append((i, p, live))
        live_anywhere = None
        counts = self._collective_live_counts(
            [live for _, _, live in entries]) if collective else None
        if counts is not None:
            if not ignore_stale_grad:
                nproc = kv.num_workers
                for idx, (i, p, _) in enumerate(entries):
                    if is_initialized(p) and counts[idx] < nproc:
                        raise UserWarning(
                            f"Gradient of Parameter "
                            f"`{self._trainable[idx][0]}` has not been "
                            "updated by backward since last step (on at "
                            "least one worker)")
            live_anywhere = counts > 0
        pushed = []
        for idx, (i, p, live) in enumerate(entries):
            if not live:
                if (live_anywhere is not None and live_anywhere[idx]
                        and is_initialized(p)):
                    kv.push(i, torch.zeros_like(p), priority=-i)
                    pushed.append((i, p, False))
                continue
            g = p.grad if scale == 1.0 else p.grad * scale
            kv.push(i, g, priority=-i)
            pushed.append((i, p, True))
        for i, p, live in pushed:
            kv.pull(i, out=p.data, priority=-i)
            if live:
                p.grad = None       # consumed; the next backward writes
        store_opt = getattr(kv, "_optimizer", None)
        if store_opt is not None:
            # an in-process store updated with its copy of the optimizer
            # (which shares the per-key counts): the step count follows
            self._optimizer.num_update = max(self._optimizer.num_update,
                                             store_opt.num_update)

    # -- step -----------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by ``1 / batch_size``, reduce them through the
        store and update every parameter that has one (or, with
        ``update_on_kvstore``, push them and pull the store's weights);
        the gradients are consumed."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._update_on_kvstore:
            self._step_on_kvstore(ignore_stale_grad)
            return
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """≙ ``Trainer.allreduce_grads``: reduce the gradients through the
        store, in place (nothing to do for a one-process local store);
        the Gluon idiom ``allreduce_grads(); ...; update(bs)`` is then
        :meth:`step`."""
        self._allreduce_grads()

    def update(self, batch_size, ignore_stale_grad=False):
        """As :meth:`step` without the reduction (:meth:`allreduce_grads`
        does it).  Not with ``update_on_kvstore``, where the store
        updates: use :meth:`step`."""
        if self._update_on_kvstore:
            raise ValueError(
                "update() when parameters are updated on the kvstore is not "
                "supported: use step(), or update_on_kvstore=False")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def shard_batch(self, *arrays):
        """≙ ``Trainer.shard_batch``: with no mesh (the only kind this
        Trainer takes) the arrays as given, one unwrapped."""
        return arrays if len(arrays) > 1 else arrays[0]

    def fuse_step(self, loss_fn, net=None):
        """The whole-step executor (``parallel.TrainerFusedStep``)::

            step = trainer.fuse_step(loss_fn)
            for x, y in batches:
                loss = step(x, y)      # one CUDA-graph replay on the card

        ``net`` defaults to the block this Trainer's parameters were
        collected from.  The executor shares this Trainer's optimizer,
        states and parameters, so fused and legacy steps interleave.
        Where fusing does not apply it runs the legacy
        record/backward/step path (``executor.fallback_reason``, the
        ``fused.fallback.*`` counters)."""
        from ..parallel.train import TrainerFusedStep
        if net is None and self._net is not None:
            net = self._net()
        ex = TrainerFusedStep(self, loss_fn, net)
        self._fused_execs.append(weakref.ref(ex))
        return ex

    def _live_fused(self):
        live, refs = [], []
        for r in self._fused_execs:
            ex = r()
            if ex is not None:
                live.append(ex)
                refs.append(r)
        self._fused_execs = refs
        return live

    def _resync_fused(self):
        """Hand every live fused executor the states just loaded (and the
        generators' states a checkpoint restored)."""
        for ex in self._live_fused():
            ex.resync()
            if self._restored_generators is not None:
                ex.resync_ctl(self._restored_generators)

    def _update(self, ignore_stale_grad=False):
        """One multi-tensor update of the parameters with a gradient.

        A parameter marked ``grad_stype = "row_sparse"``
        (``Embedding(sparse_grad=True)``) goes first through the
        optimizer's single-key ``update`` on a ``RowSparseNDArray`` of the
        rows whose dense gradient has a non-zero entry (≙ the reference's
        Trainer): its lazy rule leaves the other rows and their states as
        they were.  Finding those rows waits for the card once a step
        (``nonzero``), as the reference fetches its row mask to the host.
        That update advances ``num_update`` through the key's own count,
        so the dense parameters' update then does not advance it again:
        the step is counted once, and a sparse key whose count lags
        leaves them at the step count of the step before, as in the
        reference."""
        live, sparse = [], []
        for name, p in self._trainable:
            if not is_initialized(p):
                continue            # deferred: no forward has run yet
            if p.grad is None:
                if not ignore_stale_grad:
                    raise UserWarning(
                        f"Gradient of Parameter `{name}` has not been "
                        f"updated by backward since last step")
                continue
            row_sparse = getattr(p, "grad_stype", "default") == "row_sparse"
            (sparse if row_sparse else live).append((name, p))
        for name, p in sparse + live:
            if name not in self._states:
                self._states[name] = self._optimizer.create_state(name, p)
        for name, p in sparse:
            self._optimizer.update(name, p.data,
                                   RowSparseNDArray.from_dense(p.grad),
                                   self._states[name])
            p.grad = None           # consumed; the next backward writes
        if not live:
            return
        self._optimizer.update_multi(
            [n for n, _ in live], [p.data for _, p in live],
            [p.grad for _, p in live], [self._states[n] for n, _ in live],
            advance=not sparse)
        for _, p in live:
            p.grad = None

    # -- state io -------------------------------------------------------
    def export_checkpoint_state(self):
        """``(tree, meta)`` of everything a resumed run needs: the
        parameters and running statistics, the optimizer states, and a
        live fused executor's control block (``ctl/t``, its generators'
        states).  Leaves are the live tensors: ``CheckpointManager.save``
        copies them at the step boundary before the next step."""
        tree: dict = {"params": {}, "states": {}}
        for n, t in self._items:
            if is_initialized(t):
                tree["params"][n] = t.detach()
        for k, v in self._states.items():
            tree["states"][k] = v
        for ex in self._live_fused():
            ctl = ex.export_ctl()
            if ctl is not None:
                tree["ctl"] = ctl
                break
        meta = {"num_update": int(self._optimizer.num_update),
                "lr": float(self._optimizer.learning_rate)}
        return tree, meta

    def import_checkpoint_state(self, tree, meta=None):
        """Inverse of :meth:`export_checkpoint_state` from host leaves
        (this package's checkpoint or the JAX package's): parameters and
        running statistics are copied in place (a deferred one takes the
        stored shape), so a live fused executor keeps its graph; states
        are copied into the tensors that hold them where shapes agree;
        ``num_update`` and the learning rate (without a scheduler) are
        restored; every live fused executor resyncs its states and
        generators, and one built later takes the restored generators."""
        meta = dict(meta or {})
        net = self._net() if self._net is not None else None
        byname = dict(self._items)
        for n, a in (tree.get("params") or {}).items():
            t = byname.get(n)
            if t is None:
                continue
            if net is None:
                assign(t, a, name=n)
            else:
                assign(t, a, _spec(net, n), n, _pending_device(net, n))
        states: Dict[str, dict] = {}
        with torch.no_grad():
            for k, st in (tree.get("states") or {}).items():
                dev = byname[k].device if k in byname else "cpu"
                cur = self._states.get(k) or {}
                new = {}
                for sk, v in st.items():
                    src = v if isinstance(v, torch.Tensor) else \
                        torch.as_tensor(np.asarray(v))
                    held = cur.get(sk)
                    if held is not None and held.shape == src.shape:
                        held.copy_(src)
                        new[sk] = held
                    else:
                        new[sk] = src.to(dev).clone()
                states[k] = new
        self._states = states
        if "num_update" in meta:
            self._optimizer.num_update = int(meta["num_update"])
        if meta.get("lr") is not None and \
                getattr(self._optimizer, "lr_scheduler", None) is None:
            self._optimizer.set_learning_rate(float(meta["lr"]))
        ctl = tree.get("ctl") or {}
        if "rng" in ctl:
            warnings.warn(
                "checkpoint ctl/rng is a JAX PRNG key, which no torch "
                "generator can continue: skipped (the fused step's "
                "generators keep their own streams)", UserWarning)
        gens = ctl.get("generators")
        self._restored_generators = None if not gens else [
            torch.as_tensor(np.asarray(gens[k]), dtype=torch.uint8)
            for k in sorted(gens, key=int)]
        self._resync_fused()

    def save_states(self, fname):
        """The optimizer's states and step counts to ``fname`` as an
        ``.npz`` (written to the exact path, atomically)."""
        opt = self._optimizer
        meta = {"num_update": opt.num_update,
                "index_update_count": opt._index_update_count}
        arrays = {"meta": np.array(json.dumps(meta))}
        for name, st in self._states.items():
            for k, t in st.items():
                arrays[f"state/{name}/{k}"] = t.detach().cpu().numpy()
        tmp = f"{fname}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)

    def load_states(self, fname):
        """Restore the optimizer's states and step count from ``fname``:
        an ``.npz`` that :meth:`save_states` wrote, or the JAX package's
        file (a pickle of ``{"num_update", "states"}``, read by
        :func:`_read_reference_states`).  Each state lands on its
        parameter's device."""
        with open(fname, "rb") as f:
            zipped = f.read(4) == b"PK\x03\x04"
        if not zipped:
            self._load_reference_states(_read_reference_states(fname))
            return
        byname = dict(self._trainable)
        states: Dict[str, dict] = {}
        with np.load(fname, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            for key in z.files:
                if not key.startswith("state/"):
                    continue
                name, k = key[len("state/"):].rsplit("/", 1)
                dev = byname[name].device if name in byname else "cpu"
                states.setdefault(name, {})[k] = torch.as_tensor(
                    z[key], device=dev)
        self._states = states
        self._optimizer.num_update = int(meta["num_update"])
        self._optimizer._index_update_count = {
            str(k): int(v) for k, v in meta["index_update_count"].items()}
        self._resync_fused()

    def _load_reference_states(self, blob):
        byname = dict(self._trainable)
        states: Dict[str, dict] = {}
        for name, st in blob["states"].items():
            if not isinstance(st, dict):
                raise ValueError(f"{name}: optimizer state {type(st)} is "
                                 f"not a dict of arrays")
            dev = byname[name].device if name in byname else "cpu"
            states[name] = {k: torch.as_tensor(np.asarray(v), device=dev)
                            for k, v in st.items()}
        self._states = states
        self._optimizer.num_update = int(blob["num_update"])
        self._resync_fused()


# the globals a pickle of numpy arrays names (numpy 1.x and 2.x module
# paths; protocol 5 rebuilds an array from a buffer with _frombuffer)
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}


class _StatesUnpickler(pickle.Unpickler):
    """Admits numpy arrays, dicts, tuples, lists and plain scalars: every
    other global a pickle names is refused."""

    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{module}.{name} is not allowed in an optimizer-states file")


def _read_reference_states(fname):
    """The JAX package's ``Trainer.save_states`` file, through an
    unpickler that builds nothing but numpy arrays and containers."""
    fmt = ("neither this package's .npz nor the JAX package's pickle of "
           "{'num_update': int, 'states': {name: {key: numpy array}}}")
    try:
        with open(fname, "rb") as f:
            blob = _StatesUnpickler(f).load()
    except Exception as e:
        raise ValueError(f"{fname}: {fmt} ({type(e).__name__}: {e})") \
            from None
    if not (isinstance(blob, dict) and "num_update" in blob and
            isinstance(blob.get("states"), dict)):
        raise ValueError(f"{fname}: {fmt}")
    return blob
