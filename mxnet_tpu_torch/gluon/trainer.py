"""gluon.Trainer (≙ ``mxnet_tpu/gluon/trainer.py``), single process.

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

Only the single-process stores are ported: ``kvstore`` None, "device" or
"local" reduce nothing (one process holds every gradient).

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

import json
import os
import pickle
import warnings
import weakref
from typing import Dict, List

import numpy as np
import torch

from .. import optimizer as opt_mod
from ..sparse import RowSparseNDArray
from .parameter import _pending_device, _spec, assign, is_initialized

__all__ = ["Trainer"]

_LOCAL_STORES = (None, "device", "local")


class Trainer:
    """≙ ``gluon.Trainer`` for one process."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, mesh=None, sharding_plan=None):
        if mesh is not None or sharding_plan is not None:
            raise NotImplementedError(
                "Trainer(mesh=, sharding_plan=): sharded training belongs "
                "to the tensor-parallel slice of the port (item 7 of its "
                "queue of modules), not ported yet")
        if not (kvstore in _LOCAL_STORES):
            raise NotImplementedError(
                f"kvstore={kvstore!r}: only the single-process stores "
                f"(None, 'device', 'local') are ported; distributed "
                f"kvstores belong to the host-planes slice of the port")
        if update_on_kvstore:
            raise NotImplementedError(
                "update_on_kvstore=True: updates on a (distributed) "
                "kvstore belong to the host-planes slice of the port")
        if compression_params is not None:
            raise NotImplementedError(
                "compression_params: gradient compression belongs to the "
                "host-planes slice of the port")
        # collect_params() stamps a weak reference to its block on the
        # dict: fuse_step finds the net by it
        self._net = getattr(params, "_block_ref", None)
        self._kvstore = kvstore
        self._update_on_kvstore = bool(update_on_kvstore)
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

    # -- step -----------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by ``1 / batch_size`` and update every
        parameter that has one; the gradients are consumed."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """≙ ``Trainer.allreduce_grads``: reduce the gradients across the
        store's devices.  One process holding every gradient on a local
        store has nothing to reduce, so the gradients stay as they are;
        the Gluon idiom ``allreduce_grads(); ...; update(bs)`` is then
        :meth:`step`."""

    def update(self, batch_size, ignore_stale_grad=False):
        """As :meth:`step` without the reduction (:meth:`allreduce_grads`,
        which reduces nothing here)."""
        self.step(batch_size, ignore_stale_grad)

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
