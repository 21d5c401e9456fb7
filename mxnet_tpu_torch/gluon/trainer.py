"""gluon.Trainer (≙ ``mxnet_tpu/gluon/trainer.py``), single process.

``Trainer(net.collect_params(), "sgd", {...})`` trains the parameters
that take gradients: the ``nn.Parameter``s with ``requires_grad``.  The
running statistics are buffers and are left out, as the reference marks
them ``grad_req="null"``.  ``step(batch_size)`` sets the optimizer's
``rescale_grad`` to ``1 / batch_size`` and applies one multi-tensor
update of every parameter that has a gradient.

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
"""
from __future__ import annotations

import json
import os
import pickle
import weakref
from typing import Dict, List

import numpy as np
import torch

from .. import optimizer as opt_mod
from .parameter import is_initialized

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
        """Hand every live fused executor the states just loaded."""
        for ex in self._live_fused():
            ex.resync()

    def _update(self, ignore_stale_grad=False):
        live = []
        for name, p in self._trainable:
            if not is_initialized(p):
                continue            # deferred: no forward has run yet
            if p.grad is None:
                if not ignore_stale_grad:
                    raise UserWarning(
                        f"Gradient of Parameter `{name}` has not been "
                        f"updated by backward since last step")
                continue
            live.append((name, p))
        if not live:
            return
        for name, p in live:
            if name not in self._states:
                self._states[name] = self._optimizer.create_state(name, p)
        self._optimizer.update_multi(
            [n for n, _ in live], [p.data for _, p in live],
            [p.grad for _, p in live], [self._states[n] for n, _ in live])
        for _, p in live:
            p.grad = None           # consumed; the next backward writes

    # -- state io -------------------------------------------------------
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
