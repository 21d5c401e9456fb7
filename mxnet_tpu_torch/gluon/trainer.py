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
"""
from __future__ import annotations

import json
import os
from typing import Dict

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
                "to the tensor-parallel slice of the port, not ported yet")
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
        items = list(params.items()) if isinstance(params, dict) else \
            [(str(i), p) for i, p in enumerate(params)]
        self._trainable = [(n, p) for n, p in items
                           if isinstance(p, torch.nn.Parameter) and
                           p.requires_grad]
        self._optimizer = opt_mod.create(optimizer,
                                         **(optimizer_params or {}))
        self._states: Dict[str, dict] = {}
        self._scale = 1.0

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

    def update(self, batch_size, ignore_stale_grad=False):
        """As :meth:`step` (there is no reduction to leave out)."""
        self.step(batch_size, ignore_stale_grad)

    def fuse_step(self, loss_fn, net=None):
        raise NotImplementedError(
            "Trainer.fuse_step (FusedTrainStep, one captured program per "
            "step) is not ported yet; it is queued as one captured CUDA "
            "graph")

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
        """Restore what :meth:`save_states` wrote; each state lands on its
        parameter's device."""
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
