"""The fused training step: forward, loss, backward and the optimizer
update of one step as ONE captured CUDA graph (≙
``mxnet_tpu/parallel/train.py``: ``FusedTrainStep`` :114-321 and
``TrainerFusedStep`` :324-710, which compile the same step into one
donated XLA program).  The mesh, sharding and collective parts of the
reference are not ported.

**The step function** (:meth:`_Step._body`) runs the forward in
training mode under ``autograd.record()`` (BatchNorm on batch
statistics, writing its running statistics in place), the loss, the
gradients of the loss with ``torch.autograd.grad`` (not accumulated
into ``.grad``; a frozen parameter gets none, a trainable one the
forward does not use gets zeros), then the optimizer's rule in place
(``Optimizer.rule``, which reads the step's learning rate and
step-count terms from the optimizer's control tensor), and writes the
mean loss into a static output.

**On the card** the first call for a key ``(input shapes and dtypes,
device, optimizer._fused_sig())`` warms the step up eagerly on a side
stream (the kernels are built at first launch, each conv's plan is fixed
and the kernels' attributes are set), puts back every parameter, buffer,
optimizer state and generator the warm-up changed, and captures the
step with ``torch.cuda.graph`` into one ``CUDAGraph`` (the garbage
collector off and other threads' calls left out of the capture's
checks; see :meth:`_Step._build`).  Every call,
that first one included, then fills the control tensor and the static
inputs and calls ``replay()``: one graph launch a step.  A new key
captures a new graph, counted as ``fused.rebuilds``, as the reference
re-jits when its signature changes; each key keeps its graph.

**On the CPU** the same step function runs directly, since a CUDA
graph does not exist there: this is the CPU leg of the same step, not a
fallback, and the tests hold it against the legacy path and the JAX
package.

**Kernel launch counts.**  A kernel wrapper's ``fn.launches`` counts
the calls Python makes to it: at warm-up (real launches) and at capture
(launches recorded into the graph, not run).  A replay runs exactly
what was captured without calling Python.  So each graph records the
count of each wrapper during its capture (``launches_per_step``; a
wrapper's bf16 instance also under ``<name>_bf16``) and its replays; an
executor's ``replayed_launches()`` is the launches the replays made,
replays × ``launches_per_step``.

The graph holds the parameters', buffers' and states' storage as it
found them: the optimizer updates them in place, as the legacy path
does, so fused and legacy steps interleave; a state that
``Trainer.load_states`` replaces is copied back into the captured one
(:meth:`_Step.resync`).  ``Block.cast`` and ``reset_ctx`` give the
parameters new storage, which a graph does not follow: after either,
the next call finds the storage moved
(``gluon.parameter.storage_epoch``), drops its graphs and captures
anew (counted as ``fused.rebuilds``).

**Mixed precision** (``FusedTrainStep(dtype="bfloat16",
grad_scale=...)``, ≙ the reference's ``cast_low`` / ``cast_frozen``):
the master weights and the optimizer states stay fp32; inside the step
every floating parameter and buffer but the BatchNorm running statistics
is cast to ``dtype`` and the forward runs on the casts
(``torch.func.functional_call``), the batch is cast to ``dtype`` on the
card (integer batches too, as the reference casts them), the outputs
are cast to fp32 before the loss, the loss is scaled by ``grad_scale``
and the gradients unscaled, and each gradient reaches its fp32 master
through the cast.
"""
from __future__ import annotations

import gc
import os
import sys
from typing import Callable, Dict, Optional

import torch

from .. import autograd
from .. import telemetry as _telemetry
from ..gluon import nn as _gnn
from ..gluon.block import HybridBlock
from ..gluon.parameter import as_dtype, is_initialized, storage_epoch

__all__ = ["FusedTrainStep", "TrainerFusedStep", "kernel_wrappers"]


def kernel_wrappers() -> Dict[str, Callable]:
    """The port's hand-written kernel wrappers by name, each with its
    ``launches`` count."""
    from ..ops import (conv_block, cuda_attention, cuda_int8, cuda_kernels,
                       flash_attention)
    fns = (conv_block.conv3x3, conv_block.conv_stats, conv_block.bn_affine,
           conv_block.conv_wgrad, conv_block.conv_affine,
           cuda_kernels.softmax_fused, cuda_kernels.layernorm_fused,
           flash_attention.attention_fwd, flash_attention.attention_dq,
           flash_attention.attention_dkv, cuda_attention.causal_attention,
           cuda_int8.qconv3x3_affine)
    return {fn.__name__: fn for fn in fns}


def _counts():
    """Each wrapper's launches by name, each half dtype's instance's
    (also counted in the former) as ``<name>_<half>`` (``_bf16``,
    ``_fp16``: ``conv_block.HALF_NAMES``, the one table of half dtypes)
    and, where a half dtype has several kernels (the four conv wrappers),
    each one's as ``<name>_<half>_<kernel>`` (``conv_stats_fp16_wgmma``,
    ``conv_stats_fp16_mma_sync``; ``<name>_<half>`` is their sum)."""
    from ..ops.conv_block import HALF_NAMES
    out = {}
    for n, fn in kernel_wrappers().items():
        out[n] = fn.launches
        by_dtype = getattr(fn, "launches_by_dtype", {})
        by_kernel = getattr(fn, "launches_by_instance", {})
        for dt, half in HALF_NAMES.items():
            if dt in by_dtype:
                out[f"{n}_{half}"] = by_dtype[dt]
            kernels = {f"{n}_{inst}": k for inst, k in by_kernel.items()
                       if inst.startswith(half + "_")}
            if kernels:
                out[f"{n}_{half}"] = sum(kernels.values())
                out.update(kernels)
    return out


def _fused_step_env() -> Optional[bool]:
    """MXNET_FUSED_STEP: None = unset (default: on for hybridized blocks),
    False = explicitly off, True = explicitly on."""
    v = os.environ.get("MXNET_FUSED_STEP")
    if v is None or v == "":
        return None
    return v not in ("0", "false", "False", "off")


_programs_built = 0


def _note_program_built():
    """One executor captured its first program (rebuilds replace, they do
    not re-count), as the reference's gauge counts."""
    global _programs_built
    _programs_built += 1
    _telemetry.gauge_set("fused.programs", _programs_built)


def _dropouts(net):
    """The net's Dropout blocks that drop in training."""
    return [m for m in net.modules()
            if isinstance(m, _gnn.Dropout) and m._rate > 0.0]


class _Program:
    """One key's graph (None on the CPU), its static inputs and output,
    the launches its capture recorded and its replays."""

    __slots__ = ("graph", "x", "y", "loss", "launches_per_step", "replays",
                 "states")

    def __init__(self):
        self.graph = None
        self.x = self.y = self.loss = None
        self.launches_per_step: Dict[str, int] = {}
        self.replays = 0
        self.states = None


class _Step:
    """The step function of one net, loss and optimizer over the
    trainable ``(name, parameter)`` pairs, with the optimizer states from
    ``get_states()`` (a dict by name, shared with a Trainer), and its
    programs.  ``mean``: gradients of the mean loss (``FusedTrainStep``)
    rather than of the sum (``Trainer.fuse_step``, whose optimizer
    divides by the batch through ``rescale_grad``)."""

    def __init__(self, net, loss_fn, opt, trainable, get_states, mean,
                 dtype=None, grad_scale=None):
        self.net, self.loss_fn, self.opt = net, loss_fn, opt
        self.names = [n for n, _ in trainable]
        self.params = [p for _, p in trainable]
        self.get_states = get_states
        self.mean = mean
        self.dtype, self.grad_scale = dtype, grad_scale
        self.device = self.params[0].device
        self.programs: Dict[tuple, _Program] = {}
        self._counted = False       # fused.programs counts an executor once
        self._epoch = storage_epoch()
        self._ptrs = ()             # the storage the graphs were captured on
        states = get_states()
        for n, p in trainable:
            if states.get(n) is None:
                states[n] = opt.create_state(n, p)

    # ---------------------------------------------------------- the step
    def _forward(self, x):
        """The net on ``x``; under ``dtype``, the reference's mixed
        precision: every floating parameter and buffer but the running
        statistics cast to ``dtype`` (one cast a tensor, so tied weights
        stay tied; a trainable one's gradient flows back through it), the
        batch cast to ``dtype``, the outputs cast back to fp32."""
        if self.dtype is None:
            return self.net(x)
        casts, sub = {}, {}
        for name, t in self.net.state_dict(keep_vars=True).items():
            if not t.is_floating_point() or name.endswith(
                    ("running_mean", "running_var")):
                continue
            if id(t) not in casts:
                casts[id(t)] = t.to(self.dtype)
            sub[name] = casts[id(t)]
        out = torch.func.functional_call(self.net, sub, (x.to(self.dtype),))
        if isinstance(out, (tuple, list)):
            return type(out)(o.float() for o in out)
        return out.float()

    def _body(self, x, y, ctl, loss_out):
        scale = self.grad_scale
        with autograd.record():
            loss = self.loss_fn(self._forward(x), y)
            head = loss.mean() if self.mean else loss.sum()
            if scale:
                head = head * scale
        grads = torch.autograd.grad(head, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else
                 (g / scale if scale else g)
                 for p, g in zip(self.params, grads)]
        states = self.get_states()
        self.opt.rule([p.data for p in self.params], grads,
                      [states[n] for n in self.names], ctl)
        with torch.no_grad():
            loss_out.copy_(loss.detach().mean())

    def _generators(self):
        gens = [m.generator(self.device) for m in _dropouts(self.net)]
        if hasattr(self.opt, "generator"):          # SGLD's noise
            gens.append(self.opt.generator(self.device))
        # Dropouts given no generator share mx.random's: register it once
        return list({id(g): g for g in gens}.values())

    # --------------------------------------------------------- the calls
    def _storage(self):
        """Where the parameters and buffers live now."""
        return tuple(t.data_ptr() for t in self.params) + tuple(
            t.data_ptr() for t in self.net.buffers())

    def _follow_storage(self):
        """After a ``cast`` or ``reset_ctx`` somewhere: if this step's
        tensors moved, its graphs (which hold the old storage) go."""
        self._epoch = storage_epoch()
        if self.programs and self._storage() != self._ptrs:
            self.programs.clear()
            _telemetry.counter_add("fused.rebuilds")

    def run(self, x, y, t):
        """One step at step count ``t`` (already advanced): returns the
        mean loss, a fresh 0-d tensor."""
        if self.device.type == "cuda" and self._epoch != storage_epoch():
            self._follow_storage()
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               self.opt._fused_sig())
        ctl = self.opt.control(self.device, t)
        prog = self.programs.get(key)
        if prog is None:
            if self.programs:
                _telemetry.counter_add("fused.rebuilds")
            prog = self.programs[key] = self._build(x, y, ctl)
        _telemetry.counter_add("fused.dispatches")
        if prog.graph is None:                      # the CPU leg
            self._body(x, y, ctl, prog.loss)
            return prog.loss.clone()
        prog.x.copy_(x)
        prog.y.copy_(y)
        prog.graph.replay()
        prog.replays += 1
        return prog.loss.clone()

    def _build(self, x, y, ctl):
        if not self._counted:
            self._counted = True
            _note_program_built()
        prog = _Program()
        prog.loss = torch.zeros((), device=self.device)
        if self.device.type != "cuda":
            return prog
        self._ptrs = self._storage()
        states = self.get_states()
        prog.states = {n: states[n] for n in self.names}
        prog.x, prog.y = x.clone(), y.clone()
        gens = self._generators()
        self._warm_up(prog, ctl, gens)
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        before = _counts()
        # Dead reference cycles go first, and the collector stays off
        # while the step is captured: a CUDAGraph it frees there breaks
        # the capture, and torch.cuda.graph no longer collects before
        # one.  "thread_local": an unsafe call (a synchronization, say)
        # that another thread makes leaves the capture valid; this
        # thread's unsafe calls, and any thread's operation on the
        # captured stream, still break it.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._body(prog.x, prog.y, ctl, prog.loss)
        except Exception as e:
            # capture_end's own error hides the one that broke the
            # capture: name that one
            cause = e.__context__ or e
            raise RuntimeError(f"capturing the fused step failed: "
                               f"{type(cause).__name__}: {cause}") from e
        finally:
            if collecting:
                gc.enable()
        after = _counts()
        prog.launches_per_step = {n: after[n] - before[n] for n in after
                                  if after[n] != before[n]}
        prog.graph = graph
        return prog

    def _warm_up(self, prog, ctl, gens):
        """Run the step once eagerly on a side stream, then put back what
        it changed: the parameters, buffers and optimizer states, and the
        generators' states."""
        states = prog.states.values()
        tensors = [p.data for p in self.params] + list(self.net.buffers()) \
            + [t for st in states for t in st.values()]
        saved = [t.clone() for t in tensors]
        gen_states = [g.get_state() for g in gens]
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._body(prog.x, prog.y, ctl, prog.loss)
        cur.wait_stream(side)
        torch._foreach_copy_(tensors, saved)
        for g, s in zip(gens, gen_states):
            g.set_state(s)
        del saved
        torch.cuda.synchronize(self.device)

    def resync(self):
        """After the states were replaced (``Trainer.load_states``): copy
        them into the tensors each graph captured and put those back in
        their place; a state whose keys or shapes changed drops the
        graphs, and the next call captures anew."""
        states = self.get_states()
        for prog in self.programs.values():
            for n, held in (prog.states or {}).items():
                cur = states.get(n)
                if cur is held:
                    continue
                if cur is None or sorted(cur) != sorted(held) or any(
                        cur[k].shape != held[k].shape for k in held):
                    self.programs.clear()
                    return
                with torch.no_grad():
                    for k in held:
                        held[k].copy_(cur[k])
                states[n] = held


def _on_net(net, t):
    """``t`` (a tensor or an array) on the device of ``net``'s first
    initialized parameter or buffer; as it is where none is."""
    t = torch.as_tensor(t)
    for p in net.collect_params().values():
        if is_initialized(p):
            return t.to(p.device)
    return t


def _publish_model_flops(net, x):
    """With the obs recorder running, price the model once at build (the
    MFU signal's numerator); looked up in ``sys.modules``, so a process
    that never imported ``obs`` never imports it here."""
    obs = sys.modules.get(__name__.split(".")[0] + ".obs")
    try:
        if obs is not None and obs.active() and net is not None:
            obs.publish_model_flops(net, x)
    except Exception:
        pass


def _materialize(net, x):
    """One inference forward gives deferred parameters their shapes
    (≙ the reference's first eager call)."""
    if all(is_initialized(t) for t in net.collect_params().values()):
        return
    with autograd.predict_mode(), torch.no_grad():
        net(_on_net(net, x))


class _Stats:
    """The executors' views of their programs, for callers that read
    them (``chip_smoke.py``)."""

    _step: Optional[_Step] = None

    @property
    def programs(self) -> int:
        return len(self._step.programs) if self._step else 0

    @property
    def replays(self) -> int:
        return sum(p.replays for p in self._step.programs.values()) \
            if self._step else 0

    @property
    def launches_per_step(self) -> Dict[str, int]:
        """The launches the newest graph's capture recorded."""
        if not self._step or not self._step.programs:
            return {}
        return dict(list(self._step.programs.values())[-1]
                    .launches_per_step)

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches the replays made: each graph's replays times
        the launches its capture recorded."""
        out: Dict[str, int] = {}
        for prog in (self._step.programs.values() if self._step else ()):
            for n, k in prog.launches_per_step.items():
                out[n] = out.get(n, 0) + prog.replays * k
        return out

    def sync(self):
        """Wait for the card to finish the steps queued so far."""
        if self._step is not None and self._step.device.type == "cuda":
            torch.cuda.synchronize(self._step.device)


class FusedTrainStep(_Stats):
    """A net, a loss and an optimizer as one training step a call (≙ the
    reference's ``FusedTrainStep``)::

        step = FusedTrainStep(net, loss, optimizer)
        loss = step(x, y)       # one CUDA-graph replay on the card

    The gradients are of the mean loss; the optimizer's own
    ``rescale_grad`` is left as it is.  The trainable parameters are the
    net's ``nn.Parameter`` s that require grad; the optimizer states are
    this object's own.  ``dtype`` (``"bfloat16"``, ``"float16"`` or a
    torch dtype) runs the step in mixed precision as the module notes
    say, fp32 master weights updated through the casts, the conv kernels'
    instances of that dtype on the card.  ``grad_scale`` multiplies the
    loss before the backward and divides the gradients after it (the
    returned loss is unscaled): a static scale, the reference's only
    one, which an fp16 step wants so that its small gradients do not
    underflow.  ``mesh=`` is not ported and raises;
    ``batch_axis`` names the mesh axis of the batch and is accepted for
    the reference's signature."""

    def __init__(self, net, loss: Callable, optimizer, mesh=None,
                 batch_axis: str = "dp", grad_scale: Optional[float] = None,
                 dtype=None):
        if mesh is not None:
            raise NotImplementedError(
                "FusedTrainStep(mesh=): sharded training belongs to the "
                "mesh item of the port's queue (ROADMAP Queue 1 item 7)")
        if dtype is not None:
            dtype = as_dtype(dtype)
            if not dtype.is_floating_point:
                raise TypeError(f"FusedTrainStep(dtype={dtype}): a floating "
                                f"dtype")
        self._net, self._loss, self._opt = net, loss, optimizer
        self._grad_scale = grad_scale
        self._dtype = dtype
        self._states: Dict[str, dict] = {}

    def _prepare(self, x):
        _materialize(self._net, x)
        _publish_model_flops(self._net, x)
        trainable = [(n, p) for n, p in self._net.collect_params().items()
                     if isinstance(p, torch.nn.Parameter) and p.requires_grad]
        self._step = _Step(self._net, self._loss, self._opt, trainable,
                           lambda: self._states, mean=True,
                           dtype=self._dtype, grad_scale=self._grad_scale)

    def __call__(self, x, y):
        if self._step is None:
            self._prepare(torch.as_tensor(x))
        _telemetry.counter_add("fused.steps")
        # a fresh trace id a step: the step's span and the feed fetch
        # that follows it share it
        _telemetry.set_current_trace()
        with _telemetry.span("train.step"), \
                _telemetry.timed("fused.step_us"):
            self._opt.num_update += 1
            return self._step.run(x, y, self._opt.num_update)


class TrainerFusedStep(_Stats):
    """The executor behind ``Trainer.fuse_step(loss_fn)`` (≙ the
    reference's ``TrainerFusedStep``): one captured CUDA graph a step,
    sharing the Trainer's state.  ``num_update``, ``trainer._states``
    and the parameter tensors are the Trainer's, so fused and legacy
    steps interleave and ``save_states`` / ``load_states`` see one
    state.

    Semantics are the legacy path's (bit for bit on the CPU): gradients
    of ``sum(loss)``, rescaled by ``trainer._scale / batch_size`` inside
    the optimizer's rule, the learning rate read after ``num_update``
    advances.  The step consumes every trainable gradient (``p.grad =
    None``), so a ``trainer.step()`` after it raises the stale-gradient
    ``UserWarning``.  A trainable parameter the forward does not use
    gets a zero gradient (the legacy path would raise).

    Where the reference cannot fuse, the call runs the legacy
    record/backward/step path and counts ``fused.fallback.<reason>``
    (``fallback_reason``): ``disabled`` (``MXNET_FUSED_STEP=0``),
    ``no_net``, ``not_hybrid_block``, ``not_hybridized`` (unless
    ``MXNET_FUSED_STEP=1``), ``update_on_kvstore``, ``dist_kvstore``,
    ``sparse_param``, ``params_mismatch`` (a trainable parameter that is
    not the net's).  An active ``Dropout`` fuses: its generator, like
    SGLD's, is registered with the graph, so each replay draws as an
    eager step would."""

    def __init__(self, trainer, loss_fn: Callable, net=None):
        self._trainer = trainer
        self._loss = loss_fn
        self._net = net
        self._opt = trainer._optimizer
        self.fallback_reason = self._static_fallback()

    def _static_fallback(self) -> Optional[str]:
        env = _fused_step_env()
        if env is False:
            return "disabled"
        net = self._net
        if net is None:
            return "no_net"
        if not isinstance(net, HybridBlock):
            return "not_hybrid_block"
        if not getattr(net, "_active", False) and env is not True:
            return "not_hybridized"
        tr = self._trainer
        if tr._update_on_kvstore:
            return "update_on_kvstore"
        if str(tr._kvstore).startswith("dist"):
            return "dist_kvstore"
        for _, p in tr._trainable:
            if getattr(p, "grad_stype", "default") == "row_sparse":
                return "sparse_param"
        return None

    @property
    def fused(self) -> bool:
        return self.fallback_reason is None

    def _prepare(self, x):
        tr, net = self._trainer, self._net
        _materialize(net, x)
        mine = {id(t) for t in net.collect_params().values()}
        if any(id(p) not in mine for _, p in tr._trainable):
            self.fallback_reason = "params_mismatch"
            return
        self._step = _Step(net, self._loss, self._opt, tr._trainable,
                           lambda: tr._states, mean=False)
        if tr._restored_generators is not None:
            self.resync_ctl(tr._restored_generators)
        _publish_model_flops(net, x)

    def __call__(self, x, y, batch_size=None, ignore_stale_grad=False):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if batch_size is None:
            batch_size = int(x.shape[0])
        if self.fallback_reason is None and self._step is None:
            self._prepare(x)
        _telemetry.counter_add("fused.steps")
        if self.fallback_reason is not None:
            return self._legacy_step(x, y, batch_size, ignore_stale_grad)
        _telemetry.set_current_trace()
        with _telemetry.span("train.step"), \
                _telemetry.timed("fused.step_us"):
            tr, opt = self._trainer, self._opt
            # Trainer.step's order: rescale from the batch size, advance
            # num_update, then read the learning rate
            opt.rescale_grad = tr._scale / batch_size
            opt.num_update += 1
            loss = self._step.run(x, y, opt.num_update)
            for p in self._step.params:
                p.grad = None           # consumed, as a legacy step does
            return loss

    def _legacy_step(self, x, y, batch_size, ignore_stale_grad):
        _telemetry.counter_add("fused.fallbacks")
        _telemetry.counter_add("fused.fallback." + self.fallback_reason)
        if self._net is None:
            raise ValueError(
                "fuse_step fallback needs a net to run the forward "
                "(construct the Trainer from net.collect_params() or pass "
                "net= to fuse_step)")
        x, y = _on_net(self._net, x), _on_net(self._net, y)
        with autograd.record():
            loss = self._loss(self._net(x), y)
        loss.backward(torch.ones_like(loss))
        self._trainer.step(batch_size, ignore_stale_grad=ignore_stale_grad)
        return loss.detach().mean()

    def resync(self):
        """Called by ``Trainer.load_states``: the states it loaded go
        into the tensors the graphs captured (:meth:`_Step.resync`);
        the step count is read from ``num_update`` on every call."""
        if self._step is not None:
            self._step.resync()

    # ---------------------------------------------------------- checkpoint
    def export_ctl(self):
        """The control block a checkpoint carries (None before the first
        fused step): ``t``, the step count as the reference's int32, and
        ``generators``, the states of the generators the step draws from
        (in :meth:`_Step._generators` order), so a resumed run continues
        the same streams."""
        if self._step is None:
            return None
        ctl = {"t": torch.tensor(self._opt.num_update, dtype=torch.int32)}
        gens = self._step._generators()
        if gens:
            ctl["generators"] = {str(i): g.get_state()
                                 for i, g in enumerate(gens)}
        return ctl

    def resync_ctl(self, generators):
        """After a restore: the step count is read from ``num_update`` at
        every call, so only the generators' states (``generators``, in
        :meth:`export_ctl` order) need setting; before the first call
        :meth:`_prepare` sets them.  ``set_state`` writes the generator's
        own seed and offset, which a replay of a graph it is registered
        with reads, so the next replay draws from them.  The generators
        are the net's and the optimizer's, shared by every executor: set
        once, the Trainer forgets them."""
        if self._step is None:
            return
        gens = self._step._generators()
        if len(gens) != len(generators):
            raise ValueError(f"checkpoint holds {len(generators)} generator "
                             f"states, the step draws from {len(gens)}")
        for g, st in zip(gens, generators):
            g.set_state(st)
        self._trainer._restored_generators = None
