"""mx.autograd — record/pause scopes, backward, grad and the custom
``Function``, over PyTorch's autograd.

≙ ``mxnet_tpu/autograd.py:49-153`` (upstream ``python/mxnet/autograd.py``:
record :121, pause :145, mark_variables :196, backward :245, grad,
Function :369).  The JAX package keeps its own tape; here torch's
autograd is the tape:

- ``record()`` is a scope under ``torch.enable_grad()``, ``pause()`` one
  under ``torch.no_grad()``.  ``is_recording()`` and ``is_training()``
  read thread-local flags that the scopes set, as the reference's do
  (both start False on every thread).  ``train_mode()`` and
  ``predict_mode()`` set only the training flag.  The mode-dependent
  Gluon blocks (``BatchNorm``, ``Dropout``, the fused conv + BN segment)
  and ``CustomOp`` bodies read it: inside a ``record()``, ``pause()``,
  ``train_mode()`` or ``predict_mode()`` scope, or after
  ``set_training``, a block trains exactly when ``is_training()`` is
  True (so ``predict_mode()`` inside ``record()`` gives inference, as in
  the reference); outside all of them (:func:`training_scope` is None)
  it follows its own ``train()`` / ``eval()``.
- ``mark_variables`` makes tensors require grad; ``grad_reqs`` of
  ``"write"`` (the default) makes each backward overwrite the variable's
  ``.grad`` rather than accumulate into it, ``"add"`` accumulates (torch's
  own rule) and ``"null"`` stops its gradient.
- ``backward`` and ``grad`` are ``torch.autograd.backward`` and
  ``torch.autograd.grad`` (``grad`` returns zeros for a variable the
  heads do not reach, and leaves ``.grad`` untouched).
- ``Function`` is the reference's imperative custom function: subclass
  it with ``forward(self, *inputs)`` and ``backward(self, *out_grads)``,
  call ``save_for_backward`` in ``forward`` and read ``self._saved`` in
  ``backward``, then call the instance.  It runs as a
  ``torch.autograd.Function``; both methods run paused, as in the
  reference.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "training_scope",
           "mark_variables", "backward", "grad", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = None     # None: never set on this thread


_state = _State()


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return bool(_state.training)


def training_scope() -> Optional[bool]:
    """The training flag where a scope or ``set_training`` has set it on
    this thread, None where nothing has: a block's own ``train()`` /
    ``eval()`` decides there."""
    return _state.training


def set_recording(flag: bool) -> bool:
    """Set the recording flag (and torch's grad mode); return the old
    flag."""
    prev = _state.recording
    _state.recording = bool(flag)
    torch.set_grad_enabled(bool(flag))
    return prev


def set_training(flag: bool) -> bool:
    prev = bool(_state.training)
    _state.training = bool(flag)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record: Optional[bool], train_mode: Optional[bool]):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev = None

    def __enter__(self):
        self._prev = (_state.recording, _state.training,
                      torch.is_grad_enabled())
        if self._enter_is_record is not None:
            _state.recording = self._enter_is_record
            torch.set_grad_enabled(self._enter_is_record)
        if self._enter_train_mode is not None:
            _state.training = self._enter_train_mode
        return self

    def __exit__(self, *exc):
        _state.recording, _state.training, grad = self._prev
        torch.set_grad_enabled(grad)


def record(train_mode: bool = True):
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def _write_hook(t):
    def hook(g):
        if getattr(t, "_mxt_grad_req", "add") == "write":
            t.grad = None
        return g
    return hook


def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Mark tensors as variables whose gradients backward computes
    (≙ ``attach_grad``); ``gradients`` are their initial ``.grad``."""
    if isinstance(variables, torch.Tensor):
        variables = [variables]
        gradients = [gradients] if gradients is not None else None
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for i, v in enumerate(variables):
        req = grad_reqs[i]
        if req not in ("write", "add", "null"):
            raise ValueError(f"unknown grad_req {req!r}")
        if req == "null":
            v.requires_grad_(False)
            v._mxt_grad_req = req
            continue
        v.requires_grad_(True)
        if getattr(v, "_mxt_grad_req", None) is None:
            v.register_hook(_write_hook(v))
        v._mxt_grad_req = req
        if gradients is not None and gradients[i] is not None:
            v.grad = gradients[i].detach().to(v.dtype).clone()


def _list(x):
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else [x]
    return list(x)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into the ``.grad`` of the variables."""
    torch.autograd.backward(_list(heads), _list(head_grads),
                            retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True) -> List[torch.Tensor]:
    """Gradients of ``heads`` with respect to ``variables``, returned
    and not written to ``.grad`` (≙ ``autograd.grad``)."""
    variables = _list(variables)
    gs = torch.autograd.grad(_list(heads), variables, _list(head_grads),
                             retain_graph=retain_graph,
                             create_graph=create_graph, allow_unused=True)
    return [torch.zeros_like(v) if g is None else g
            for v, g in zip(variables, gs)]


class _Bridge(torch.autograd.Function):
    """Runs a :class:`Function` instance's forward and backward."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        with pause():
            outputs = fn.forward(*inputs)
        saved = getattr(fn, "_saved", ())
        # hand tensors to torch's saved-tensor store, not to the
        # instance: an output held by the instance held by the graph is a
        # reference cycle
        if all(isinstance(s, torch.Tensor) for s in saved):
            ctx.save_for_backward(*saved)
            fn._saved = None
        ctx.fn = fn
        ctx.multi = isinstance(outputs, (tuple, list))
        return tuple(outputs) if ctx.multi else outputs

    @staticmethod
    def backward(ctx, *ograds):
        fn = ctx.fn
        if fn._saved is None:
            fn._saved = ctx.saved_tensors
        with pause():
            igrads = fn.backward(*ograds)
        if isinstance(igrads, torch.Tensor):
            igrads = (igrads,)
        return (None, *igrads)


class Function:
    """A differentiable function with a user forward and backward (≙
    ``mx.autograd.Function``)."""

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def save_for_backward(self, *arrays):
        self._saved = arrays

    def __call__(self, *inputs):
        return _Bridge.apply(self, *inputs)
