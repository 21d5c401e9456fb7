"""Automatic mixed precision (≙ ``mxnet_tpu/amp``).

- :func:`init` patches the matrix ops of ``mxnet_tpu_torch.ops.nn``
  (``lists.TARGET_DTYPE_OPS``) with wrappers that cast their floating
  positional arguments to the target dtype and a target-dtype result
  back to fp32, as the reference patches its module attributes; the
  Gluon blocks look those ops up at call time, so they pick the wrappers
  up.  :func:`deinit` puts the originals back.
- :class:`LossScaler`, :func:`init_trainer` (an overflow gate around
  ``Trainer._update``: a step whose gradients are not all finite is
  skipped and the scale shrinks), :func:`scale_loss` and :func:`unscale`
  are the reference's dynamic loss scaling.  The default scale is 1 for
  bf16 (fp32's exponent range) and 2^16 for fp16.
- :func:`convert_model` (= :func:`convert_hybrid_block`) casts a model's
  parameters and running statistics for low-precision inference
  (``Block.cast``): what ``InferenceEngine(precision="bf16")`` does.

On the card a bf16 or fp16 net runs the softmax kernel's and the conv
kernels' half instances.  The training legs (``init`` +
``init_trainer``) keep fp32 parameters: the patched convs and dense take
half operands (a 3x3/s1 conv on the bf16 or fp16 instances of
``conv3x3`` and ``conv_wgrad``) and return fp32.  A whole half training
step, half activations through the training BatchNorm (the reference's
``_bn_train``) and the fused conv blocks, is
``parallel.FusedTrainStep(dtype="bfloat16")`` or ``(dtype="float16",
grad_scale=...)``.
"""
from __future__ import annotations

import contextlib

import torch

from ..gluon.parameter import as_dtype, is_initialized
from ..ops import nn as _nn
from . import lists

__all__ = ["init", "deinit", "init_trainer", "scale_loss", "unscale",
           "LossScaler", "convert_model", "convert_hybrid_block", "lists"]

_state = {
    "initialized": False,
    "target_dtype": None,
    "originals": {},
}


def _low_precision_wrapper(fn, target_dtype):
    def wrapped(*args, **kwargs):
        cast_args = tuple(
            a.to(target_dtype) if isinstance(a, torch.Tensor)
            and a.is_floating_point() and a.dtype != target_dtype else a
            for a in args)
        out = fn(*cast_args, **kwargs)
        if isinstance(out, torch.Tensor) and out.dtype == target_dtype:
            out = out.float()
        return out
    wrapped.__name__ = getattr(fn, "__name__", "amp_op")
    wrapped.__wrapped__ = fn
    return wrapped


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP ≙ ``amp.init``: patch the ops of
    ``target_precision_ops`` (default ``lists.TARGET_DTYPE_OPS``) in
    ``ops.nn`` with cast wrappers.  ``target_dtype`` is bfloat16 or
    float16; a second call does nothing."""
    if _state["initialized"]:
        return
    dt = as_dtype(target_dtype)
    if dt not in (torch.bfloat16, torch.float16):
        raise ValueError(f"amp target dtype {target_dtype!r}: bfloat16 or "
                         f"float16")
    for name in list(target_precision_ops or lists.TARGET_DTYPE_OPS):
        orig = getattr(_nn, name, None)
        if orig is None:
            continue
        _state["originals"][name] = orig
        setattr(_nn, name, _low_precision_wrapper(orig, dt))
    _state["initialized"] = True
    _state["target_dtype"] = dt


def deinit():
    """Restore the original ops (a test helper, as in the reference)."""
    if not _state["initialized"]:
        return
    for name, orig in _state["originals"].items():
        setattr(_nn, name, orig)
    _state["originals"].clear()
    _state["initialized"] = False
    _state["target_dtype"] = None


class LossScaler:
    """Dynamic loss scaling ≙ ``amp/loss_scaler.py``: the scale doubles
    after every ``scale_window`` overflow-free steps and halves (down to
    1) on an overflow, whose step the trainer's gate skips."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = float(init_scale)
        self._scale_factor = float(scale_factor)
        self._scale_window = int(scale_window)
        self._unskipped = 0

    def has_overflow(self, grads) -> bool:
        """True if any gradient holds an inf or a NaN (one host sync for
        all of them)."""
        grads = [g for g in grads if g is not None]
        if not grads:
            return False
        finite = torch.stack([torch.isfinite(g).all() for g in grads])
        return not bool(finite.all())

    def update_scale(self, overflow: bool):
        if overflow:
            self.loss_scale = max(1.0, self.loss_scale / self._scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0


def _grads(trainer):
    return [p.grad for _, p in trainer._trainable
            if is_initialized(p) and p.grad is not None]


def init_trainer(trainer):
    """Attach dynamic loss scaling to a Trainer ≙ ``amp.init_trainer``:
    ``trainer._update`` is wrapped with an overflow gate; gradients that
    are not all finite are dropped, the step skipped and the scale
    shrunk.  The scaler starts at 2^16 for an fp16 target, else 1."""
    if getattr(trainer, "_amp_original_update", None) is not None:
        return trainer
    fp16 = _state["target_dtype"] == torch.float16
    scaler = LossScaler(init_scale=2.0 ** 16 if fp16 else 1.0)
    trainer._amp_loss_scaler = scaler
    orig_update = trainer._update

    def _amp_update(ignore_stale_grad=False):
        overflow = scaler.has_overflow(_grads(trainer))
        if overflow:
            for _, p in trainer._trainable:
                p.grad = None
        else:
            orig_update(ignore_stale_grad)
        scaler.update_scale(overflow)

    trainer._amp_original_update = orig_update
    trainer._update = _amp_update
    return trainer


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as l: l.backward()`` ≙
    ``amp.scale_loss``: the loss (or each of a list) times the current
    scale, and the trainer's gradient rescale set so that the optimizer
    sees unscaled gradients."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
    trainer._scale = 1.0 / scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def unscale(trainer):
    """Divide the gradients by the current loss scale in place (then the
    trainer's rescale is 1)."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for g in _grads(trainer):
            g.mul_(inv)
    trainer._scale = 1.0


def convert_model(net, target_dtype="bfloat16"):
    """Cast a model's parameters and running statistics for
    low-precision inference ≙ ``amp.convert_model`` (``net.cast``);
    returns the net."""
    net.cast(target_dtype)
    return net


convert_hybrid_block = convert_model
