"""Learning-rate schedules (≙ ``mxnet_tpu/lr_scheduler.py``, itself
≙ ``python/mxnet/lr_scheduler.py``).

A scheduler maps the optimizer's update count to a learning rate.  It is
host Python on Python floats, as in the reference: the optimizer reads
it once a step, after advancing its count, and hands the value to the
device in its control tensor (``optimizer.Optimizer``), so a captured
training step follows the schedule without being captured again.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base: ``base_lr`` and a warm-up over the first ``warmup_steps``
    updates, ``"linear"`` from ``warmup_begin_lr`` or ``"constant"``
    (``base_lr`` scaled by the share of the warm-up done)."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = (self.base_lr - self.warmup_begin_lr) * num_update / \
                max(self.warmup_steps, 1)
            return self.warmup_begin_lr + inc
        return self.base_lr * (num_update / max(self.warmup_steps, 1))

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """``base_lr · factor^(num_update // step)``, never below
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, **kw):
        super().__init__(**kw)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr * self.factor ** (num_update // self.step)
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """``base_lr`` times ``factor`` once for each boundary in ``step``
    that ``num_update`` has reached."""

    def __init__(self, step, factor=1.0, **kw):
        super().__init__(**kw)
        self.step = sorted(step)
        self.factor = factor

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr
        for s in self.step:
            if num_update >= s:
                lr *= self.factor
        return lr


def _frac(sched, num_update):
    """The share of the schedule after the warm-up that is done, in
    [0, 1]."""
    return min(1.0, max(0.0, (num_update - sched.warmup_steps) /
                        max(sched.max_update - sched.warmup_steps, 1)))


class PolyScheduler(LRScheduler):
    """From ``base_lr`` to ``final_lr`` as ``(1 − done)^pwr`` over
    ``max_update`` updates."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0.0, **kw):
        super().__init__(base_lr=base_lr, **kw)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1 - _frac(self, num_update)) ** self.power


class CosineScheduler(LRScheduler):
    """From ``base_lr`` to ``final_lr`` along half a cosine over
    ``max_update`` updates."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, **kw):
        super().__init__(base_lr=base_lr, **kw)
        self.max_update = max_update
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1 + math.cos(math.pi * _frac(self, num_update))) / 2
