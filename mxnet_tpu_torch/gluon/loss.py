"""Gluon losses (≙ ``mxnet_tpu/gluon/loss.py``, the ones the port's
training paths use).

Each loss is a block (an ``nn.Module``) that returns one value per
sample: the batch axis is kept and every other axis is averaged, with
``sample_weight`` and the loss's ``weight`` applied first, as in the
reference.  ``loss.backward(torch.ones_like(loss))`` then sums over the
batch, as the reference's ``loss.backward()`` does, and
``Trainer.step(batch_size)`` divides by the batch.
"""
from __future__ import annotations

from ..ops import nn as _nn
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


def _apply_weight(loss, weight, sample_weight):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None and weight != 1.0:
        loss = loss * weight
    return loss


def _batch_mean(loss, batch_axis):
    axes = tuple(i for i in range(loss.dim()) if i != batch_axis)
    return loss.mean(dim=axes) if axes else loss


class Loss(HybridBlock):
    """Base of the losses: ``weight`` scales the loss, ``batch_axis`` is
    the axis kept."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _reduce(self, loss, sample_weight):
        loss = _apply_weight(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class L2Loss(Loss):
    """``(pred − label)² / 2``."""

    def forward(self, pred, label, sample_weight=None):
        return self._reduce((pred - label) ** 2 / 2, sample_weight)


class L1Loss(Loss):
    """``|pred − label|``."""

    def forward(self, pred, label, sample_weight=None):
        return self._reduce((pred - label).abs(), sample_weight)


class SoftmaxCrossEntropyLoss(Loss):
    """≙ ``gluon.loss.SoftmaxCrossEntropyLoss``: log-softmax over ``axis``
    (skipped when ``from_logits``: ``pred`` is already log-probabilities),
    then the negative log-probability of the label (``sparse_label``: a
    class index per sample) or of dense label distributions."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        logp = pred if self._from_logits else \
            _nn.log_softmax(pred, axis=self._axis)
        if self._sparse:
            loss = -_nn.pick(logp, label, axis=self._axis)
        else:
            loss = -(logp * label).sum(dim=self._axis)
        return self._reduce(loss, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
