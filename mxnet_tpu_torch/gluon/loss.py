"""Gluon losses (≙ ``mxnet_tpu/gluon/loss.py``).

Each loss is a block (an ``nn.Module``) that returns one value per
sample: the batch axis is kept and every other axis is averaged, with
``sample_weight`` and the loss's ``weight`` applied first, as in the
reference; the reference's exceptions are kept (``TripletLoss`` takes no
mean, ``PoissonNLLLoss`` returns the mean of everything,
``CosineEmbeddingLoss`` means only a loss of more than one axis).
``loss.backward(torch.ones_like(loss))`` then sums over the batch, as
the reference's ``loss.backward()`` does, and ``Trainer.step(batch_size)``
divides by the batch.  Each loss is written in the reference's order of
operations.  ``CTCLoss`` waits for ``ops/ctc.py``.
"""
from __future__ import annotations

import math

import torch

from ..ops import nn as _nn
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss", "SigmoidBinaryCrossEntropyLoss", "SigmoidBCELoss",
           "KLDivLoss", "TripletLoss", "CosineEmbeddingLoss", "CTCLoss",
           "PoissonNLLLoss", "SDMLLoss"]


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


class HuberLoss(Loss):
    """``|d| − ρ/2`` where ``|d| > ρ``, else ``d² / (2ρ)``, d = pred − label."""

    def __init__(self, rho=1.0, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        rho = self._rho
        d = (pred - label).abs()
        loss = torch.where(d > rho, d - 0.5 * rho, 0.5 / rho * d * d)
        return self._reduce(loss, sample_weight)


class HingeLoss(Loss):
    """``max(0, margin − pred·label)``, labels ±1."""

    def __init__(self, margin=1.0, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.clamp(self._margin - pred * label, min=0.0)
        return self._reduce(loss, sample_weight)


class SquaredHingeLoss(HingeLoss):
    """``max(0, margin − pred·label)²``."""

    def forward(self, pred, label, sample_weight=None):
        loss = torch.clamp(self._margin - pred * label, min=0.0) ** 2
        return self._reduce(loss, sample_weight)


class LogisticLoss(Loss):
    """Binary cross-entropy on logits; ``label_format`` "signed" (±1,
    mapped to {0, 1} first) or "binary" ({0, 1})."""

    def __init__(self, weight=1.0, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._fmt = label_format

    def forward(self, pred, label, sample_weight=None):
        if self._fmt == "signed":
            label = (label + 1.0) / 2.0
        loss = _nn.sigmoid_binary_cross_entropy(pred, label)
        return self._reduce(loss, sample_weight)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """``ops.nn.sigmoid_binary_cross_entropy`` on logits, or on
    probabilities when ``from_sigmoid``.  ``pos_weight`` is taken and
    ignored, as the reference ignores it."""

    def __init__(self, from_sigmoid=False, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, pos_weight=None, sample_weight=None):
        loss = _nn.sigmoid_binary_cross_entropy(pred, label,
                                                self._from_sigmoid)
        return self._reduce(loss, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``mean(label · (log(label + 1e-12) − log p))`` over ``axis``; ``pred``
    is log-probabilities when ``from_logits`` (the default), else logits
    put through log-softmax first."""

    def __init__(self, from_logits=True, axis=-1, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        logp = pred if self._from_logits else \
            _nn.log_softmax(pred, axis=self._axis)
        loss = (label * (torch.log(label + 1e-12) - logp)).mean(
            dim=self._axis)
        return self._reduce(loss, sample_weight)


class TripletLoss(Loss):
    """``max(Σ((a − p)² − (a − n)²) + margin, 0)`` over every axis but
    the first; weighted, not averaged."""

    def __init__(self, margin=1.0, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        d = ((pred - positive) ** 2 - (pred - negative) ** 2).sum(
            dim=tuple(range(1, pred.dim())))
        loss = torch.clamp(d + self._margin, min=0.0)
        return _apply_weight(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 − cos(a, b)`` where ``label == 1``, else ``max(0, cos −
    margin)``, the cosine over the last axis (1e-12 added to the product
    of norms)."""

    def __init__(self, weight=1.0, batch_axis=0, margin=0.0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        a, b = input1, input2
        cos = (a * b).sum(dim=-1) / (
            torch.sqrt((a * a).sum(dim=-1)) *
            torch.sqrt((b * b).sum(dim=-1)) + 1e-12)
        loss = torch.where(label == 1, 1 - cos,
                           torch.clamp(cos - self._margin, min=0.0))
        loss = _apply_weight(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis) if loss.dim() > 1 \
            else loss


class CTCLoss(Loss):
    """≙ ``gluon.loss.CTCLoss``: not ported yet; it comes with
    ``ops/ctc.py``, item 8 (the long tail) of the port's queue."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        raise NotImplementedError(
            "CTCLoss comes with ops/ctc.py, item 8 (the long tail) of the "
            "port's queue of modules; it is not ported yet")


class PoissonNLLLoss(Loss):
    """Negative log-likelihood of a Poisson of rate ``exp(pred)``
    (``from_logits``) or ``pred``; ``compute_full`` adds Stirling's term
    where target > 1.  Returns the mean over every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        p, t = pred, target
        if self._from_logits:
            loss = torch.exp(p) - t * p
        else:
            loss = p - t * torch.log(p + epsilon)
        if self._compute_full:
            stirling = (t * torch.log(t + epsilon) - t +
                        0.5 * torch.log(2 * math.pi * (t + epsilon)))
            loss = loss + torch.where(t > 1, stirling, 0.0)
        return _apply_weight(loss, self._weight, sample_weight).mean()


class SDMLLoss(Loss):
    """Smoothed deep metric learning over a batch of pairs (``x1[i]``
    matches ``x2[i]``): log-softmax of the negative pairwise distances
    against the identity smoothed by ``smoothing_parameter``."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smooth = smoothing_parameter

    def forward(self, x1, x2, sample_weight=None):
        smooth, n = self._smooth, x1.shape[0]
        d = torch.sqrt(((x1[:, None, :] - x2[None, :, :]) ** 2).sum(dim=-1)
                       + 1e-12)
        labels = torch.eye(n, dtype=x1.dtype, device=x1.device)
        labels = labels * (1 - smooth) + (1 - labels) * smooth / (n - 1)
        logp = torch.log_softmax(-d, dim=-1)
        loss = -(labels * logp).sum(dim=-1)
        return self._reduce(loss, sample_weight)
