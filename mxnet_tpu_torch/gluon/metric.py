"""Evaluation metrics (≙ ``mxnet_tpu/gluon/metric.py``).

Inputs are torch tensors on any device, or numpy arrays (or anything
``numpy.asarray`` takes).  The counting metrics keep their running sums
as float64 tensors (the reference's Python floats) and their confusion
counts as int64 tensors on the input's device, so ``update()`` issues
no host synchronisation; ``get()`` reads the sums once.  ``num_inst``
is counted from shapes on the host, and ``sum_metric`` reads the
device sum as a number.  ``PearsonCorrelation`` and ``CustomMetric`` /
:func:`np`, whose ``feval`` is numpy, read their inputs to the host
every update, as the reference does.
"""
from __future__ import annotations

import numpy as _onp
import torch

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "MAE", "MSE", "RMSE",
           "CrossEntropy", "Perplexity", "F1", "MCC", "PearsonCorrelation",
           "Loss", "CompositeEvalMetric", "create", "register",
           "BinaryAccuracy", "Fbeta", "NegativeLogLikelihood",
           "MeanPairwiseDistance", "MeanCosineSimilarity", "PCC",
           "CustomMetric", "np"]

_REGISTRY = {}


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    """A metric from an instance or a registered name."""
    if isinstance(name, EvalMetric):
        return name
    return _REGISTRY[str(name).lower()](**kwargs)


def _np(x):
    """``x`` as a host numpy array (a device tensor is copied)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _onp.asarray(x)


def _t(x):
    """``x`` as a tensor, on its own device when it is one."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(_onp.asarray(x))


def _as_lists(labels, preds):
    if isinstance(labels, (list, tuple)):
        return list(labels), list(preds)
    return [labels], [preds]


class EvalMetric:
    """Base: a running sum (``sum_metric``) over ``num_inst`` instances;
    ``get()`` is their quotient, NaN before any update."""

    def __init__(self, name="metric", output_names=None, label_names=None):
        self.name = name
        self.reset()

    def reset(self):
        self.num_inst = 0
        self._sum = 0.0

    def _add(self, v):
        """Add the tensor ``v`` to the running sum, in float64, on v's
        device (out of place: a sum already read stays as it was)."""
        self._sum = self._sum + v.double()

    @property
    def sum_metric(self):
        s = self._sum
        return s.item() if isinstance(s, torch.Tensor) else s

    @sum_metric.setter
    def sum_metric(self, value):
        self._sum = value

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        return [(name, value)]

    def update_dict(self, labels, preds):
        self.update(list(labels.values()), list(preds.values()))


@register
class Accuracy(EvalMetric):
    """Share of predictions equal to the label; class scores are reduced
    by ``argmax`` over ``axis`` first."""

    def __init__(self, axis=-1, name="accuracy", **kwargs):
        self.axis = axis
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            l, p = _t(l), _t(p)
            if p.dim() > l.dim():
                p = p.argmax(dim=self.axis)
            self._add((p.long() == l.long()).sum())
            self.num_inst += l.numel()


@register
class TopKAccuracy(EvalMetric):
    """Share of labels among the ``top_k`` highest scores."""

    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        self.top_k = top_k
        super().__init__(f"{name}_{top_k}", **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            l, p = _t(l).long(), _t(p)
            top = torch.topk(p, self.top_k, dim=-1).indices
            self._add((top == l[..., None]).any(dim=-1).sum())
            self.num_inst += l.numel()


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            l, p = _t(l), _t(p)
            self._add((l - p).abs().mean().double() * l.shape[0])
            self.num_inst += l.shape[0]


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            l, p = _t(l), _t(p)
            self._add(((l - p) ** 2).mean().double() * l.shape[0])
            self.num_inst += l.shape[0]


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, (self.sum_metric / self.num_inst) ** 0.5


def _label_probs(l, p):
    """The probability each row of the 2-D ``p`` gives its label in the
    flat ``l``; a label in [-n, 0) counts from the end, as numpy's fancy
    index does."""
    l = torch.where(l < 0, l + p.shape[1], l)
    return p.gather(1, l[:, None])[:, 0]


@register
class CrossEntropy(EvalMetric):
    """Mean ``−log(p[label] + eps)`` over the samples (``preds`` are
    probabilities, the last axis the classes)."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            l, p = _t(l).long().reshape(-1), _t(p)
            prob = _label_probs(l, p.reshape(-1, p.shape[-1]))
            self._add(-torch.log(prob + self.eps).sum())
            self.num_inst += prob.shape[0]


@register
class Perplexity(CrossEntropy):
    """``exp`` of the cross-entropy.  ``ignore_label`` is taken and
    ignored, as the reference ignores it."""

    def __init__(self, ignore_label=None, name="perplexity", **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(_onp.exp(self.sum_metric / self.num_inst))


class _Confusion(EvalMetric):
    """Binary confusion counts (tp, fp, fn, tn) as one int64 tensor on the
    input's device; class scores are reduced by ``argmax`` first.
    ``num_inst`` counts the updates, as the reference's does."""

    def reset(self):
        super().reset()
        self._conf = None

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            l, p = _t(l).reshape(-1), _t(p)
            if p.dim() > 1:
                p = p.argmax(dim=-1)
            p = p.reshape(-1)
            p1, p0, l1, l0 = p == 1, p == 0, l == 1, l == 0
            c = torch.stack([(p1 & l1).sum(), (p1 & l0).sum(),
                             (p0 & l1).sum(), (p0 & l0).sum()])
            self._conf = c if self._conf is None else self._conf + c
            self.num_inst += 1

    def confusion(self):
        """(tp, fp, fn, tn) as ints: one read of the device counts."""
        if self._conf is None:
            return 0, 0, 0, 0
        return tuple(int(v) for v in self._conf.tolist())

    @property
    def tp(self):
        return self.confusion()[0]

    @property
    def fp(self):
        return self.confusion()[1]

    @property
    def fn(self):
        return self.confusion()[2]

    @property
    def tn(self):
        return self.confusion()[3]


@register
class F1(_Confusion):
    """F1 of the positive class.  ``average`` is taken and ignored, as the
    reference ignores it."""

    def __init__(self, average="macro", name="f1", **kwargs):
        self.average = average
        super().__init__(name, **kwargs)

    def get(self):
        tp, fp, fn, _ = self.confusion()
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        return self.name, 2 * prec * rec / max(prec + rec, 1e-12)


@register
class MCC(_Confusion):
    """Matthews correlation coefficient of binary predictions."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        tp, fp, fn, tn = self.confusion()
        num = tp * tn - fp * fn
        den = ((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) ** 0.5
        return self.name, num / den if den else 0.0


@register
class PearsonCorrelation(EvalMetric):
    """Pearson's r of every label and prediction seen (kept on the
    host)."""

    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._labels = []
        self._preds = []

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            self._labels.append(_np(l).ravel())
            self._preds.append(_np(p).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        l = _onp.concatenate(self._labels)
        p = _onp.concatenate(self._preds)
        return self.name, float(_onp.corrcoef(l, p)[0, 1])


@register
class Loss(EvalMetric):
    """Mean of the loss values given as ``preds`` (labels unused)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        preds = preds if isinstance(preds, (list, tuple)) else [preds]
        for p in preds:
            p = _t(p)
            self._add(p.sum())
            self.num_inst += p.numel()


@register
class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get()`` gives their names and
    values as two lists."""

    def __init__(self, metrics=None, name="composite", **kwargs):
        self.metrics = [create(m) for m in (metrics or [])]
        super().__init__(name, **kwargs)

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values

    def get_name_value(self):
        out = []
        for m in self.metrics:
            out.extend(m.get_name_value())
        return out


@register
class BinaryAccuracy(EvalMetric):
    """Share of scores on the label's side of ``threshold``."""

    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        self.threshold = threshold
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            l, p = _t(l).reshape(-1), _t(p).reshape(-1)
            self._add(((p > self.threshold).to(l.dtype) == l).sum())
            self.num_inst += l.shape[0]

    def get(self):
        return self.name, self.sum_metric / max(self.num_inst, 1)


@register
class Fbeta(F1):
    """F-score of the positive class with weight ``beta`` on recall."""

    def __init__(self, average="macro", beta=1.0, name="fbeta", **kwargs):
        self.beta = beta
        super().__init__(average=average, name=name, **kwargs)

    def get(self):
        tp, fp, fn, _ = self.confusion()
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        b2 = self.beta * self.beta
        return self.name, (1 + b2) * prec * rec / max(b2 * prec + rec,
                                                      1e-12)


@register
class NegativeLogLikelihood(EvalMetric):
    """Mean ``−log(p[label] + eps)``, ``preds`` reshaped to one row a
    label."""

    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            l = _t(l).long().reshape(-1)
            prob = _label_probs(l, _t(p).reshape(l.shape[0], -1))
            self._add(-torch.log(prob + self.eps).sum())
            self.num_inst += prob.shape[0]

    def get(self):
        return self.name, self.sum_metric / max(self.num_inst, 1)


@register
class MeanPairwiseDistance(EvalMetric):
    """Mean ``p``-norm distance of rows (over the last axis)."""

    def __init__(self, name="mpd", p=2, **kwargs):
        self.p = p
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            l, p = _t(l), _t(p)
            d = ((p - l).abs() ** self.p).sum(dim=-1) ** (1.0 / self.p)
            self._add(d.sum())
            self.num_inst += d.numel()

    def get(self):
        return self.name, self.sum_metric / max(self.num_inst, 1)


@register
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine of rows (over the last axis), ``eps`` added to the
    product of norms."""

    def __init__(self, name="cos_sim", eps=1e-8, **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            l, p = _t(l), _t(p)
            num = (l * p).sum(dim=-1)
            den = torch.sqrt((l * l).sum(dim=-1)) * \
                torch.sqrt((p * p).sum(dim=-1))
            sim = num / (den + self.eps)
            self._add(sim.sum())
            self.num_inst += sim.numel()

    def get(self):
        return self.name, self.sum_metric / max(self.num_inst, 1)


PCC = MCC     # ≙ metric.PCC: the binary case of the multi-class phi
_REGISTRY["pcc"] = MCC


@register
class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays, returning a value or a
    ``(sum, count)`` pair."""

    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        self._feval = feval
        super().__init__(f"custom({name})" if "(" not in name else name,
                         **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for l, p in zip(labels, preds):
            v = self._feval(_np(l), _np(p))
            if isinstance(v, tuple):
                s, n = v
                self._sum += s
                self.num_inst += n
            else:
                self._sum += v
                self.num_inst += 1

    def get(self):
        return self.name, self.sum_metric / max(self.num_inst, 1)


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """≙ ``metric.np``: a :class:`CustomMetric` of a numpy function."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = getattr(numpy_feval, "__name__", name)
    return CustomMetric(feval, name=feval.__name__,
                        allow_extra_outputs=allow_extra_outputs)
