"""INT8 post-training quantization (≙ ``mxnet_tpu/quantization.py``).

The reference's flow and arithmetic: ``quantize_net`` folds every
Conv2D → BatchNorm pair into the conv (numpy f32 on the host), runs the
calibration batches with each quantizable layer's input recorded on the
device (a running max |x| for ``naive``, a 1001-bin histogram of |x|
for ``entropy``, whose KL sweep runs on the host), and swaps each Dense
and Conv2D for an int8 twin holding its pre-quantized weight.

Symmetric int8: ``q = round(x · 127 / T)`` clipped to ±127, ``T`` the
calibrated threshold of the layer's input; weights carry a threshold per
output channel.  The twins run ``ops/nn.py``'s ``quantized_dense`` and
``quantized_conv``; ``QuantizedConv2D.fused_forward`` is the quantized
leg of Gluon's ``fused_conv_bn_relu``, so a quantized ResNet's 3×3/s1
segments run the int8 kernel of ``ops/cuda_int8.py`` with the
dequantization, the folded BN, the residual add and the ReLU in its
epilogue.

The twins keep their int8 weights, scales and biases as buffers (not
parameters, as the reference keeps them out of ``collect_params``):
``.to(device)`` moves them, ``.params`` files do not hold them.  The
fp32 weights cross between the packages as ``.params`` files; a
quantized net's state crosses through :func:`state_from_numpy`.

Calibrating from telemetry: :func:`observe_activations` hooks the same
layers during an ordinary scoring run and publishes each one's input
statistics into the registry (``quant.amax.<layer>`` gauges in fixed
point ×1e6, ``quant.act.<layer>`` histograms of a strided subsample,
``quant.calib.batches``); :func:`thresholds_from_telemetry` reads the
thresholds back from a snapshot.  A ResNet block's 3×3/s1 segments keep
their fused route while observed: ``gluon.nn.fused_conv_bn_relu`` hands
the conv's input to the watching handle, so every layer is seen and the
conv_affine kernel still runs.
"""
from __future__ import annotations

import itertools

import numpy as onp
import torch

from . import telemetry as _telemetry
from .gluon import nn as _gnn
from .gluon.parameter import is_initialized
from .ops import cuda_int8
from .ops import nn as _nn

__all__ = ["quantize_v2", "dequantize", "quantize_net", "QuantizedDense",
           "QuantizedConv2D", "state_from_numpy", "_get_optimal_threshold",
           "observe_activations", "thresholds_from_telemetry"]


# ----------------------------------------------------------------- op layer
def _threshold_scale(t):
    return 127.0 / torch.clamp(t, min=1e-12)


def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """≙ ``quantize_v2``: symmetric int8 against ``max|data|`` or the
    given calibration range → ``(quantized, min_range, max_range)``."""
    if out_type != "int8":
        raise ValueError("the port quantizes to int8")
    x = data.float()
    if min_calib_range is None:
        t = x.abs().max()
    else:
        t = torch.tensor(max(abs(float(min_calib_range)),
                             abs(float(max_calib_range))),
                         dtype=torch.float32, device=x.device)
    q = torch.round(x * _threshold_scale(t)).clamp_(-127, 127).to(
        torch.int8)
    return q, -t, t


def dequantize(qdata, min_range, max_range):
    """≙ ``dequantize``: ``q · T / 127``, ``T = max(|min|, |max|)``."""
    t = torch.maximum(torch.as_tensor(min_range).abs(),
                      torch.as_tensor(max_range).abs())
    return qdata.float() * (t / 127.0)


def _channel_scales(w, axes):
    """Per-output-channel weight quantization: threshold = max|w| over
    ``axes`` (everything but the out-channel dim), scale = 127/T."""
    t_w = onp.maximum(onp.abs(w).max(axis=axes), 1e-8)
    return (127.0 / t_w).astype(onp.float32)


# ------------------------------------------------------------- calibration
def _get_optimal_threshold(arr, num_bins=1001, num_quantized_bins=255):
    """KL-optimal |x| threshold (≙ ``_get_optimal_threshold``): sweep
    thresholds, minimise KL(clipped reference || quantized)."""
    arr = onp.abs(onp.asarray(arr, dtype=onp.float64).ravel())
    amax = arr.max() if arr.size else 0.0
    if amax == 0.0:
        return 1e-8
    hist, _ = onp.histogram(arr, bins=num_bins, range=(0.0, amax))
    return _get_optimal_threshold_from_hist(hist, amax, num_bins,
                                            num_quantized_bins)


def _get_optimal_threshold_from_hist(hist, amax, num_bins=1001,
                                     num_quantized_bins=255):
    """The KL sweep over an |x| histogram spanning [0, amax]."""
    if amax == 0.0:
        return 1e-8
    hist = onp.asarray(hist, dtype=onp.float64)
    edges = onp.linspace(0.0, amax, num_bins + 1)
    best_kl, best_t = onp.inf, amax
    for i in range(num_quantized_bins, num_bins + 1,
                   max(1, (num_bins - num_quantized_bins) // 64)):
        t = edges[i] if i < len(edges) else amax
        p = hist[:i].copy()
        p[-1] += hist[i:].sum()          # clip outliers into the last bin
        if p.sum() == 0:
            continue
        factor = i / num_quantized_bins
        q = onp.zeros(i)
        for j in range(num_quantized_bins):
            lo = int(onp.floor(j * factor))
            hi = int(onp.ceil((j + 1) * factor))
            chunk = hist[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi][chunk > 0] = chunk[chunk > 0].sum() / nz
        if q.sum() == 0:
            continue
        pn = _smooth_distribution(p / p.sum())
        qn = _smooth_distribution(q / q.sum())
        if pn is None or qn is None:
            continue
        kl = (pn * onp.log(pn / qn)).sum()
        if kl < best_kl:
            best_kl, best_t = kl, t
    return float(best_t)


def _smooth_distribution(p, eps=0.0001):
    """Move ``eps`` mass onto the zero bins so KL is finite."""
    is_zeros = p == 0
    n_zeros = int(is_zeros.sum())
    n_nonzeros = p.size - n_zeros
    if n_nonzeros == 0:
        return None
    eps1 = eps * n_zeros / n_nonzeros
    out = p.astype(onp.float64).copy()
    out[is_zeros] = eps
    out[~is_zeros] -= eps1
    if (out[~is_zeros] <= 0).any():
        return None
    return out


class _Collector:
    """Per-layer calibration statistics, reduced on the device: a running
    max |x| (naive) and, for entropy, a 1001-bin histogram of |x| over
    each batch's own range; only scalars and histograms reach the host."""

    _NUM_BINS = 1001

    def __init__(self, mode):
        self.mode = mode
        self.amax = {}
        self.hists = {}

    def add(self, key, x):
        data = x.detach()
        a = data.abs().max().float()
        prev = self.amax.get(key)
        self.amax[key] = a if prev is None else torch.maximum(prev, a)
        if self.mode == "entropy":
            self.hists.setdefault(key, []).append(
                (_abs_hist(data, a, self._NUM_BINS), a))

    def threshold(self, key):
        amax = float(self.amax[key])
        if self.mode != "entropy":
            return amax
        if amax == 0.0:
            return 1e-8
        # each batch's histogram spans its own [0, amax_b]: merge onto the
        # global [0, amax] grid by bin centres
        n = self._NUM_BINS
        merged = onp.zeros(n, onp.float64)
        for h, a in self.hists[key]:
            hb = h.cpu().numpy().astype(onp.float64)
            ab = float(a)
            if ab == 0.0:
                merged[0] += hb.sum()
                continue
            centers = (onp.arange(n) + 0.5) * (ab / n)
            idx = onp.minimum((centers / amax * n).astype(onp.int64), n - 1)
            onp.add.at(merged, idx, hb)
        return _get_optimal_threshold_from_hist(merged, amax)


def _abs_hist(data, amax, num_bins):
    """Histogram of |data| over [0, amax] in ``num_bins`` bins, on the
    data's device, with integer counts (the reference's f32 arithmetic
    for the bin index)."""
    a = data.abs().reshape(-1).float()
    scale = torch.where(amax > 0, num_bins / torch.clamp(amax, min=1e-30),
                        torch.zeros_like(amax))
    idx = (a * scale).to(torch.int32).clamp_(0, num_bins - 1)
    return torch.bincount(idx.long(), minlength=num_bins)


# ------------------------------------------- telemetry-sourced calibration
_Q_FIX = 1e6        # fixed-point scale mapping |x| onto the µs bucket grid


class _ObserveHandle:
    """Uninstaller for :func:`observe_activations` hooks; ``syncs``
    counts the host transfers the hooks made (one a layer and batch)."""

    def __init__(self):
        self._sites = []
        self._amax = {}     # layer path -> running host max |x|
        self.syncs = 0

    def remove(self):
        for child, orig in self._sites:
            child.forward = orig
            child.__dict__.pop("_mx_observe", None)
        self._sites = []


def observe_activations(net, layers=None, sample=None):
    """Hook every quantizable layer (the sites ``quantize_net`` targets)
    to publish its input's statistics into the telemetry registry during
    an ordinary scoring run:

    - ``quant.amax.<layer>`` gauge — the running max |x| in fixed point
      (×1e6), so the minmax threshold survives the int-valued registry
      to 1e-6;
    - ``quant.act.<layer>`` histogram — a strided |x| subsample (512
      values a batch, ``MXNET_QUANT_SAMPLE``) scaled ×1e6 onto the
      registry's bucket grid, the entropy sweep's mass;
    - ``quant.calib.batches`` counter — one a hooked layer and batch.

    A layer's forward is wrapped; a conv that a fused ResNet segment
    runs without calling its forward is watched through
    ``gluon.nn.fused_conv_bn_relu`` instead.  Each layer and batch costs
    one transfer to the host (the max and the subsample together).
    Returns a handle whose ``remove()`` restores the forwards; feed a
    later snapshot to :func:`thresholds_from_telemetry`."""
    import os
    if sample is None:
        sample = int(os.environ.get("MXNET_QUANT_SAMPLE", "") or 512)
    handle = _ObserveHandle()
    for _, child, path in _walk(net):
        if not isinstance(child, _QUANTIZABLE):
            continue
        if layers is not None and path not in layers:
            continue
        orig = child.forward

        def watch(x, _p=path):
            _observe_one(handle, _p, x, sample)

        def hooked(x, _f=orig, _w=watch):
            _w(x)
            return _f(x)
        child.forward = hooked
        child._mx_observe = watch
        handle._sites.append((child, orig))
    return handle


def _observe_one(handle, path, x, sample):
    a = x.detach().abs().reshape(-1)
    stride = max(1, a.numel() // sample)
    # one small transfer a layer and batch: the scalar max and the
    # strided subsample, never the whole activation
    host = torch.cat([a.max().reshape(1).float(),
                      a[::stride][:sample].float()]).cpu().numpy()
    handle.syncs += 1
    amax = float(host[0])
    run = max(handle._amax.get(path, 0.0), amax)
    handle._amax[path] = run
    _telemetry.gauge_set(f"quant.amax.{path}", int(round(run * _Q_FIX)))
    _telemetry._observe_many(f"quant.act.{path}",
                             host[1:].astype(onp.float64) * _Q_FIX)
    _telemetry.counter_add("quant.calib.batches", 1)


def thresholds_from_telemetry(layers=None, mode="naive", snap=None):
    """Per-layer activation thresholds from a telemetry snapshot written
    by :func:`observe_activations` (``snap=`` a serialized or remote
    snapshot; default the live registry).

    ``naive``: ``quant.amax.<layer>`` / 1e6, the in-process minmax to
    1e-6.  ``entropy``: the ``quant.act.<layer>`` bucket histogram spread
    onto the linear 1001-bin KL grid (uniformly within each bucket) and
    swept by ``_get_optimal_threshold_from_hist``, capped at amax."""
    raw = snap if snap is not None else _telemetry.raw_snapshot()
    gauges = raw.get("gauges", {})
    hists = raw.get("histograms", {})
    out = {}
    for key in sorted(gauges):
        if not key.startswith("quant.amax."):
            continue
        layer = key[len("quant.amax."):]
        if layers is not None and layer not in layers:
            continue
        amax = float(gauges[key]) / _Q_FIX
        if mode != "entropy" or amax <= 0.0:
            out[layer] = amax if amax > 0.0 else 1e-8
            continue
        h = hists.get(f"quant.act.{layer}")
        out[layer] = _threshold_from_bucket_hist(h, amax) if h else amax
    return out


def _threshold_from_bucket_hist(h, amax, num_bins=1001):
    """Registry buckets (``le`` bounds in fixed point) → a linear
    [0, amax] histogram → the KL sweep.  Each bucket's count is spread
    uniformly over the linear bins it covers; the overflow bucket clips
    into the last bin."""
    le = [float(b) / _Q_FIX for b in h.get("le", ())]
    counts = list(h.get("counts", ()))
    if not counts or sum(counts) == 0:
        return amax
    lin = onp.zeros(num_bins, onp.float64)
    width = amax / num_bins
    lo = 0.0
    for bound, c in zip(le, counts):
        hi = min(bound, amax)
        if c and hi > lo:
            i0 = min(int(lo / width), num_bins - 1)
            i1 = min(max(int(onp.ceil(hi / width)), i0 + 1), num_bins)
            lin[i0:i1] += c / (i1 - i0)
        lo = bound
        if lo >= amax:
            break
    if len(counts) > len(le) and counts[len(le)]:
        lin[-1] += counts[len(le)]          # +inf overflow bucket
    if lin.sum() == 0:
        return amax
    return min(_get_optimal_threshold_from_hist(lin, amax), amax)


# -------------------------------------------------------- quantized blocks
def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class _Twin(_gnn.HybridBlock):
    """What the two int8 twins share: the quantized weight ``_qw`` in the
    reference's layout and ``_qw_packed``, its K-contiguous form that the
    int8 products take, the per-channel ``_w_scale`` and ``_bias``, all
    buffers (not parameters, as the reference keeps them out of
    ``collect_params``), and the input threshold ``_in_t``."""

    _pack = None        # _qw → _qw_packed

    def _set(self, qw, w_scale, bias, in_t, device=None):
        """Hold ``qw`` (int8), ``w_scale``, ``bias`` (f32 or None) and
        ``in_t`` on ``device`` (default: where the twin's weight is)."""
        dev = device if device is not None else self._qw.device
        qw = torch.from_numpy(onp.array(qw, onp.int8)).to(dev)
        self.register_buffer("_qw", qw, persistent=False)
        self.register_buffer("_qw_packed", type(self)._pack(qw),
                             persistent=False)
        self.register_buffer("_w_scale", torch.from_numpy(
            onp.array(w_scale, onp.float32)).to(dev), persistent=False)
        self.register_buffer("_bias", None if bias is None else
                             torch.from_numpy(onp.array(bias, onp.float32))
                             .to(dev), persistent=False)
        self._in_t = float(in_t)


def _bias_of(layer):
    return None if layer.bias is None else layer.bias.detach().cpu().numpy()


class QuantizedDense(_Twin):
    """int8 twin of ``Dense`` (≙ ``QuantizedDense``): the weight
    quantized per output channel and transposed to ``(in, units)``;
    ``_qw_packed`` is its contiguous transpose ``(units, in)``."""

    _pack = staticmethod(lambda qw: qw.t().contiguous())

    def __init__(self, dense, in_threshold, **kwargs):
        super().__init__(**kwargs)
        w = dense.weight.detach().cpu().numpy()           # (units, in)
        s_w = _channel_scales(w, axes=1)
        qw = onp.clip(onp.round(w * s_w[:, None]), -127,
                      127).astype(onp.int8).T
        self._set(qw, s_w, _bias_of(dense), in_threshold,
                  dense.weight.device)
        self._flatten = dense._flatten
        self._act = dense.act

    def forward(self, x):
        return _nn.quantized_dense(x, self._qw, self._w_scale, self._bias,
                                   in_t=self._in_t, flatten=self._flatten,
                                   act=self._act, qw_packed=self._qw_packed)


class QuantizedConv2D(_Twin):
    """int8 twin of ``Conv2D`` (≙ ``QuantizedConv2D``): the HWIO weight
    quantized per output channel; ``_qw_packed`` is its ``(Cout,
    kh·kw·C)`` form for the kernel; ``_bias`` is the folded BN after
    ``_fold_batchnorm``.  :meth:`fused_forward` is the quantized leg of
    ``fused_conv_bn_relu``."""

    # the duck-typed marker Gluon's fused_conv_bn_relu routes on
    _mx_quantized_fused = True
    _pack = staticmethod(cuda_int8.pack_weight)

    def __init__(self, conv, in_threshold, **kwargs):
        super().__init__(**kwargs)
        w = conv.weight.detach().cpu().numpy()            # HWIO
        s_w = _channel_scales(w, axes=(0, 1, 2))
        qw = onp.clip(onp.round(w * s_w), -127, 127).astype(onp.int8)
        self._set(qw, s_w, _bias_of(conv), in_threshold, conv.weight.device)
        self._stride = _pair(conv._strides)
        self._pad = _pair(conv._padding)
        self._dilate = _pair(conv._dilation)
        self._groups = conv._groups
        self._act = conv.act

    def _conv(self, x, residual, relu, act):
        return _nn.quantized_conv(
            x, self._qw, self._w_scale, self._bias, residual,
            in_t=self._in_t, stride=self._stride, pad=self._pad,
            dilate=self._dilate, groups=self._groups, relu=relu, act=act,
            qw_packed=self._qw_packed)

    def forward(self, x):
        return self._conv(x, None, False, self._act)

    def fused_forward(self, x, residual=None, relu=True):
        """conv + dequant + bias (the folded BN) (+ residual) (+ ReLU) in
        one pass: the int8 kernel's epilogue on the 3×3/s1 segments."""
        return self._conv(x, residual, relu, None)


# ------------------------------------------------------------ quantize_net
_QUANTIZABLE = (_gnn.Dense, _gnn.Conv2D)


def _walk(block, prefix="", visited=None):
    """``(parent, child, dotted path)`` of every Block below ``block``,
    depth first in registration order (the reference's ``vars`` order,
    so the paths are the reference's: ``features.4.0.body.3``)."""
    visited = set() if visited is None else visited
    for name, child in list(block._modules.items()):
        if isinstance(child, _gnn.Block) and id(child) not in visited:
            visited.add(id(child))
            yield block, child, f"{prefix}{name}"
            yield from _walk(child, f"{prefix}{name}.", visited)


def _replace(parent, old, new):
    """Swap ``old`` for ``new`` in every slot of ``parent``: its child
    modules and a Sequential's ``_layers``."""
    for name, val in list(parent._modules.items()):
        if val is old:
            setattr(parent, name, new)
    layers = getattr(parent, "_layers", None)
    if layers is not None:
        parent._layers = [new if c is old else c for c in layers]


class _Identity(_gnn.HybridBlock):
    """Placeholder for a BatchNorm folded into the preceding conv."""

    def forward(self, x):
        return x


def _fold_batchnorm(net):
    """Fold Conv2D → BatchNorm pairs (inference): the BN's affine goes
    into the conv's weight and bias, in numpy f32 as the reference folds
    (``γ / sqrt(σ² + ε)``), and the BN becomes ``_Identity``."""
    containers = [net] + [c for _, c, _ in _walk(net)]
    for cont in containers:
        layers = getattr(cont, "_layers", None)
        if not layers:
            continue
        for i in range(len(layers) - 1):
            conv, bn = layers[i], layers[i + 1]
            if not (isinstance(conv, _gnn.Conv2D) and
                    isinstance(bn, _gnn.BatchNorm)):
                continue
            if conv.act is not None:
                continue    # the activation runs before the BN
            if not (is_initialized(bn.gamma) and
                    is_initialized(conv.weight)):
                continue    # deferred shapes: no forward has run
            gamma = bn.gamma.detach().cpu().numpy()
            beta = bn.beta.detach().cpu().numpy()
            mean = bn.running_mean.detach().cpu().numpy()
            var = bn.running_var.detach().cpu().numpy()
            scale = gamma / onp.sqrt(var + bn._eps)
            w = conv.weight.detach().cpu().numpy()       # HWIO, Cout last
            dev = conv.weight.device
            b0 = conv.bias.detach().cpu().numpy() if conv.bias is not None \
                else onp.zeros_like(beta)
            new_b = beta + (b0 - mean) * scale
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(w * scale))
                if conv.bias is not None:
                    conv.bias.copy_(torch.from_numpy(new_b))
                else:
                    conv.bias = torch.nn.Parameter(
                        torch.from_numpy(new_b).to(dev))
            _replace(cont, bn, _Identity())
    return net


def _device(net):
    for t in itertools.chain(net.parameters(), net.buffers()):
        return t.device
    return torch.device("cpu")


def _batch(b, device):
    x = b[0] if isinstance(b, (tuple, list)) else b
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def quantize_net(net, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=None,
                 fold_bn=True, thresholds=None, logger=None):
    """≙ ``quantize_net``.  Mutates ``net`` in place: Conv2D → BatchNorm
    pairs fold first (``fold_bn``), then every Dense and Conv2D whose
    path is not in ``exclude_layers`` becomes an int8 twin, its input
    threshold taken from ``thresholds`` (layer path → T) or calibrated on
    ``calib_data`` (``naive`` max |x|, ``entropy`` KL) on the net's
    device; ``calib_mode="none"`` uses T = 1.  The calibration forwards
    run every segment layer by layer (``gluon.nn._layer_by_layer``), so
    each layer's input is recorded, as the reference switches its fused
    block route off for them.  Returns ``net``."""
    if quantized_dtype != "int8":
        raise ValueError("the port quantizes to int8")
    if calib_mode not in ("naive", "entropy", "none"):
        raise ValueError(f"calib_mode {calib_mode!r}")
    exclude = set(exclude_layers or [])
    thresholds = dict(thresholds or {})
    if calib_mode != "none" and calib_data is None and not thresholds:
        raise ValueError(
            f"calib_mode={calib_mode!r} needs calib_data or thresholds")
    first_batch = None
    if calib_data is not None:
        it = iter(calib_data)
        first_batch = next(it, None)
        calib_data = itertools.chain([first_batch], it) \
            if first_batch is not None else []
    device = _device(net)
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad(), _gnn._layer_by_layer():
            if fold_bn:
                if first_batch is not None:
                    net(_batch(first_batch, device))   # deferred shapes
                _fold_batchnorm(net)
            sites = [(p, c, path) for p, c, path in _walk(net)
                     if isinstance(c, _QUANTIZABLE) and path not in exclude]
            if not sites:
                return net
            collector = _Collector(
                "entropy" if calib_mode == "entropy" else "naive")
            uncovered = [s for s in sites if s[2] not in thresholds]
            if calib_mode != "none" and uncovered and calib_data is None:
                raise ValueError(
                    "thresholds= misses layer(s) "
                    f"{[p for _, _, p in uncovered]} and no calib_data given")
            if calib_mode != "none" and uncovered:
                def record(path):
                    def hook(mod, args):
                        collector.add(path, args[0])
                    return hook
                hooks = [child.register_forward_pre_hook(record(path))
                         for _, child, path in uncovered]
                try:
                    for b in calib_data:
                        net(_batch(b, device))
                finally:
                    for h in hooks:
                        h.remove()
            for parent, child, path in sites:
                if path in thresholds:
                    t = float(thresholds[path])
                else:
                    t = collector.threshold(path) \
                        if calib_mode != "none" else 1.0
                twin = (QuantizedDense(child, t)
                        if isinstance(child, _gnn.Dense)
                        else QuantizedConv2D(child, t))
                _replace(parent, child, twin)
    finally:
        net.train(was_training)
    return net


def state_from_numpy(net, state):
    """Load ``{layer path: {"qw", "w_scale", "bias", "in_t"}}`` into the
    twins of a net quantized with the same structure, e.g. the JAX
    package's twins read as ``{"qw": b._qw, "w_scale": b._w_scale,
    "bias": b._bias, "in_t": b._in_t}`` (arrays as numpy; ``bias`` may be
    None).  Raises ``KeyError`` when the twins and the keys differ."""
    twins = {path: b for _, b, path in _walk(net) if isinstance(b, _Twin)}
    if set(twins) != set(state):
        raise KeyError(f"twins {sorted(set(twins) - set(state))[:5]} have "
                       f"no state; states "
                       f"{sorted(set(state) - set(twins))[:5]} have no twin")
    for path, st in state.items():
        twins[path]._set(st["qw"], st["w_scale"], st.get("bias"),
                         st["in_t"])
    return net
