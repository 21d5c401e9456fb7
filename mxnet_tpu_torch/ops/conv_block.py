"""The fused 3×3/s1 conv + BatchNorm (+ residual add) (+ ReLU) block:
its hand-written CUDA kernels, their plain versions, and the autograd
Function that trains through them (≙ ``mxnet_tpu/ops/pallas_block.py``).

- ``conv3x3`` (≙ ``_conv_kernel``, ``conv3x3``; ``conv3x3_dgrad`` runs it
  on the rotated weight), ``conv_stats`` (≙ ``_conv_stats_kernel``,
  ``_conv_stats``; the same kernel body with a statistics epilogue) and
  ``conv_affine`` (≙ ``_conv_affine_kernel``, ``_conv_affine``, ``_fold``,
  the frozen ``_fused_fwd``; the same body with a folded frozen BN (+ add)
  (+ ReLU) epilogue): one tensor-core loop in ``csrc/conv3x3_tc.cu``, each
  instance's work cut by :func:`conv3x3_splits` at its own occupancy,
  and :func:`tile_writers` the host's view of which kernel finishes each
  tile; ``bn_affine`` (≙ ``_affine_kernel``,
  ``_affine``): ``csrc/conv_train.cu``; ``conv_wgrad`` (≙
  ``_wgrad_kernel``, ``conv3x3_wgrad``): ``csrc/conv_wgrad.cu``.
- ``residual_block_fused`` (≙ ``residual_block_fused``, ``_fused``,
  ``_fused_fwd``, ``_fused_bwd``, ``_conv_bwd``, ``_sums``): training
  (batch statistics) and frozen forward, and their backward.

Every kernel has an fp32, a bf16 and an fp16 instance (the reference's
kernels take any input dtype and accumulate in f32): half operands are
exact products summed in fp32, each output rounded once to the
operands' type (fp16 overflowing to ±inf past 65504 as the reference's
cast does, its subnormals kept); the statistics, the affine's scale and
shift and dW stay fp32, and ``conv_affine`` takes each BatchNorm vector
in x's dtype or in fp32 (a half step keeps its running statistics
fp32).  On each half type, ``conv3x3`` (and so the dgrad),
``conv_stats``, ``conv_affine`` and ``conv_wgrad`` have two instances,
chosen by shape before the launch (:func:`wgmma_takes`): where C and
Cout are multiples of 8 and every tensor is 16-byte aligned (every
ResNet-50 and Inception-v3 shape), the Hopper kernels of
``csrc/conv_bf16_wgmma.cu`` (``wgmma`` products on tiles that TMA copies
into a ring of stages; the conv with no epilogue, a statistics one or a
folded-BatchNorm one, and dW); other shapes (C = 20, say) the
``mma.sync`` instances of ``conv3x3_tc.cu`` and ``conv_wgrad.cu``.
Other dtypes (float64, integers) raise ``TypeError`` on the card; the
plain versions take any float dtype, a half one widened to fp32 and the
result rounded once, as the half instances compute it.  ``launches``
counts a wrapper's launches; the four conv wrappers, which have two
kernels on each half type, count each kernel's in
``launches_by_instance`` (:data:`INSTANCES`: ``fp32``,
``bf16_mma_sync``, ``bf16_wgmma``, ``fp16_mma_sync``, ``fp16_wgmma``),
and ``bn_affine`` each dtype's in ``launches_by_dtype``.

See the notes at the top of the ``.cu`` files for bounds and designs.
Each wrapper launches its kernel for CUDA tensors and raises on anything
the kernel does not take; CPU tensors take the ``*_plain`` version.
There is no other route: the TPU package's VMEM gate (``eligible_block``)
and its per-stage A/B table are budgets of the TPU, and on the card every
3×3/s1 segment goes to the kernels.  Layouts are the JAX package's:
activations NHWC, the weight HWIO ``(3, 3, C, Cout)``, all contiguous
(the callers make them so).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build

__all__ = ["conv_affine", "conv_affine_plain", "fold", "conv3x3",
           "conv3x3_plain", "conv3x3_dgrad", "conv3x3_splits",
           "Conv3x3Plan", "tile_writers", "rotate", "conv_stats",
           "conv_stats_plain", "bn_affine",
           "bn_affine_plain", "conv_wgrad",
           "conv_wgrad_plain", "wgrad_splits", "wgrad_tile_cols",
           "WgradPlan", "wgmma_takes", "WGMMA_SLAB", "map_cache_stats",
           "residual_block_fused"]

_count_mu = threading.Lock()
_HALF = (torch.bfloat16, torch.float16)
# a half dtype's instance name (launches_by_instance) and the suffix of
# its C entries
HALF_NAMES = {torch.bfloat16: "bf16", torch.float16: "fp16"}
_ENTRY = {torch.bfloat16: "bf16", torch.float16: "f16"}
# each wgmma operation's C entry and count key by half dtype, made once
# (these wrappers run on eager paths, where the host's µs are the call's)
_WGMMA = {(op, dt): (f"mxt_{op}_wgmma_{_ENTRY[dt]}", f"{half}_wgmma")
          for op in ("conv3x3", "conv_stats", "conv_affine", "conv_wgrad")
          for dt, half in HALF_NAMES.items()}


def _wide(t):
    """A half tensor widened to fp32; any other as it is."""
    return t.float() if t.dtype in _HALF else t


# the kernels behind conv3x3, conv_stats, conv_affine and conv_wgrad, as
# launches_by_instance names them
INSTANCES = ("fp32", "bf16_mma_sync", "bf16_wgmma", "fp16_mma_sync",
             "fp16_wgmma")


def _count(fn, key):
    """One launch of ``fn``'s instance ``key``: its dtype or, for a
    wrapper with several kernels on a dtype, the kernel's name
    (:data:`INSTANCES`)."""
    with _count_mu:
        fn.launches += 1
        by = fn.launches_by_instance if hasattr(
            fn, "launches_by_instance") else fn.launches_by_dtype
        by[key] += 1


def _counted(fn):
    """Give a wrapper its counts: every launch, and each dtype's."""
    fn.launches = 0
    fn.launches_by_dtype = {torch.float32: 0, torch.bfloat16: 0,
                            torch.float16: 0}
    return fn


def _instanced(fn):
    """Give a wrapper with several kernels on one dtype its counts: every
    launch, and each kernel's (:data:`INSTANCES`; a dtype's is their
    sum)."""
    fn.launches = 0
    fn.launches_by_instance = dict.fromkeys(INSTANCES, 0)
    return fn


def _card_half(what, x):
    """The instance of the kernel x's dtype takes: ``"bf16"`` or
    ``"fp16"`` (:data:`HALF_NAMES`), or None for fp32; raise on any
    other dtype (float64, integers: no instance takes them)."""
    if x.dtype == torch.float32:
        return None
    half = HALF_NAMES.get(x.dtype)
    if half is None:
        raise TypeError(f"{what}: x must be float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    return half


def fold(gamma, beta, mean, var, eps: float = 1e-5):
    """Frozen BN as a per-channel affine, in f32 as ``_fold`` computes it:
    ``scale = γ·rsqrt(σ²+ε)``, ``shift = β − μ·scale``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def conv_affine_plain(x, w, gamma, beta, mean, var, residual=None,
                      eps: float = 1e-5, relu: bool = True):
    """Plain PyTorch version of the kernel: 3×3/s1/p1 conv of NHWC ``x``
    with HWIO ``w``, then ``·scale + shift``, ``+ residual``, ReLU.  On a
    half dtype (the kernel's bf16 and fp16 instances, ≙
    ``_conv_affine_kernel`` on half operands): everything widened to
    fp32, where the products of half values are exact, the conv in fp32
    (the card's TF32 switched off by ``context.exact_fp32``), the same
    fold from the vectors in either dtype, and one rounding to x's
    dtype."""
    if x.dtype in _HALF:
        out = conv_affine_plain(
            x.float(), w.float(), gamma, beta, mean, var,
            None if residual is None else residual.float(), eps, relu)
        return out.to(x.dtype)
    scale, shift = fold(gamma, beta, mean, var, eps)
    z = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    y = z * scale + shift
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _same(what, x, named, dtype=torch.float32, also=None):
    """Every tensor of ``named`` on x's device, of ``dtype`` (or of
    ``also``) and contiguous."""
    dev = x.device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{dev}")
        if t.dtype != dtype and t.dtype != also:
            raise TypeError(f"{what}: {name} must be "
                            f"{str(dtype).rpartition('.')[2]}"
                            f"{' or float32' if also else ''}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous "
                             f"({'NHWC' if t.dim() == 4 else 'dense'})")


def _check(x, w, vecs, residual, what="conv_affine", dtype=torch.float32):
    """Refuse what the kernel does not take (every tensor of ``dtype``;
    each BatchNorm vector of ``vecs`` of ``dtype`` or fp32); → (N, H, W,
    C, Cout)."""
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be NHWC, got {tuple(x.shape)}")
    N, H, W, C = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"{what}: w must be (3, 3, {C}, Cout) HWIO, "
                         f"got {tuple(w.shape)}")
    Cout = w.shape[3]
    named = [("x", x), ("w", w), *vecs]
    if residual is not None:
        if tuple(residual.shape) != (N, H, W, Cout):
            raise ValueError(f"{what}: residual must be "
                             f"{(N, H, W, Cout)}, got "
                             f"{tuple(residual.shape)}")
        named.append(("residual", residual))
    for name, t in vecs:
        if tuple(t.shape) != (Cout,):
            raise ValueError(f"{what}: {name} must be ({Cout},), got "
                             f"{tuple(t.shape)}")
    if dtype is torch.float32:
        _same(what, x, named, dtype)
    else:
        _same(what, x, named, dtype, torch.float32)
        strict = [("w", w)] + ([("residual", residual)] if residual is not
                               None and residual.dtype is not dtype else [])
        if w.dtype is not dtype or len(strict) > 1:
            _same(what, x, strict, dtype)   # only the vectors may be fp32
    return N, H, W, C, Cout


def _on_card(what, x):
    """True for a CUDA tensor, False for a CPU one; raise otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return True


def _aligned(*ts):
    return all(t.data_ptr() % 16 == 0 for t in ts)


WGMMA_SLAB = 64     # channels a TMA box of the wgmma kernels holds (128 B)


def wgmma_takes(C, Cout, *tensors):
    """True where a half ``conv3x3``, ``conv_stats``, ``conv_affine`` or
    ``conv_wgrad`` of ``C`` input and ``Cout`` output channels on
    ``tensors`` (their images, weights, outputs and residual) launches the
    ``wgmma`` kernels of ``csrc/conv_bf16_wgmma.cu``: TMA wants 16-byte
    strides (C % 8 == 0, Cout % 8 == 0) and 16-byte aligned bases; the
    same on bf16 and fp16.  Decided from the shapes and pointers before
    the launch; the other half shapes launch the ``mma.sync``
    instances."""
    return C % 8 == 0 and Cout % 8 == 0 and _aligned(*tensors)


def _slabs(C):
    """64-channel slabs a tap of the wgmma kernels: ceil(C / 64)."""
    return -(-C // WGMMA_SLAB)


def map_cache_stats():
    """The ``wgmma`` kernels' tensor-map cache since the library was
    loaded: ``{"hits", "misses", "entries"}`` (a hit reuses the map of an
    earlier call with the same pointer, shape and box)."""
    out = (ctypes.c_longlong * 3)()
    _build.check(_build.lib().mxt_wgmma_map_cache_stats(out),
                 "mxt_wgmma_map_cache_stats")
    return dict(zip(("hits", "misses", "entries"), out))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# The wgmma wrappers' launch helpers: the same as torch.cuda.device,
# _stream and torch.empty, at less host cost (these kernels run on eager
# serving paths, where the host's time per call is the forward's).
def _device(dev):
    """A context in which card ``dev`` is the current device (no switch
    where it already is)."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev.index)


def _raw_stream(dev):
    """The handle of card ``dev``'s current stream."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


_scratch = threading.local()


def _part(dev, shape):
    """fp32 scratch of at least ``shape``'s size for the partial sums of
    a launch on the current stream of card ``dev`` (the current device):
    one buffer for each thread, card and stream, grown as needed and
    reused, since the stream runs a launch's kernels after those of the
    one before; a fresh one while a graph is captured (its pool keeps
    it)."""
    n = 1
    for d in shape:
        n *= d
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(n, device=dev, dtype=torch.float32)
    bufs = _scratch.__dict__.setdefault("bufs", {})
    key = (dev.index, _raw_stream(dev))
    buf = bufs.get(key)
    if buf is None or buf.numel() < n:
        buf = bufs[key] = torch.empty(n, device=dev, dtype=torch.float32)
    return buf


def conv3x3_plain(x, w):
    """Plain version of ``conv3x3``: the 3×3/s1/p1 conv of NHWC ``x`` with
    HWIO ``w``, contiguous NHWC as the kernel writes it; half operands
    widened to fp32 (their products exact there), the fp32 conv rounded
    once to x's dtype."""
    if x.dtype in _HALF:
        return conv3x3_plain(x.float(), w.float()).to(x.dtype)
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1).contiguous()


CONV_ROWS = 128     # output pixels a conv3x3 tile
CONV_CHUNK = 32     # patch columns (k = tap·C + c) a chunk of its reduction


class Conv3x3Plan(NamedTuple):
    """How ``conv3x3`` cuts its work: ``tiles`` output tiles of 128
    pixels × ``bn`` channels, each a reduction over ``chunks`` chunks of
    32 patch columns; the tiles × chunks units are cut into ``ranges``
    ranges of whole chunks, one a block.  A range's segment that covers a
    whole tile writes it out; a cut tile's segments write partial slots
    (a range's first segment to slot 2b, its last to 2b + 1) that a
    second kernel sums in range order."""
    bn: int
    tiles: int
    chunks: int
    ranges: int


def conv3x3_splits(M, K, Cout, sms, per_sm, chunk=CONV_CHUNK):
    """The :class:`Conv3x3Plan` of ``conv3x3`` for ``M`` output pixels,
    ``K`` = 9C patch columns and ``Cout`` channels on a card of ``sms`` SMs
    that holds ``per_sm`` of its blocks each: exactly ``sms·per_sm`` ranges
    of near-equal work (one full wave; fewer only when there are fewer
    units), each whole chunks of ``chunk`` patch columns (stream-K: at
    7×7×512, batch 64, the 100 tiles alone would leave 32 of 132 SMs
    idle).  Range ``b`` holds units ``[b·T/ranges, (b+1)·T/ranges)`` of
    the ``T`` = tiles·chunks (unit = tile·chunks + chunk).  The wgmma
    kernel's chunk is one tap's 64-channel slab: ``K`` = 9·64·ceil(C/64),
    ``chunk`` = 64."""
    bn = wgrad_tile_cols(Cout)
    tiles = -(-M // CONV_ROWS) * -(-Cout // bn)
    chunks = -(-K // chunk)
    return Conv3x3Plan(bn, tiles, chunks,
                       max(1, min(sms * per_sm, tiles * chunks)))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _per_sm(entry, index, bn, vec):
    """Blocks of the ``(bn, vec)`` kernel behind ``entry`` (its
    ``mxt_*_blocks_per_sm``) an SM of card ``index`` holds, from the
    occupancy API."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(getattr(_build.lib(), entry)(bn, vec,
                                                  ctypes.byref(out)), entry)
    if out.value < 1:
        raise RuntimeError(f"{entry}: the (bn={bn}, vec={vec}) kernel fits "
                           f"no block on an SM")
    return out.value


@_instanced
def conv3x3(x, w):
    """3×3/s1/p1 conv with no epilogue, ``x`` (N, H, W, C) and ``w``
    (3, 3, C, Cout) contiguous, both fp32, both bf16 or both fp16: an
    implicit GEMM on the tensor cores, its work cut into one wave of
    ranges (:func:`conv3x3_splits`, at the instance's own occupancy)
    whose cut tiles are summed in a fixed order.  fp32: 3×TF32,
    fp32-accurate (``csrc/conv3x3_tc.cu``).  bf16 and fp16: exact half
    products, fp32 sums, one rounding at the store; where
    :func:`wgmma_takes` the shape (C and Cout multiples of 8, 16-byte
    aligned tensors) the ``wgmma`` kernel of ``csrc/conv_bf16_wgmma.cu``
    (x by TMA im2col loads, chunks of one tap's 64-channel slab), else
    the ``mma.sync`` instance of ``conv3x3_tc.cu``.  CPU tensors take
    :func:`conv3x3_plain`."""
    if not _on_card("conv3x3", x):
        return conv3x3_plain(x, w)
    half = _card_half("conv3x3", x)
    N, H, W, C, Cout = _check(x, w, (), None, "conv3x3", x.dtype)
    out = torch.empty((N, H, W, Cout), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    if half and wgmma_takes(C, Cout, x, w, out):
        return _conv3x3_wgmma(x, w, out)
    return _conv3x3_tc(x, w, out)


def _wgmma_per_sm(op, index, bn, dtype):
    """Blocks of the ``wgmma`` kernel of ``op`` on half ``dtype`` an SM of
    card ``index`` holds (``mxt_<op>_wgmma[_f16]_blocks_per_sm``)."""
    f16 = "_f16" if dtype == torch.float16 else ""
    return _per_sm(f"mxt_{op}_wgmma{f16}_blocks_per_sm", index, bn, 1)


@functools.lru_cache(maxsize=256)
def _wgmma_conv_plan(op, index, M, C, Cout, dtype=torch.bfloat16):
    """The plan of the ``wgmma`` conv kernel ``op`` (``conv3x3``,
    ``conv_stats``, ``conv_affine``) on half ``dtype`` for ``M`` pixels on
    card ``index``: :func:`conv3x3_splits` with chunks of one tap's
    64-channel slab, at the kernel's own occupancy
    (:func:`_wgmma_per_sm`)."""
    bn = wgrad_tile_cols(Cout)
    return conv3x3_splits(M, 9 * WGMMA_SLAB * _slabs(C), Cout,
                          _sm_count(index),
                          _wgmma_per_sm(op, index, bn, dtype),
                          chunk=WGMMA_SLAB)


def _conv3x3_wgmma(x, w, out):
    """Launch ``csrc/conv_bf16_wgmma.cu``'s conv3x3 (x's half type) into
    ``out``."""
    N, H, W, C = x.shape
    Cout = w.shape[3]
    dt = x.dtype
    plan = _wgmma_conv_plan("conv3x3", x.device.index, N * H * W, C, Cout,
                            dt)
    with _device(x.device):
        part = _part(x.device, (2 * plan.ranges, CONV_ROWS, plan.bn))
        entry, key = _WGMMA["conv3x3", dt]
        err = getattr(_build.lib(), entry)(
            x.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(),
            N, H, W, C, Cout, plan.bn, plan.ranges, _raw_stream(x.device))
    _build.check(err, "conv3x3")
    _count(conv3x3, key)
    return out


def _tc_instance(x, fp32_entry, entry, C, Cout, *tensors):
    """The ``mma.sync`` (or fp32) instance x's dtype takes: → (its C
    entry, ``fp32_entry`` or ``entry`` with the half type's suffix for
    ``{}``; its count key; ``vec``, 1 where C and Cout are multiples of
    the values a 16-byte copy moves and ``tensors`` are aligned)."""
    if x.dtype == torch.float32:
        key, name, wide = "fp32", fp32_entry, 4
    else:
        key = HALF_NAMES[x.dtype] + "_mma_sync"
        name, wide = entry.format(_ENTRY[x.dtype]), 8
    return name, key, int(C % wide == 0 and Cout % wide == 0 and
                          _aligned(*tensors))


def _conv3x3_tc(x, w, out):
    """Launch ``csrc/conv3x3_tc.cu``'s conv3x3 (fp32, or a half type on
    ``mma.sync``) into ``out``."""
    N, H, W, C = x.shape
    Cout = w.shape[3]
    entry, key, vec = _tc_instance(x, "mxt_conv3x3_tc_f32",
                                   "mxt_conv3x3_tc_{}", C, Cout, x, w, out)
    per_sm = ("mxt_conv3x3_tc_blocks_per_sm" if key == "fp32" else
              f"mxt_conv3x3_{_ENTRY[x.dtype]}_blocks_per_sm")
    index = x.device.index
    plan = conv3x3_splits(N * H * W, 9 * C, Cout, _sm_count(index),
                          _per_sm(per_sm, index, wgrad_tile_cols(Cout), vec))
    part = torch.empty((2 * plan.ranges, CONV_ROWS, plan.bn),
                       device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = getattr(_build.lib(), entry)(
            x.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(),
            N, H, W, C, Cout, plan.bn, plan.ranges, vec, _stream(x.device))
    _build.check(err, "conv3x3")
    _count(conv3x3, key)
    return out


def rotate(w):
    """The dgrad weight of HWIO ``w`` (3, 3, C, Cout): rotated 180° in
    both spatial axes and IO-transposed, (3, 3, Cout, C), contiguous."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def conv3x3_dgrad(w, dy):
    """dx = ``conv3x3(dy, rotate(w))`` (≙ ``pallas_block.conv3x3_dgrad``,
    which casts the rotated weight to dy's dtype)."""
    return conv3x3(dy, rotate(w).to(dy.dtype))


def conv_stats_plain(x, w):
    """Plain version of ``conv_stats``: ``(z, Σz, Σz²)``, the sums per
    output channel over every pixel.  Half operands: the conv and the
    sums in fp32 from the widened operands, then z rounded once to x's
    dtype (the sums are of z before its rounding)."""
    if x.dtype in _HALF:
        z, s1, s2 = conv_stats_plain(x.float(), w.float())
        return z.to(x.dtype), s1, s2
    z = conv3x3_plain(x, w)
    return z, z.sum(dim=(0, 1, 2)), (z * z).sum(dim=(0, 1, 2))


def tile_writers(plan):
    """Which kernel finishes each output tile under ``plan`` (a
    :class:`Conv3x3Plan`, or ``cuda_int8``'s plan of the same fields),
    decided as ``csrc/conv3x3_tc.cu`` and ``csrc/qconv_affine.cu`` decide
    it: one ``(tile, kernel, block)`` for each tile.  ``("main", b)``:
    range ``b`` of the main kernel covers the whole tile in one segment
    and finishes it from its accumulator (``conv_stats``: its row of
    per-tile sums; ``conv_affine`` and ``qconv3x3_affine``: its
    epilogue).  ``("cut", j)``: range ``j`` holds the tile's first unit
    and range ``j + 1`` starts inside it; the cut-tile kernel finishes it
    from its summed slots (block ``j`` of ``conv_stats_cut_kernel``,
    blocks ``(·, j)`` of ``conv3x3_reduce_kernel`` and
    ``conv_affine_reduce_kernel``, blocks ``(·, tile)`` of
    ``qconv_reduce_kernel``).  A plan with a ``grain`` (``QconvPlan``)
    starts its ranges on multiples of it; others on any unit."""
    total, ranges, nch = plan.tiles * plan.chunks, plan.ranges, plan.chunks
    g = getattr(plan, "grain", 1)

    def start(b):
        return b * (total // g) // ranges * g

    def range_of(u):
        return ((u // g + 1) * ranges - 1) // (total // g)

    writes = []
    for b in range(ranges):
        u, u1 = start(b), start(b + 1)
        while u < u1:
            tile = u // nch
            send = min(u1, (tile + 1) * nch)
            if u == tile * nch and send == (tile + 1) * nch:
                writes.append((tile, "main", b))
            u = send
    for r in range(1, ranges):
        sr = start(r)
        if sr % nch and range_of(sr // nch * nch) == r - 1:
            writes.append((sr // nch, "cut", r - 1))
    return writes


@_instanced
def conv_stats(x, w):
    """``(z, Σz, Σz²)``: the conv of :func:`conv3x3`, on the same
    tensor-core loop with a statistics epilogue, and its per-channel sums
    (f32, (Cout,) each) read off the fp32 accumulator (bf16, fp16: before
    z is rounded, so an fp16 z past 65504 is inf and its sums finite):
    per 128-pixel tile in a fixed order, then over the tiles in a fixed
    order, so the three are the same on every run (:func:`tile_writers`
    names the kernel that sums each tile).  fp32: ``csrc/conv3x3_tc.cu``'s
    3×TF32 loop.  bf16 and fp16: where :func:`wgmma_takes` the shape, the
    ``wgmma`` kernel of ``csrc/conv_bf16_wgmma.cu``, else the ``mma.sync``
    instance of ``conv3x3_tc.cu``.  Its plan is
    :func:`conv3x3_splits` at the occupancy of the statistics instance;
    where that equals ``conv3x3``'s plan, z is ``conv3x3(x, w)`` bit for
    bit.  CPU tensors take :func:`conv_stats_plain`."""
    if not _on_card("conv_stats", x):
        return conv_stats_plain(x, w)
    half = _card_half("conv_stats", x)
    N, H, W, C, Cout = _check(x, w, (), None, "conv_stats", x.dtype)
    z = torch.empty((N, H, W, Cout), device=x.device, dtype=x.dtype)
    if z.numel() == 0:
        stats = torch.zeros((2, Cout), device=x.device, dtype=torch.float32)
        return z, stats[0], stats[1]
    stats = torch.empty((2, Cout), device=x.device, dtype=torch.float32)
    if half and wgmma_takes(C, Cout, x, w, z):
        _conv_stats_wgmma(x, w, z, stats)
    else:
        tstats = torch.empty((-(-(N * H * W) // CONV_ROWS), 2, Cout),
                             device=x.device, dtype=torch.float32)
        _conv_stats_tc(x, w, z, tstats, stats)
    return z, stats[0], stats[1]


def _conv_stats_wgmma(x, w, z, stats):
    """Launch ``csrc/conv_bf16_wgmma.cu``'s conv_stats (x's half type)
    into ``z`` and ``stats``; its per-tile sums (``tstats``) follow the
    partial sums in the scratch."""
    N, H, W, C = x.shape
    Cout = w.shape[3]
    dt = x.dtype
    plan = _wgmma_conv_plan("conv_stats", x.device.index, N * H * W, C,
                            Cout, dt)
    slots = 2 * plan.ranges * CONV_ROWS * plan.bn
    with _device(x.device):
        part = _part(x.device, (slots + -(-(N * H * W) // CONV_ROWS) * 2 *
                                Cout,))
        entry, key = _WGMMA["conv_stats", dt]
        err = getattr(_build.lib(), entry)(
            x.data_ptr(), w.data_ptr(), part.data_ptr(), z.data_ptr(),
            part.data_ptr() + 4 * slots, stats.data_ptr(), N, H, W, C, Cout,
            plan.bn, plan.ranges, _raw_stream(x.device))
    _build.check(err, "conv_stats")
    _count(conv_stats, key)


def _conv_stats_tc(x, w, z, tstats, stats):
    """Launch ``csrc/conv3x3_tc.cu``'s conv_stats (fp32, or a half type
    on ``mma.sync``) into ``z``, ``tstats`` and ``stats``."""
    N, H, W, C = x.shape
    Cout = w.shape[3]
    entry, key, vec = _tc_instance(x, "mxt_conv_stats_tc_f32",
                                   "mxt_conv_stats_tc_{}", C, Cout, x, w, z)
    per_sm = ("mxt_conv_stats_tc_blocks_per_sm" if key == "fp32" else
              f"mxt_conv_stats_{_ENTRY[x.dtype]}_blocks_per_sm")
    index = x.device.index
    plan = conv3x3_splits(N * H * W, 9 * C, Cout, _sm_count(index),
                          _per_sm(per_sm, index, wgrad_tile_cols(Cout), vec))
    part = torch.empty((2 * plan.ranges, CONV_ROWS, plan.bn),
                       device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = getattr(_build.lib(), entry)(
            x.data_ptr(), w.data_ptr(), part.data_ptr(), z.data_ptr(),
            tstats.data_ptr(), stats.data_ptr(), N, H, W, C, Cout, plan.bn,
            plan.ranges, vec, _stream(x.device))
    _build.check(err, "conv_stats")
    _count(conv_stats, key)


@_instanced
def conv_affine(x, w, gamma, beta, mean, var, residual=None,
                eps: float = 1e-5, relu: bool = True):
    """``act(conv3x3(x, w)·scale + shift (+ residual))`` with the BN
    statistics folded as :func:`fold` does.  ``x`` (N, H, W, C) and
    ``residual`` (N, H, W, Cout) contiguous NHWC, ``w`` contiguous HWIO
    (3, 3, C, Cout), all fp32, all bf16 or all fp16, the four BN vectors
    (Cout,), each in x's dtype or fp32 (a half training step keeps its
    running statistics fp32; the fold widens all four as ``_fold``
    does).  fp32: the conv of :func:`conv3x3` (3×TF32 on the tensor
    cores, one wave of ranges at the affine instance's occupancy) with
    the BN folded and applied to each finished tile before it is written
    (:func:`tile_writers` names the kernel that finishes each tile).
    bf16 and fp16: exact half products, fp32 sums, the fold, the residual
    and the ReLU in fp32, one rounding at the store; where
    :func:`wgmma_takes` the shape (x, w, out and the residual) the
    ``wgmma`` kernel of ``csrc/conv_bf16_wgmma.cu``, else the ``mma.sync``
    instance of ``csrc/conv3x3_tc.cu``, each planned at its own occupancy;
    each kernel reads every vector in its own dtype (``vf32``, a bit a
    vector).  CPU tensors take :func:`conv_affine_plain`."""
    if not _on_card("conv_affine", x):
        return conv_affine_plain(x, w, gamma, beta, mean, var, residual,
                                 eps, relu)
    half = _card_half("conv_affine", x)
    vecs = (("gamma", gamma), ("beta", beta), ("mean", mean), ("var", var))
    N, H, W, C, Cout = _check(x, w, vecs, residual, dtype=x.dtype)
    out = torch.empty((N, H, W, Cout), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    bn = (gamma, beta, mean, var)
    if half and wgmma_takes(C, Cout, x, w, out,
                            *([residual] if residual is not None else [])):
        return _conv_affine_wgmma(x, w, bn, residual, eps, relu, out)
    return _conv_affine_tc(x, w, bn, residual, eps, relu, out)


def _vf32(bn):
    """The bits of the BatchNorm vectors ``bn`` (gamma, beta, mean, var)
    given in fp32: 1, 2, 4, 8."""
    f32 = torch.float32
    return ((bn[0].dtype is f32) | (bn[1].dtype is f32) << 1 |
            (bn[2].dtype is f32) << 2 | (bn[3].dtype is f32) << 3)


def _affine_launch(entry, plan, flags, vec, x, w, bn, residual, eps, relu,
                   out, part, stream):
    """Call ``entry`` (a conv_affine entry of ``_build``) on ``plan``
    with scratch ``part`` on ``stream``, x's card the current device;
    ``flags`` is ``(vf32,)`` for a half entry (:func:`_vf32`), ``()``
    for the fp32 one; ``vec`` is ``(vec,)`` for the ``conv3x3_tc.cu``
    entries, ``()`` for the ``wgmma`` ones."""
    N, H, W, C = x.shape
    err = getattr(_build.lib(), entry)(
        x.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in bn),
        residual.data_ptr() if residual is not None else None,
        part.data_ptr(), out.data_ptr(), N, H, W, C, w.shape[3],
        float(eps), int(bool(relu)), *flags, plan.bn, plan.ranges, *vec,
        stream)
    _build.check(err, "conv_affine")


def _conv_affine_wgmma(x, w, bn, residual, eps, relu, out):
    """Launch ``csrc/conv_bf16_wgmma.cu``'s conv_affine (x's half type)
    into ``out`` (``bn``: gamma, beta, mean, var)."""
    N, H, W, C = x.shape
    dt = x.dtype
    plan = _wgmma_conv_plan("conv_affine", x.device.index, N * H * W, C,
                            w.shape[3], dt)
    entry, key = _WGMMA["conv_affine", dt]
    with _device(x.device):
        _affine_launch(entry, plan, (_vf32(bn),), (), x, w, bn, residual,
                       eps, relu, out,
                       _part(x.device, (2 * plan.ranges, CONV_ROWS, plan.bn)),
                       _raw_stream(x.device))
    _count(conv_affine, key)
    return out


def _conv_affine_tc(x, w, bn, residual, eps, relu, out):
    """Launch ``csrc/conv3x3_tc.cu``'s conv_affine (fp32, or a half type
    on ``mma.sync``) into ``out``."""
    N, H, W, C = x.shape
    Cout = w.shape[3]
    entry, key, vec = _tc_instance(
        x, "mxt_conv_affine_f32", "mxt_conv_affine_{}", C, Cout, x, w, out,
        *([residual] if residual is not None else []))
    per_sm = ("mxt_conv_affine_tc_blocks_per_sm" if key == "fp32" else
              f"mxt_conv_affine_{_ENTRY[x.dtype]}_blocks_per_sm")
    index = x.device.index
    plan = conv3x3_splits(N * H * W, 9 * C, Cout, _sm_count(index),
                          _per_sm(per_sm, index, wgrad_tile_cols(Cout), vec))
    part = torch.empty((2 * plan.ranges, CONV_ROWS, plan.bn),
                       device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        _affine_launch(entry, plan, () if key == "fp32" else (_vf32(bn),),
                       (vec,), x, w, bn, residual, eps, relu, out, part,
                       _stream(x.device))
    _count(conv_affine, key)
    return out


def bn_affine_plain(z, scale, shift, residual=None, relu: bool = True):
    """Plain version of ``bn_affine``; a half ``z`` (and residual) widened
    to fp32, the result rounded once to z's dtype."""
    if z.dtype in _HALF:
        return bn_affine_plain(
            z.float(), scale, shift,
            None if residual is None else residual.float(), relu).to(z.dtype)
    y = z * scale + shift
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


@_counted
def bn_affine(z, scale, shift, residual=None, relu: bool = True):
    """``act(z·scale + shift (+ residual))`` over the last axis of ``z``
    (the channels, NHWC): ``z`` and ``residual`` contiguous fp32, bf16 or
    fp16 (the arithmetic in fp32, one rounding at a half store),
    ``scale`` and ``shift`` contiguous fp32 (Cout,).  CUDA tensors launch
    ``csrc/conv_train.cu``; CPU tensors take :func:`bn_affine_plain`."""
    if not _on_card("bn_affine", z):
        return bn_affine_plain(z, scale, shift, residual, relu)
    half = _card_half("bn_affine", z)
    if z.dim() < 1:
        raise ValueError("bn_affine: z must have a channel axis")
    Cout = z.shape[-1]
    vecs = [("scale", scale), ("shift", shift)]
    for name, t in vecs:
        if tuple(t.shape) != (Cout,):
            raise ValueError(f"bn_affine: {name} must be ({Cout},), got "
                             f"{tuple(t.shape)}")
    named = [("z", z)]
    if residual is not None:
        if residual.shape != z.shape:
            raise ValueError(f"bn_affine: residual must be "
                             f"{tuple(z.shape)}, got "
                             f"{tuple(residual.shape)}")
        named.append(("residual", residual))
    _same("bn_affine", z, named, z.dtype)
    _same("bn_affine", z, vecs)
    out = torch.empty_like(z)
    if out.numel() == 0:
        return out
    wide = 8 if half else 4
    vec = int(Cout % wide == 0 and
              _aligned(out, *(t for _, t in named + vecs)))
    entry = getattr(_build.lib(), "mxt_bn_affine_" +
                    (_ENTRY[z.dtype] if half else "f32"))
    with torch.cuda.device(z.device):
        err = entry(
            z.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), z.numel(), Cout, int(bool(relu)), vec,
            _stream(z.device))
    _build.check(err, "bn_affine")
    _count(bn_affine, z.dtype)
    return out


def conv_wgrad_plain(x, dy):
    """Plain version of ``conv_wgrad``: dW (3, 3, C, Cout) as nine
    patchesᵀ·dy products over the padded input, tap-major; half operands
    widened to fp32, dW fp32 as the kernel writes it."""
    if x.dtype in _HALF:
        return conv_wgrad_plain(x.float(), dy.float())
    _, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [torch.einsum("nhwc,nhwo->co", xp[:, dh:dh + H, dw:dw + W], dy)
            for dh in range(3) for dw in range(3)]
    return torch.stack(taps).reshape(3, 3, C, dy.shape[-1])


WGRAD_ROWS = 128     # patch columns (k = tap·C + c) a tile
WGRAD_CHUNK = 32     # pixels a chunk of the reduction


class WgradPlan(NamedTuple):
    """How ``conv_wgrad`` cuts its work: ``tiles`` output tiles of 128
    patch columns × ``bn`` channels, each a reduction over ``chunks``
    pixel chunks; the tiles × chunks units are cut into ``ranges``
    ranges of whole chunks, one a block, and ``jmax`` is the most ranges
    one tile is cut between (its partial slots)."""
    bn: int
    tiles: int
    chunks: int
    ranges: int
    jmax: int


def wgrad_tile_cols(Cout):
    """Output channels a ``conv_wgrad`` or ``conv3x3`` tile holds: 64 when
    ``Cout`` fits (ResNet-50's first stage), else 128."""
    return 64 if Cout <= 64 else 128


def wgrad_splits(M, K, Cout, sms, per_sm, chunk=WGRAD_CHUNK):
    """The :class:`WgradPlan` of ``conv_wgrad`` for ``M`` pixels, ``K`` =
    9C patch columns and ``Cout`` channels on a card of ``sms`` SMs that
    holds ``per_sm`` of its blocks each: exactly ``sms·per_sm`` ranges of
    near-equal work (one full wave; fewer only when there are fewer
    units), each range whole chunks of ``chunk`` pixels (stream-K rather
    than equal splits per tile, whose whole waves would need 11 splits
    and 104 MB of partials at 7×7×512).  Range ``b`` holds units
    ``[b·T/ranges, (b+1)·T/ranges)`` of the ``T`` = tiles·chunks (unit =
    tile·chunks + chunk).  The wgmma kernel's tile rows are two 64-channel
    slabs of a tap: ``K`` = 9·64·ceil(C/64), ``chunk`` = 64."""
    bn = wgrad_tile_cols(Cout)
    tiles = -(-K // WGRAD_ROWS) * -(-Cout // bn)
    chunks = -(-M // chunk)
    total = tiles * chunks
    ranges = max(1, min(sms * per_sm, total))
    least = total // ranges
    return WgradPlan(bn, tiles, chunks, ranges,
                     min(ranges, (chunks - 1) // least + 2))


@_instanced
def conv_wgrad(x, dy):
    """dW (3, 3, C, Cout), fp32, of the 3×3/s1/p1 conv from NHWC ``x``
    (N, H, W, C) and ``dy`` (N, H, W, Cout), contiguous, both fp32, both
    bf16 or both fp16: patchesᵀ·dy on the tensor cores, the pixel
    reduction cut into one wave of ranges whose partial tiles are summed
    in a fixed order.  fp32: 3×TF32, fp32-accurate
    (``csrc/conv_wgrad.cu``).  bf16 and fp16: exact half products, fp32
    sums; where :func:`wgmma_takes` the shape the
    ``wgmma`` kernel of ``csrc/conv_bf16_wgmma.cu`` (both operands
    pixel-major as NHWC lays them, read through ``wgmma``'s transpose
    bits; 64-pixel chunks), else the ``mma.sync`` instance of
    ``conv_wgrad.cu``.  The caller casts dW to the weight's dtype, as the
    reference's ``_conv_bwd`` does.  CPU tensors take
    :func:`conv_wgrad_plain`."""
    if not _on_card("conv_wgrad", x):
        return conv_wgrad_plain(x, dy)
    half = _card_half("conv_wgrad", x)
    if x.dim() != 4 or dy.dim() != 4 or tuple(dy.shape[:3]) != \
            tuple(x.shape[:3]):
        raise ValueError(f"conv_wgrad: x (N, H, W, C) and dy (N, H, W, "
                         f"Cout) must share N, H, W; got {tuple(x.shape)} "
                         f"and {tuple(dy.shape)}")
    _same("conv_wgrad", x, [("x", x), ("dy", dy)], x.dtype)
    N, H, W, C = x.shape
    Cout = dy.shape[3]
    M = N * H * W
    dw = torch.empty((3, 3, C, Cout), device=x.device, dtype=torch.float32)
    if M == 0 or dw.numel() == 0:
        return dw.zero_()
    if half and wgmma_takes(C, Cout, x, dy, dw):
        return _wgrad_wgmma(x, dy, dw)
    return _wgrad_tc(x, dy, dw)


def _wgrad_wgmma(x, dy, dw):
    """Launch ``csrc/conv_bf16_wgmma.cu``'s conv_wgrad (x's half type)
    into ``dw``."""
    N, H, W, C = x.shape
    Cout = dy.shape[3]
    index = x.device.index
    dt = x.dtype
    plan = wgrad_splits(N * H * W, 9 * WGMMA_SLAB * _slabs(C), Cout,
                        _sm_count(index),
                        _wgmma_per_sm("conv_wgrad", index,
                                      wgrad_tile_cols(Cout), dt),
                        chunk=WGMMA_SLAB)
    with _device(x.device):
        part = _part(x.device, (plan.tiles, plan.jmax, WGRAD_ROWS, plan.bn))
        entry, key = _WGMMA["conv_wgrad", dt]
        err = getattr(_build.lib(), entry)(
            x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
            N, H, W, C, Cout, plan.bn, plan.ranges, plan.jmax,
            _raw_stream(x.device))
    _build.check(err, "conv_wgrad")
    _count(conv_wgrad, key)
    return dw


def _wgrad_tc(x, dy, dw):
    """Launch ``csrc/conv_wgrad.cu``'s kernel (fp32, or a half type on
    ``mma.sync``) into ``dw``."""
    N, H, W, C = x.shape
    Cout = dy.shape[3]
    entry, key, vec = _tc_instance(x, "mxt_conv_wgrad_f32",
                                   "mxt_conv_wgrad_{}", C, Cout, x, dy, dw)
    per_sm = ("mxt_conv_wgrad_blocks_per_sm" if key == "fp32" else
              f"mxt_conv_wgrad_{_ENTRY[x.dtype]}_blocks_per_sm")
    index = x.device.index
    plan = wgrad_splits(N * H * W, 9 * C, Cout, _sm_count(index),
                        _per_sm(per_sm, index, wgrad_tile_cols(Cout), vec))
    part = torch.empty((plan.tiles, plan.jmax, WGRAD_ROWS, plan.bn),
                       device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = getattr(_build.lib(), entry)(
            x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
            N, H, W, C, Cout, plan.bn, plan.ranges, plan.jmax, vec,
            _stream(x.device))
    _build.check(err, "conv_wgrad")
    _count(conv_wgrad, key)
    return dw


# ------------------------------------------------------ the fused block
class _FusedBlock(torch.autograd.Function):
    """≙ ``pallas_block._fused`` with its custom VJP.  Training: z and
    Σz, Σz² from ``conv_stats``, BN folded from the batch statistics
    (``var = Σz²/n − μ²``), then ``bn_affine``; returns ``(out, μ, σ²)``.
    Frozen: ``conv_affine`` with the given statistics; returns
    ``(out,)``.  The backward is the reference's ``_fused_bwd``: the ReLU
    mask, (Σdy, Σdy·x̂) in fp32 and dz in plain torch, then dx by
    ``conv3x3`` on the rotated weight and dW by ``conv_wgrad``, each cast
    to its input's dtype; frozen mode first recomputes z with
    ``conv3x3``.  On bf16 and fp16 every op of the dz chain rounds where
    the reference's eager ops round: x̂ from μ and 1/σ cast to x's dtype,
    the means of the two sums and γ/σ cast before they meet dy; dγ and
    dβ come back in γ's dtype.  On fp32 the casts are no-ops.  Frozen in
    a half step, μ and σ² are the fp32 running statistics and γ, β the
    step's half casts: ``conv_affine`` folds the mixed vectors in fp32.
    Cotangents of the batch statistics are ignored (they feed the running
    averages only)."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, mean, var, residual, eps, frozen,
                relu):
        ctx.cfg = (frozen, relu, residual is not None)
        if frozen:
            out = conv_affine(x, w, gamma, beta, mean, var, residual, eps,
                              relu)
            inv = torch.rsqrt(var.float() + eps)
            ctx.save_for_backward(x, w, gamma, None, mean, inv, out)
            return (out,)
        z, s1, s2 = conv_stats(x, w)
        n = x.shape[0] * x.shape[1] * x.shape[2]
        bmean = s1 / n
        bvar = torch.clamp(s2 / n - bmean * bmean, min=0.0)
        inv = torch.rsqrt(bvar + eps)
        scale = gamma.float() * inv
        shift = beta.float() - bmean * scale
        out = bn_affine(z, scale, shift, residual, relu)
        ctx.save_for_backward(x, w, gamma, z, bmean, inv, out)
        ctx.mark_non_differentiable(bmean, bvar)
        return out, bmean, bvar

    @staticmethod
    def backward(ctx, dout, *stat_cotangents):
        frozen, relu, has_res = ctx.cfg
        x, w, gamma, z, mean, inv, out = ctx.saved_tensors
        # the gradient from the next layer may come in another layout;
        # the kernels take contiguous NHWC (copies counted, for PERF.md)
        if not dout.is_contiguous():
            dout = dout.contiguous()
            with _count_mu:
                _FusedBlock.dout_copies += 1
        dz_post = torch.where(out > 0, dout, 0.0) if relu else dout
        dt = dz_post.dtype
        if frozen:
            # z is recomputed rather than saved, as the reference does
            z = conv3x3(x, w)
            xhat = (_wide(z) - _wide(mean)) * inv
        else:
            xhat = (z - mean.to(z.dtype)) * inv.to(z.dtype)
        dyf = _wide(dz_post)
        sum_dy = dyf.sum(dim=(0, 1, 2))
        sum_dy_xhat = (dyf * _wide(xhat)).sum(dim=(0, 1, 2))
        scale = gamma.float() * inv
        if frozen:
            dz = (dz_post * scale.to(dt)).to(x.dtype)
        else:
            n = x.shape[0] * x.shape[1] * x.shape[2]
            dz = (scale.to(dt) * (dz_post - (sum_dy / n).to(dt) -
                                  xhat * (sum_dy_xhat / n).to(dt))).to(x.dtype)
        need = ctx.needs_input_grad
        dx = conv3x3_dgrad(w, dz).to(x.dtype) if need[0] else None
        dw = conv_wgrad(x, dz).to(w.dtype) if need[1] else None
        dres = dz_post if has_res and need[6] else None
        return (dx, dw, sum_dy_xhat.to(gamma.dtype), sum_dy.to(gamma.dtype),
                None, None, dres, None, None, None)


_FusedBlock.dout_copies = 0


def residual_block_fused(x, w, gamma, beta, mean, var, residual=None, *,
                         eps: float = 1e-5, frozen: bool = False,
                         relu: bool = True):
    """Fused 3×3/s1 conv + BN (+ residual add) (+ ReLU), differentiable
    (≙ ``pallas_block.residual_block_fused``).  Returns ``(out,
    batch_mean, batch_var)`` in training mode (the biased batch variance)
    and ``(out, mean, var)``, the given statistics, when ``frozen``.
    ``x``, ``w`` and ``residual`` contiguous NHWC/HWIO, all fp32, all
    bf16 or all fp16 (the statistics fp32)."""
    outs = _FusedBlock.apply(x, w, gamma, beta, mean, var, residual,
                             float(eps), bool(frozen), bool(relu))
    if frozen:
        return outs[0], mean, var
    return outs
