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
           "WgradPlan",
           "residual_block_fused"]

_count_mu = threading.Lock()


def fold(gamma, beta, mean, var, eps: float = 1e-5):
    """Frozen BN as a per-channel affine, in f32 as ``_fold`` computes it:
    ``scale = γ·rsqrt(σ²+ε)``, ``shift = β − μ·scale``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def conv_affine_plain(x, w, gamma, beta, mean, var, residual=None,
                      eps: float = 1e-5, relu: bool = True):
    """Plain PyTorch version of the kernel: 3×3/s1/p1 conv of NHWC ``x``
    with HWIO ``w``, then ``·scale + shift``, ``+ residual``, ReLU."""
    scale, shift = fold(gamma, beta, mean, var, eps)
    z = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    y = z * scale + shift
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _same(what, x, named):
    """Every tensor of ``named`` on x's device, float32 and contiguous."""
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous "
                             f"({'NHWC' if t.dim() == 4 else 'dense'})")


def _check(x, w, vecs, residual, what="conv_affine"):
    """Refuse what the kernel does not take; → (N, H, W, C, Cout)."""
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be NHWC, got {tuple(x.shape)}")
    N, H, W, C = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"{what}: w must be (3, 3, {C}, Cout) HWIO, "
                         f"got {tuple(w.shape)}")
    Cout = w.shape[3]
    named = [("x", x), ("w", w)] + list(vecs)
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
    _same(what, x, named)
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


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def conv3x3_plain(x, w):
    """Plain version of ``conv3x3``: the 3×3/s1/p1 conv of NHWC ``x`` with
    HWIO ``w``, contiguous NHWC as the kernel writes it."""
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


def conv3x3_splits(M, K, Cout, sms, per_sm):
    """The :class:`Conv3x3Plan` of ``conv3x3`` for ``M`` output pixels,
    ``K`` = 9C patch columns and ``Cout`` channels on a card of ``sms`` SMs
    that holds ``per_sm`` of its blocks each: exactly ``sms·per_sm`` ranges
    of near-equal work (one full wave; fewer only when there are fewer
    units), each whole chunks (stream-K: at 7×7×512, batch 64, the 100
    tiles alone would leave 32 of 132 SMs idle).  Range ``b`` holds units
    ``[b·T/ranges, (b+1)·T/ranges)`` of the ``T`` = tiles·chunks (unit =
    tile·chunks + chunk)."""
    bn = wgrad_tile_cols(Cout)
    tiles = -(-M // CONV_ROWS) * -(-Cout // bn)
    chunks = -(-K // CONV_CHUNK)
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


def conv3x3(x, w):
    """3×3/s1/p1 conv with no epilogue, ``x`` (N, H, W, C) and ``w``
    (3, 3, C, Cout) contiguous fp32: an implicit GEMM on the tensor cores
    in 3×TF32 (fp32-accurate), its work cut into one wave of ranges
    (:func:`conv3x3_splits`) whose cut tiles are summed in a fixed order.
    CUDA tensors launch ``csrc/conv3x3_tc.cu``; CPU tensors take
    :func:`conv3x3_plain`."""
    if not _on_card("conv3x3", x):
        return conv3x3_plain(x, w)
    N, H, W, C, Cout = _check(x, w, (), None, "conv3x3")
    out = torch.empty((N, H, W, Cout), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    vec = int(C % 4 == 0 and Cout % 4 == 0 and _aligned(x, w, out))
    index = x.device.index
    plan = conv3x3_splits(N * H * W, 9 * C, Cout, _sm_count(index),
                          _per_sm("mxt_conv3x3_tc_blocks_per_sm", index,
                                  wgrad_tile_cols(Cout), vec))
    part = torch.empty((2 * plan.ranges, CONV_ROWS, plan.bn),
                       device=x.device, dtype=torch.float32)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.mxt_conv3x3_tc_f32(
            x.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(),
            N, H, W, C, Cout, plan.bn, plan.ranges, vec, _stream(x.device))
    _build.check(err, "conv3x3")
    with _count_mu:
        conv3x3.launches += 1
    return out


conv3x3.launches = 0


def rotate(w):
    """The dgrad weight of HWIO ``w`` (3, 3, C, Cout): rotated 180° in
    both spatial axes and IO-transposed, (3, 3, Cout, C), contiguous."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def conv3x3_dgrad(w, dy):
    """dx = ``conv3x3(dy, rotate(w))`` (≙ ``pallas_block.conv3x3_dgrad``)."""
    return conv3x3(dy, rotate(w))


def conv_stats_plain(x, w):
    """Plain version of ``conv_stats``: ``(z, Σz, Σz²)``, the sums per
    output channel over every pixel."""
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


def conv_stats(x, w):
    """``(z, Σz, Σz²)``: the conv of :func:`conv3x3`, on the same
    tensor-core kernel body with a statistics epilogue, and its
    per-channel sums (f32, (Cout,) each) read off the accumulator: per
    128-pixel tile in a fixed order, then over the tiles in a fixed order,
    so the three are the same on every run (:func:`tile_writers` names the
    kernel that sums each tile).  Its plan is
    :func:`conv3x3_splits` at the occupancy of the statistics instance;
    where that equals ``conv3x3``'s plan, z is ``conv3x3(x, w)`` bit for
    bit.  CPU tensors take :func:`conv_stats_plain`."""
    if not _on_card("conv_stats", x):
        return conv_stats_plain(x, w)
    N, H, W, C, Cout = _check(x, w, (), None, "conv_stats")
    z = torch.empty((N, H, W, Cout), device=x.device, dtype=x.dtype)
    if z.numel() == 0:
        stats = torch.zeros((2, Cout), device=x.device, dtype=torch.float32)
        return z, stats[0], stats[1]
    vec = int(C % 4 == 0 and Cout % 4 == 0 and _aligned(x, w, z))
    index = x.device.index
    M = N * H * W
    plan = conv3x3_splits(M, 9 * C, Cout, _sm_count(index),
                          _per_sm("mxt_conv_stats_tc_blocks_per_sm", index,
                                  wgrad_tile_cols(Cout), vec))
    part = torch.empty((2 * plan.ranges, CONV_ROWS, plan.bn),
                       device=x.device, dtype=torch.float32)
    tstats = torch.empty((-(-M // CONV_ROWS), 2, Cout), device=x.device,
                         dtype=torch.float32)
    stats = torch.empty((2, Cout), device=x.device, dtype=torch.float32)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.mxt_conv_stats_tc_f32(
            x.data_ptr(), w.data_ptr(), part.data_ptr(), z.data_ptr(),
            tstats.data_ptr(), stats.data_ptr(), N, H, W, C, Cout, plan.bn,
            plan.ranges, vec, _stream(x.device))
    _build.check(err, "conv_stats")
    with _count_mu:
        conv_stats.launches += 1
    return z, stats[0], stats[1]


conv_stats.launches = 0


def conv_affine(x, w, gamma, beta, mean, var, residual=None,
                eps: float = 1e-5, relu: bool = True):
    """``act(conv3x3(x, w)·scale + shift (+ residual))`` with the BN
    statistics folded as :func:`fold` does.  ``x`` (N, H, W, C) and
    ``residual`` (N, H, W, Cout) contiguous NHWC fp32, ``w`` contiguous
    HWIO (3, 3, C, Cout), the four BN vectors (Cout,).  The conv of
    :func:`conv3x3` (3×TF32 on the tensor cores, one wave of ranges at
    the affine instance's occupancy) with the BN folded and applied to
    each finished tile before it is written (:func:`tile_writers` names
    the kernel that finishes each tile).  CUDA tensors launch
    ``csrc/conv3x3_tc.cu``; CPU tensors take :func:`conv_affine_plain`."""
    if not _on_card("conv_affine", x):
        return conv_affine_plain(x, w, gamma, beta, mean, var, residual,
                                 eps, relu)
    vecs = (("gamma", gamma), ("beta", beta), ("mean", mean), ("var", var))
    N, H, W, C, Cout = _check(x, w, vecs, residual)
    out = torch.empty((N, H, W, Cout), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    vec = int(C % 4 == 0 and Cout % 4 == 0 and
              _aligned(x, w, out, *([residual] if residual is not None
                                    else [])))
    index = x.device.index
    plan = conv3x3_splits(N * H * W, 9 * C, Cout, _sm_count(index),
                          _per_sm("mxt_conv_affine_tc_blocks_per_sm", index,
                                  wgrad_tile_cols(Cout), vec))
    part = torch.empty((2 * plan.ranges, CONV_ROWS, plan.bn),
                       device=x.device, dtype=torch.float32)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.mxt_conv_affine_f32(
            x.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), var.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            part.data_ptr(), out.data_ptr(), N, H, W, C, Cout, float(eps),
            int(bool(relu)), plan.bn, plan.ranges, vec, _stream(x.device))
    _build.check(err, "conv_affine")
    with _count_mu:
        conv_affine.launches += 1
    return out


conv_affine.launches = 0


def bn_affine_plain(z, scale, shift, residual=None, relu: bool = True):
    """Plain version of ``bn_affine``."""
    y = z * scale + shift
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def bn_affine(z, scale, shift, residual=None, relu: bool = True):
    """``act(z·scale + shift (+ residual))`` over the last axis of ``z``
    (the channels, NHWC), all contiguous fp32, ``scale`` and ``shift``
    (Cout,).  CUDA tensors launch ``csrc/conv_train.cu``; CPU tensors take
    :func:`bn_affine_plain`."""
    if not _on_card("bn_affine", z):
        return bn_affine_plain(z, scale, shift, residual, relu)
    if z.dim() < 1:
        raise ValueError("bn_affine: z must have a channel axis")
    Cout = z.shape[-1]
    named = [("z", z), ("scale", scale), ("shift", shift)]
    for name, t in named[1:]:
        if tuple(t.shape) != (Cout,):
            raise ValueError(f"bn_affine: {name} must be ({Cout},), got "
                             f"{tuple(t.shape)}")
    if residual is not None:
        if residual.shape != z.shape:
            raise ValueError(f"bn_affine: residual must be "
                             f"{tuple(z.shape)}, got "
                             f"{tuple(residual.shape)}")
        named.append(("residual", residual))
    _same("bn_affine", z, named)
    out = torch.empty_like(z)
    if out.numel() == 0:
        return out
    vec = int(Cout % 4 == 0 and _aligned(out, *(t for _, t in named)))
    lib = _build.lib()
    with torch.cuda.device(z.device):
        err = lib.mxt_bn_affine_f32(
            z.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), z.numel(), Cout, int(bool(relu)), vec,
            _stream(z.device))
    _build.check(err, "bn_affine")
    with _count_mu:
        bn_affine.launches += 1
    return out


bn_affine.launches = 0


def conv_wgrad_plain(x, dy):
    """Plain version of ``conv_wgrad``: dW (3, 3, C, Cout) as nine
    patchesᵀ·dy products over the padded input, tap-major."""
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
    32-pixel chunks; the tiles × chunks units are cut into ``ranges``
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


def wgrad_splits(M, K, Cout, sms, per_sm):
    """The :class:`WgradPlan` of ``conv_wgrad`` for ``M`` pixels, ``K`` =
    9C patch columns and ``Cout`` channels on a card of ``sms`` SMs that
    holds ``per_sm`` of its blocks each: exactly ``sms·per_sm`` ranges of
    near-equal work (one full wave; fewer only when there are fewer
    units), each range whole chunks (stream-K rather than equal splits per
    tile, whose whole waves would need 11 splits and 104 MB of partials
    at 7×7×512).  Range ``b`` holds units ``[b·T/ranges, (b+1)·T/ranges)``
    of the ``T`` = tiles·chunks (unit = tile·chunks + chunk)."""
    bn = wgrad_tile_cols(Cout)
    tiles = -(-K // WGRAD_ROWS) * -(-Cout // bn)
    chunks = -(-M // WGRAD_CHUNK)
    total = tiles * chunks
    ranges = max(1, min(sms * per_sm, total))
    least = total // ranges
    return WgradPlan(bn, tiles, chunks, ranges,
                     min(ranges, (chunks - 1) // least + 2))


def conv_wgrad(x, dy):
    """dW (3, 3, C, Cout) of the 3×3/s1/p1 conv from NHWC ``x`` (N, H, W,
    C) and ``dy`` (N, H, W, Cout), contiguous fp32: patchesᵀ·dy on the
    tensor cores in 3×TF32 (fp32-accurate), the pixel reduction cut into
    one wave of ranges whose partial tiles are summed in a fixed order.
    CUDA tensors launch ``csrc/conv_wgrad.cu``; CPU tensors take
    :func:`conv_wgrad_plain`."""
    if not _on_card("conv_wgrad", x):
        return conv_wgrad_plain(x, dy)
    if x.dim() != 4 or dy.dim() != 4 or tuple(dy.shape[:3]) != \
            tuple(x.shape[:3]):
        raise ValueError(f"conv_wgrad: x (N, H, W, C) and dy (N, H, W, "
                         f"Cout) must share N, H, W; got {tuple(x.shape)} "
                         f"and {tuple(dy.shape)}")
    _same("conv_wgrad", x, [("x", x), ("dy", dy)])
    N, H, W, C = x.shape
    Cout = dy.shape[3]
    M = N * H * W
    dw = torch.empty((3, 3, C, Cout), device=x.device, dtype=torch.float32)
    if M == 0 or dw.numel() == 0:
        return dw.zero_()
    vec = int(C % 4 == 0 and Cout % 4 == 0 and _aligned(x, dy, dw))
    index = x.device.index
    plan = wgrad_splits(M, 9 * C, Cout, _sm_count(index),
                        _per_sm("mxt_conv_wgrad_blocks_per_sm", index,
                                wgrad_tile_cols(Cout), vec))
    part = torch.empty((plan.tiles, plan.jmax, WGRAD_ROWS, plan.bn),
                       device=x.device, dtype=torch.float32)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.mxt_conv_wgrad_f32(
            x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
            N, H, W, C, Cout, plan.bn, plan.ranges, plan.jmax, vec,
            _stream(x.device))
    _build.check(err, "conv_wgrad")
    with _count_mu:
        conv_wgrad.launches += 1
    return dw


conv_wgrad.launches = 0


# ------------------------------------------------------ the fused block
class _FusedBlock(torch.autograd.Function):
    """≙ ``pallas_block._fused`` with its custom VJP.  Training: z and
    Σz, Σz² from ``conv_stats``, BN folded from the batch statistics
    (``var = Σz²/n − μ²``), then ``bn_affine``; returns ``(out, μ, σ²)``.
    Frozen: ``conv_affine`` with the given statistics; returns
    ``(out,)``.  The backward is the reference's: the ReLU mask, (Σdy,
    Σdy·x̂) and dz in plain torch, then dx by ``conv3x3`` on the rotated
    weight and dW by ``conv_wgrad``; frozen mode first recomputes z with
    ``conv3x3``.  Cotangents of the batch statistics are ignored (they
    feed the running averages only)."""

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
        if frozen:
            # z is recomputed rather than saved, as the reference does
            z = conv3x3(x, w)
        xhat = (z - mean) * inv
        sum_dy = dz_post.sum(dim=(0, 1, 2))
        sum_dy_xhat = (dz_post * xhat).sum(dim=(0, 1, 2))
        scale = gamma.float() * inv
        if frozen:
            dz = dz_post * scale
        else:
            n = x.shape[0] * x.shape[1] * x.shape[2]
            dz = scale * (dz_post - sum_dy / n - xhat * (sum_dy_xhat / n))
        need = ctx.needs_input_grad
        dx = conv3x3_dgrad(w, dz) if need[0] else None
        dw = conv_wgrad(x, dz) if need[1] else None
        dres = dz_post if has_res and need[6] else None
        return (dx, dw, sum_dy_xhat, sum_dy, None, None, dres, None, None,
                None)


_FusedBlock.dout_copies = 0


def residual_block_fused(x, w, gamma, beta, mean, var, residual=None, *,
                         eps: float = 1e-5, frozen: bool = False,
                         relu: bool = True):
    """Fused 3×3/s1 conv + BN (+ residual add) (+ ReLU), differentiable
    (≙ ``pallas_block.residual_block_fused``).  Returns ``(out,
    batch_mean, batch_var)`` in training mode (the biased batch variance)
    and ``(out, mean, var)``, the given statistics, when ``frozen``.
    ``x``, ``w`` and ``residual`` contiguous NHWC/HWIO fp32."""
    outs = _FusedBlock.apply(x, w, gamma, beta, mean, var, residual,
                             float(eps), bool(frozen), bool(relu))
    if frozen:
        return outs[0], mean, var
    return outs
