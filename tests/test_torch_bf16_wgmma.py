"""The bf16 ``wgmma`` kernels of rows 7 and 11 (``csrc/conv_bf16_wgmma.cu``)
as far as the CPU can hold them: their plans (every unit of work in
exactly one range, each cut tile summed once in range order, chunks whole
16-deep ``wgmma`` steps), the shape predicate that picks them or the
``mma.sync`` instances, the C entry points that ``_build`` binds, a plain
model of how the kernels cut the conv into tap slabs and pixel chunks
(the im2col copies' zero halo included), and the wrappers on bf16 CPU
tensors, which take the plain versions (no launch) and match the JAX
package's Pallas kernels run in interpret mode.

Tolerances.  bf16 outputs (``conv3x3``, the dgrad) within one bf16 step
of the reference's, or 1e-5 of the largest near 0: the two sum the same
exact products in fp32 in another order, so a value may round to its
neighbour.  fp32 dW within 1e-5 of its largest magnitude (fp32 rounding
over sums of a few hundred terms).  The plain models sum in fp64 and
are held to the plain versions within 1e-5 of the largest, the fp32
rounding of the latter."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import pallas_block as jpb  # noqa: E402
from mxnet_tpu_torch import _build  # noqa: E402
from mxnet_tpu_torch.ops import conv_block  # noqa: E402
from mxnet_tpu_torch.parallel import train as ptrain  # noqa: E402

torch.set_num_threads(1)

SLAB = conv_block.WGMMA_SLAB
SUM_TOL = 1e-5
NEAR_ZERO = 1e-5
# ResNet-50's four 3x3 stages at the bf16 step's batch of 128, and the
# kernels' edges: one tile, a ragged M with a partial slab and box
PLAN_SHAPES = [(128, 56, 56, 64, 64), (128, 28, 28, 128, 128),
               (128, 14, 14, 256, 256), (128, 7, 7, 512, 512),
               (1, 8, 16, 64, 64), (3, 7, 9, 40, 24)]
# small shapes the wgmma kernels would take (C, Cout multiples of 8)
SMALL = [(2, 6, 6, 64, 64), (1, 5, 7, 40, 24), (2, 4, 3, 16, 136)]


def _conv_plan(N, H, W, C, Cout, per_sm):
    return conv_block.conv3x3_splits(N * H * W, 9 * SLAB * -(-C // SLAB),
                                     Cout, 132, per_sm, chunk=SLAB)


def _wgrad_plan(N, H, W, C, Cout, per_sm):
    return conv_block.wgrad_splits(N * H * W, 9 * SLAB * -(-C // SLAB),
                                   Cout, 132, per_sm, chunk=SLAB)


def _ranges(plan):
    """Range b's units [lo, hi) and the range of unit u, as the kernels
    compute them."""
    total = plan.tiles * plan.chunks
    bounds = [(b * total // plan.ranges, (b + 1) * total // plan.ranges)
              for b in range(plan.ranges)]
    return bounds, lambda u: ((u + 1) * plan.ranges - 1) // total


def _segments(plan):
    """(range, tile, first unit, end unit) of every segment, as
    ``consume`` walks them."""
    bounds, _ = _ranges(plan)
    for b, (u, u1) in enumerate(bounds):
        while u < u1:
            tile = u // plan.chunks
            ue = min(u1, (tile + 1) * plan.chunks)
            yield b, tile, u, ue
            u = ue


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_wgmma_conv3x3_plan_covers_every_unit_once(shape, per_sm):
    """conv3x3's wgmma plan: 128-pixel tiles × one chunk a (tap, 64-channel
    slab); the ranges cover every unit once, one wave; a tile is stored
    whole by one segment or cut, then summed once by the reduce block of
    the range that starts inside it, from exactly its segments' slots in
    range order (the first segment's slot 2b or 2b + 1, the others' 2q);
    ``tile_writers`` names the same kernel for each tile."""
    N, H, W, C, Cout = shape
    plan = _conv_plan(N, H, W, C, Cout, per_sm)
    M = N * H * W
    assert plan.chunks == 9 * -(-C // SLAB)
    assert plan.tiles == -(-M // 128) * -(-Cout // plan.bn)
    assert plan.ranges == min(132 * per_sm, plan.tiles * plan.chunks)
    bounds, range_of = _ranges(plan)
    seen, slots, cut = set(), set(), {}
    whole = set()
    for b, tile, u, ue in _segments(plan):
        for v in range(u, ue):
            assert v not in seen
            seen.add(v)
        t0 = tile * plan.chunks
        if u == t0 and ue == t0 + plan.chunks:
            whole.add(tile)
        else:
            slot = 2 * b + (0 if u == bounds[b][0] else 1)
            assert slot not in slots
            slots.add(slot)
            cut.setdefault(tile, []).append((b, slot))
    assert seen == set(range(plan.tiles * plan.chunks))
    assert not whole & set(cut)
    assert whole | set(cut) == set(range(plan.tiles))
    for tile, segs in cut.items():
        t0 = tile * plan.chunks
        # the reduce block of range r owns the tile: r - 1 holds its first
        # unit and r starts inside it
        r = range_of(t0) + 1
        assert bounds[r][0] % plan.chunks and bounds[r][0] // plan.chunks \
            == tile
        last = range_of(t0 + plan.chunks - 1)
        first = 2 * (r - 1) + (0 if bounds[r - 1][0] >= t0 else 1)
        order = [first] + [2 * q for q in range(r, last + 1)]
        assert order == [s for _, s in sorted(segs)]
    writers = {t: k for t, k, _ in conv_block.tile_writers(plan)}
    assert {t for t, k in writers.items() if k == "main"} == whole
    assert {t for t, k in writers.items() if k == "cut"} == set(cut)


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_wgmma_wgrad_plan_covers_every_pixel_once(shape, per_sm):
    """conv_wgrad's wgmma plan: tiles of two 64-channel tap slabs × bn
    output channels, chunks of 64 pixels; every unit in exactly one
    range, every tile cut between at most ``jmax`` ranges (its slots, in
    range order), one wave."""
    N, H, W, C, Cout = shape
    plan = _wgrad_plan(N, H, W, C, Cout, per_sm)
    M = N * H * W
    slabs = 9 * -(-C // SLAB)
    assert plan.tiles == -(-slabs // 2) * -(-Cout // plan.bn)
    assert (plan.chunks - 1) * SLAB < M <= plan.chunks * SLAB
    assert plan.ranges == min(132 * per_sm, plan.tiles * plan.chunks)
    _, range_of = _ranges(plan)
    seen = []
    slots = {}
    for b, tile, u, ue in _segments(plan):
        seen += range(u, ue)
        j = b - range_of(tile * plan.chunks)
        assert 0 <= j < plan.jmax
        slots.setdefault(tile, []).append(j)
    assert seen == list(range(plan.tiles * plan.chunks))
    for tile, js in slots.items():
        assert js == list(range(len(js)))


def test_wgmma_chunks_are_whole_wgmma_steps():
    """A chunk is four 16-deep ``wgmma`` steps: 64 k of one tap (conv3x3:
    a slab never spans two taps, each tap padded to whole slabs) or 64
    pixels (conv_wgrad); a slab's 64 bf16 channels are one 128-byte
    swizzled row."""
    assert SLAB % 16 == 0 and SLAB * 2 == 128
    for C in (8, 40, 64, 96, 448, 512):
        slabs = -(-C // SLAB)
        plan = conv_block.conv3x3_splits(1000, 9 * SLAB * slabs, 64, 132, 1,
                                         chunk=SLAB)
        assert plan.chunks == 9 * slabs
        # chunk c is tap c // slabs, channels (c % slabs) * 64 ..
        taps = [c // slabs for c in range(plan.chunks)]
        assert taps == sorted(taps) and set(taps) == set(range(9))


@pytest.mark.parametrize("C,Cout,offset,takes", [
    (64, 64, 0, True), (40, 24, 0, True), (8, 512, 0, True),
    (20, 12, 0, False), (64, 60, 0, False), (4, 64, 0, False),
    (64, 64, 4, False)])
def test_wgmma_takes_by_channels_and_alignment(C, Cout, offset, takes):
    """The wgmma kernels take a bf16 shape when TMA can map it: C and Cout
    multiples of 8 (16-byte strides) and 16-byte aligned tensors; the
    rest (the ragged C = 20, an offset view) keep the mma.sync ones."""
    base = torch.zeros(offset + 2 * 3 * 3 * C, dtype=torch.bfloat16)
    x = base[offset:].view(2, 3, 3, C)
    w = torch.zeros(3, 3, C, Cout, dtype=torch.bfloat16)
    assert conv_block.wgmma_takes(C, Cout, x, w) is takes


def _c_entries():
    """{name: parameter count} of every ``extern "C"`` function defined in
    csrc/*.cu."""
    out = {}
    for src in _build.SOURCES:
        text = src.read_text()
        for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(mxt_\w+)\s*\(([^)]*)'
                             r'\)\s*\{', text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = len(params)
    return out


def test_signatures_are_defined_c_entries():
    """Every entry ``_build`` binds is an ``extern "C"`` function of
    csrc/ with as many parameters as its ctypes signature, the wgmma
    kernels' among them."""
    entries = _c_entries()
    for name, argtypes in _build._SIGNATURES.items():
        assert name in entries, name
        assert entries[name] == len(argtypes), name
    for name in ("mxt_conv3x3_wgmma_bf16", "mxt_conv_wgrad_wgmma_bf16",
                 "mxt_conv3x3_wgmma_blocks_per_sm",
                 "mxt_conv_wgrad_wgmma_blocks_per_sm"):
        assert name in _build._SIGNATURES
    assert Path(_build.CSRC, "conv_bf16_wgmma.cu") in _build.SOURCES
    assert Path(_build.CSRC, "wgmma_ring.cuh") in _build.HEADERS


# ------------------------------------------- a plain model of the tiling
def _im2col(x, p0, count, tap, c0):
    """What one im2col copy brings (verified on the card): ``count``
    pixels from flattened pixel p0 on, each shifted by the tap (dh, dw) =
    (tap // 3 - 1, tap % 3 - 1), channels c0 .. c0 + 63; pixels shifted
    off the image, past the batch, or channels past C, zero."""
    N, H, W, C = x.shape
    out = np.zeros((count, SLAB))
    dh, dw = tap // 3 - 1, tap % 3 - 1
    for i in range(count):
        n, r = divmod(p0 + i, H * W)
        h, w = divmod(r, W)
        ih, iw = h + dh, w + dw
        if n < N and 0 <= ih < H and 0 <= iw < W:
            ch = x[n, ih, iw, c0:c0 + SLAB]
            out[i, :len(ch)] = ch
    return out


def _box(t, r0, c0, rows):
    """A 64-column box of the 2-D view ``t`` from (r0, c0), zero past it."""
    out = np.zeros((rows, SLAB))
    part = t[r0:r0 + rows, c0:c0 + SLAB]
    out[:part.shape[0], :part.shape[1]] = part
    return out


@pytest.mark.parametrize("shape", SMALL, ids=str)
def test_wgmma_conv3x3_tiling_model_matches_plain(shape):
    """conv3x3 as the kernel cuts it: each 128-pixel tile sums, chunk by
    chunk, one tap slab of im2col pixels times that slab's weight rows
    (a 3-D box over (9, C, Cout)); equal to the plain conv."""
    N, H, W, C, Cout = shape
    rs = np.random.RandomState(0)
    x = rs.randn(N, H, W, C)
    w = rs.randn(3, 3, C, Cout)
    M = N * H * W
    cs = -(-C // SLAB)
    wt = w.reshape(9, C, Cout)
    out = np.zeros((-(-M // 128) * 128, Cout))
    for m0 in range(0, M, 128):
        for chunk in range(9 * cs):
            tap, c0 = chunk // cs, chunk % cs * SLAB
            a = _im2col(x, m0, 128, tap, c0)
            for n0 in range(0, Cout, SLAB):
                out[m0:m0 + 128, n0:n0 + SLAB] += a @ _box(wt[tap], c0, n0,
                                                           SLAB)[:, :Cout - n0]
    ref = conv_block.conv3x3_plain(torch.from_numpy(x).float(),
                                   torch.from_numpy(w).float())
    got = out[:M].reshape(N, H, W, Cout)
    assert np.abs(got - ref.numpy()).max() <= \
        SUM_TOL * np.abs(ref.numpy()).max()


@pytest.mark.parametrize("shape", SMALL, ids=str)
def test_wgmma_wgrad_tiling_model_matches_plain(shape):
    """conv_wgrad as the kernel cuts it: a tile's rows are two tap slabs
    (none past the last), each 64-pixel chunk adds im2col(x)ᵀ · dy (a 2-D
    box over (N·H·W, Cout)), and the reduce maps tile row r to slab
    2·tile + r // 64 and k = tap·C + slab·64 + r % 64, dropping channels
    past C; equal to the plain dW."""
    N, H, W, C, Cout = shape
    rs = np.random.RandomState(1)
    x = rs.randn(N, H, W, C)
    dy = rs.randn(N, H, W, Cout)
    M = N * H * W
    cs = -(-C // SLAB)
    slabs = 9 * cs
    d2 = dy.reshape(M, Cout)
    dw = np.zeros((9 * C, Cout))
    for tm in range(-(-slabs // 2)):
        tile = np.zeros((128, -(-Cout // SLAB) * SLAB))
        for half in range(2):
            s = 2 * tm + half
            if s >= slabs:
                continue
            tap, c0 = s // cs, s % cs * SLAB
            rows = tile[SLAB * half:][:SLAB]
            for p0 in range(0, M, SLAB):
                a = _im2col(x, p0, SLAB, tap, c0)
                for n0 in range(0, Cout, SLAB):
                    rows[:, n0:n0 + SLAB] += a.T @ _box(d2, p0, n0, SLAB)
        for r in range(128):
            s = tm * 2 + r // SLAB
            tap, c = s // cs, s % cs * SLAB + r % SLAB
            if s < slabs and c < C:
                dw[tap * C + c] = tile[r, :Cout]
    ref = conv_block.conv_wgrad_plain(torch.from_numpy(x).float(),
                                      torch.from_numpy(dy).float()).numpy()
    assert np.abs(dw.reshape(3, 3, C, Cout) - ref).max() <= \
        SUM_TOL * np.abs(ref).max()


# ------------------------------------------ the wrappers on CPU tensors
def _steps_ok(got, ref, what):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape, what
    nz = ref != 0
    step = np.where(nz, 2.0 ** (np.floor(np.log2(np.abs(np.where(
        nz, ref, 1)))) - 7), 0)
    allowed = np.maximum(step, NEAR_ZERO * np.abs(ref).max())
    assert (np.abs(got - ref) <= allowed).all(), (what, np.abs(
        got - ref).max(), int((got != ref).sum()), got.size)


@pytest.mark.parametrize("shape", SMALL, ids=str)
def test_bf16_wrappers_on_cpu_take_plain_and_match_reference(shape):
    """On bf16 CPU tensors of shapes the wgmma kernels take on the card,
    ``conv3x3``, ``conv3x3_dgrad`` and ``conv_wgrad`` launch nothing (no
    instance counts) and match the reference's ``conv3x3``,
    ``conv3x3_dgrad`` (one bf16 step) and ``conv3x3_wgrad`` (1e-5)."""
    N, H, W, C, Cout = shape
    rs = np.random.RandomState(2)
    x = rs.randn(N, H, W, C).astype(np.float32)
    w = (rs.randn(3, 3, C, Cout) * np.sqrt(2.0 / (9 * C))).astype(np.float32)
    dy = rs.randn(N, H, W, Cout).astype(np.float32)
    bf = torch.bfloat16
    tx, tw, tdy = (torch.from_numpy(a).to(bf) for a in (x, w, dy))
    jx, jw, jdy = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, dy))
    assert conv_block.wgmma_takes(C, Cout, tx, tw)
    before = {fn.__name__: dict(fn.launches_by_instance)
              for fn in (conv_block.conv3x3, conv_block.conv_wgrad)}
    out = conv_block.conv3x3(tx, tw)
    assert out.dtype == bf
    _steps_ok(out, jpb.conv3x3(jx, jw), "conv3x3")
    dx = conv_block.conv3x3_dgrad(tw, tdy)
    _steps_ok(dx, jpb.conv3x3_dgrad(jw, jdy), "dgrad")
    dw = conv_block.conv_wgrad(tx, tdy)
    assert dw.dtype == torch.float32
    ref = np.asarray(jpb.conv3x3_wgrad(jx, jdy))
    assert np.abs(dw.numpy() - ref).max() <= SUM_TOL * np.abs(ref).max()
    assert {fn.__name__: fn.launches_by_instance
            for fn in (conv_block.conv3x3, conv_block.conv_wgrad)} == before


def test_fused_counts_name_each_bf16_kernel():
    """A fused step's counts list each bf16 kernel of ``conv3x3`` and
    ``conv_wgrad`` on its own (``<name>_bf16_wgmma``,
    ``<name>_bf16_mma_sync``) beside the dtype's sum, and no fp32 key;
    since the fp16 training slice the fp16 kernels likewise."""
    counts = ptrain._counts()
    for name in ("conv3x3", "conv_wgrad"):
        for key in (name, name + "_bf16", name + "_bf16_wgmma",
                    name + "_bf16_mma_sync", name + "_fp16",
                    name + "_fp16_wgmma", name + "_fp16_mma_sync"):
            assert key in counts, key
        assert name + "_fp32" not in counts
    assert conv_block.INSTANCES == ("fp32", "bf16_mma_sync", "bf16_wgmma",
                                    "fp16_mma_sync", "fp16_wgmma")


@pytest.mark.parametrize("name", ["conv3x3", "conv_wgrad", "conv_stats",
                                  "conv_affine"])
def test_each_kernel_has_one_counter_and_the_dtype_is_their_sum(name):
    """The four conv wrappers keep one count a kernel
    (``launches_by_instance``) and no count a dtype: a fused step's
    ``<name>_bf16`` is the sum of its two bf16 kernels', and an fp32
    launch adds to neither."""
    fn = getattr(conv_block, name)
    assert not hasattr(fn, "launches_by_dtype")
    saved = fn.launches, dict(fn.launches_by_instance)
    try:
        fn.launches = 0
        fn.launches_by_instance = dict.fromkeys(conv_block.INSTANCES, 0)
        for inst in ("bf16_wgmma", "bf16_wgmma", "bf16_mma_sync", "fp32"):
            conv_block._count(fn, inst)
        counts = ptrain._counts()
        assert (counts[name], counts[name + "_bf16"],
                counts[name + "_bf16_wgmma"],
                counts[name + "_bf16_mma_sync"]) == (4, 3, 2, 1)
    finally:
        fn.launches, fn.launches_by_instance = saved
