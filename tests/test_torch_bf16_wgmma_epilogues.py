"""The STATS and AFFINE epilogues of the bf16 ``wgmma`` loop
(``csrc/conv_bf16_wgmma.cu``: ``conv_stats`` and ``conv_affine`` on bf16)
as far as the CPU can hold them: their plans (every unit of work in one
range, one writer a tile), a host model of the STATS epilogue's
fixed-order sums over the ``wgmma`` m64 fragment layout and of the
column sum that follows, a model of the AFFINE epilogue's fp32
arithmetic and single rounding, the shape predicate with a residual, the
wrappers' card branch driven with a recording stand-in for the library
(which kernel each shape launches, with how many arguments, and how it
is counted), and the wrappers on bf16 CPU tensors against the JAX
package's Pallas kernels in interpret mode.

Tolerances.  Sums: Σz within 1e-5 of the channel's Σ|z|, Σz² within
1e-5 of itself (fp32 rounding over sums of a few hundred terms in
another order).  bf16 outputs against the reference: one bf16 step, or
1e-5 of the largest near 0 (the same exact products summed in fp32 in
another order).  The AFFINE model against ``conv_affine_plain``: bit for
bit, since both apply the same fp32 operations to the same fp32 z."""
import contextlib
import threading

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
f32 = np.float32
# ResNet-50's four 3x3 stages at the bf16 training step's batch of 128 and
# at the serving bucket of 8, and the kernels' edges
PLAN_SHAPES = [(128, 56, 56, 64, 64), (128, 28, 28, 128, 128),
               (128, 14, 14, 256, 256), (128, 7, 7, 512, 512),
               (8, 56, 56, 64, 64), (8, 28, 28, 128, 128),
               (8, 14, 14, 256, 256), (8, 7, 7, 512, 512),
               (1, 8, 16, 64, 64), (3, 7, 9, 40, 24), (2, 11, 13, 72, 96)]
# small shapes the wgmma kernels take (C, Cout multiples of 8)
SMALL = [(2, 6, 6, 64, 64), (1, 5, 7, 40, 24), (2, 4, 3, 16, 136)]
# the column sum's block: columns and row groups (conv_bf16_wgmma.cu)
SUM_COLS, SUM_ROWS = 8, 128


def _plan(shape, per_sm):
    N, H, W, C, Cout = shape
    return conv_block.conv3x3_splits(N * H * W, 9 * SLAB * -(-C // SLAB),
                                      Cout, 132, per_sm, chunk=SLAB)


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_epilogue_plans_cover_every_unit_and_name_one_writer(shape, per_sm):
    """The STATS and AFFINE instances run ``conv3x3``'s wgmma plan (chunks
    of one tap's 64-channel slab, K = 9·64·ceil(C/64)): the ranges cover
    every (tile, chunk) unit once, and ``tile_writers`` names exactly one
    kernel for each tile (the main kernel for a tile one range covers
    whole, else the cut kernel of the range that starts inside it), so
    each row of STATS' per-tile sums and each AFFINE output is written
    once."""
    plan = _plan(shape, per_sm)
    N, H, W, C, Cout = shape
    assert plan.chunks == 9 * -(-C // SLAB)
    assert plan.ranges == min(132 * per_sm, plan.tiles * plan.chunks)
    total = plan.tiles * plan.chunks
    starts = [b * total // plan.ranges for b in range(plan.ranges + 1)]
    units = [u for b in range(plan.ranges)
             for u in range(starts[b], starts[b + 1])]
    assert units == list(range(total))
    writers = conv_block.tile_writers(plan)
    assert sorted(t for t, _, _ in writers) == list(range(plan.tiles))
    for tile, kind, b in writers:
        t0, t1 = tile * plan.chunks, (tile + 1) * plan.chunks
        if kind == "main":
            assert starts[b] <= t0 and t1 <= starts[b + 1]
        else:
            assert starts[b] <= t0 < starts[b + 1] < t1


def test_epilogue_plans_ask_their_own_occupancy(monkeypatch):
    """Each wgmma conv kernel is planned at its own occupancy: the plan of
    ``conv_stats`` and ``conv_affine`` asks ``mxt_<op>_wgmma_blocks_per_sm``
    (entries ``_build`` binds), and a plan at the same blocks an SM is
    ``conv3x3``'s."""
    asked = []

    def per_sm(entry, index, bn, vec):
        asked.append((entry, bn, vec))
        return 1

    monkeypatch.setattr(conv_block, "_per_sm", per_sm)
    monkeypatch.setattr(conv_block, "_sm_count", lambda index: 132)
    conv_block._wgmma_conv_plan.cache_clear()
    try:
        plans = {op: conv_block._wgmma_conv_plan(op, 0, 128 * 56 * 56, 64,
                                                 64)
                 for op in ("conv3x3", "conv_stats", "conv_affine")}
    finally:
        conv_block._wgmma_conv_plan.cache_clear()
    assert [a[0] for a in asked] == [
        "mxt_conv3x3_wgmma_blocks_per_sm", "mxt_conv_stats_wgmma_blocks_per_sm",
        "mxt_conv_affine_wgmma_blocks_per_sm"]
    assert all(a[1:] == (64, 1) for a in asked)
    assert all(e in _build._SIGNATURES for e, _, _ in asked)
    assert plans["conv_stats"] == plans["conv_affine"] == plans["conv3x3"]


# --------------------------------------------- a host model of STATS
def _fma(a, b, c):
    """fp32 fused multiply-add: the product exact in fp64, one rounding
    (the sum's fp64 rounding can differ from a true fma by a tie)."""
    return (a.astype(np.float64) * b + c).astype(f32)


def _tile_stats_model(zt, valid):
    """(Σz, Σz²) of a whole tile's columns (``zt`` (128, BN) fp32, rows
    ``valid`` and on < M) as ``tile_stats`` sums them: thread (warp,
    lane) holds rows 16·warp + lane // 4 and + 8 and columns 8j + 2(lane
    % 4) + e of the m64 fragments; each thread its two rows, an
    xor-shuffle over lanes 4, 8, 16 (the 8 row groups), then the 8 warps
    in order (warpgroup 0's four, then warpgroup 1's)."""
    BN = zt.shape[1]
    lane = np.arange(32)
    warp = np.arange(8)
    r = warp[:, None] * 16 + (lane // 4)[None, :]              # (8, 32)
    cols = (8 * np.arange(BN // 8)[None, :, None] +
            2 * (lane % 4)[:, None, None] + np.arange(2)[None, None, :])
    R0 = r[:, :, None, None]
    v0, v1 = zt[R0, cols[None]], zt[R0 + 8, cols[None]]        # (8,32,J,2)
    in0, in1 = R0 < valid, R0 + 8 < valid
    zero = np.zeros_like(v0)
    s1 = np.where(in0, zero + v0, zero)
    s2 = np.where(in0, _fma(v0, v0, zero), zero)
    s1 = np.where(in1, s1 + v1, s1)
    s2 = np.where(in1, _fma(v1, v1, s2), s2)
    for off in (4, 8, 16):
        s1 = s1 + s1[:, lane ^ off]
        s2 = s2 + s2[:, lane ^ off]
    red = np.zeros((8, 2, BN), f32)
    for t in range(4):                       # lane t writes its columns
        red[:, 0, cols[t].ravel()] = s1[:, t].reshape(8, -1)
        red[:, 1, cols[t].ravel()] = s2[:, t].reshape(8, -1)
    out = red[0].copy()
    for q in range(1, 8):
        out = out + red[q]
    return out


def _column_sum_model(tstats):
    """``conv_stats_wgmma_sum_kernel`` over tstats (rows, 2, Cout): row
    group y adds rows y, y + 128, ... in turn, then the 128 partials meet
    in a fixed binary tree."""
    rows = tstats.reshape(tstats.shape[0], -1)
    part = np.zeros((SUM_ROWS, rows.shape[1]), f32)
    for y in range(SUM_ROWS):
        for r in range(y, rows.shape[0], SUM_ROWS):
            part[y] = part[y] + rows[r]
    h = SUM_ROWS // 2
    while h:
        part[:h] = part[:h] + part[h:2 * h]
        h //= 2
    return part[0].reshape(2, -1)


def _stats_model(z):
    """(Σz, Σz²) of fp32 z (M, Cout) through every tile's epilogue (the
    ragged last tile's rows past M masked) and the column sum."""
    M, Cout = z.shape
    BN = conv_block.wgrad_tile_cols(Cout)
    tiles_m, tiles_n = -(-M // 128), -(-Cout // BN)
    zp = np.zeros((tiles_m * 128, tiles_n * BN), f32)
    zp[:M, :Cout] = z
    tstats = np.zeros((tiles_m, 2, Cout), f32)
    for tm in range(tiles_m):
        for tn in range(tiles_n):
            s = _tile_stats_model(zp[tm * 128:(tm + 1) * 128,
                                     tn * BN:(tn + 1) * BN],
                                  M - tm * 128)
            n = min(BN, Cout - tn * BN)
            tstats[tm, :, tn * BN:tn * BN + n] = s[:, :n]
    return _column_sum_model(tstats)


@pytest.mark.parametrize("shape", SMALL + [(3, 7, 9, 40, 24)], ids=str)
def test_stats_epilogue_model_matches_plain_sums(shape):
    """Σz and Σz² as the STATS epilogue and column sum order them, from
    the fp32 z before its rounding (rows past M masked, channels past
    Cout dropped), within 1e-5 of ``conv_stats_plain``'s and the same on
    a rerun."""
    N, H, W, C, Cout = shape
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(N, H, W, C).astype(f32)).bfloat16()
    w = torch.from_numpy((rs.randn(3, 3, C, Cout) * np.sqrt(2.0 / (9 * C)))
                         .astype(f32)).bfloat16()
    z = conv_block.conv3x3_plain(x.float(), w.float()).reshape(-1, Cout)
    got = _stats_model(z.numpy())
    assert np.array_equal(got, _stats_model(z.numpy()))
    rz, r1, r2 = conv_block.conv_stats_plain(x, w)
    mag = z.abs().sum(0).numpy()
    assert (np.abs(got[0] - r1.numpy()) <= SUM_TOL * mag).all()
    assert (np.abs(got[1] - r2.numpy()) <= SUM_TOL * r2.numpy()).all()
    assert torch.equal(rz, z.reshape(N, H, W, Cout).bfloat16())


def test_column_sum_model_is_a_fixed_order():
    """The column sum's order is fixed by the row count alone: the same
    rows give the same bits, and rows past a multiple of 128 change only
    the partials they fall in."""
    rs = np.random.RandomState(4)
    t = rs.randn(300, 2, 16).astype(f32)
    a = _column_sum_model(t)
    assert np.array_equal(a, _column_sum_model(t.copy()))
    assert np.allclose(a, t.astype(np.float64).sum(0), rtol=1e-5,
                       atol=1e-5 * np.abs(t).sum(0).max())


# -------------------------------------------- a host model of AFFINE
def _affine_model(z, gamma, beta, mean, var, res, eps, relu):
    """The AFFINE epilogue on fp32 z (N, H, W, Cout): each column's fold
    (scale = γ·rsqrt(σ² + ε), shift = β − μ·scale, from the bf16 vectors
    widened), then z·scale + shift, + the widened residual, the ReLU,
    each an fp32 operation rounded on its own, and one rounding to
    bf16."""
    sc = gamma.float() * torch.rsqrt(var.float() + eps)
    sh = beta.float() - mean.float() * sc
    y = z.numpy() * sc.numpy()
    y = y + sh.numpy()
    if res is not None:
        y = y + res.float().numpy()
    if relu:
        y = np.maximum(y, f32(0))
    return torch.from_numpy(y).bfloat16()


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SMALL, ids=str)
def test_affine_epilogue_model_equals_plain(shape, residual, relu):
    """The AFFINE epilogue on the fp32 z of ``conv3x3_plain`` (the fold
    in fp32, the residual and ReLU in fp32, one bf16 rounding) equals
    ``conv_affine_plain`` on the bf16 operands bit for bit."""
    N, H, W, C, Cout = shape
    rs = np.random.RandomState(5)
    bf = torch.bfloat16

    def t(a):
        return torch.from_numpy(a.astype(f32)).to(bf)

    x = t(rs.randn(N, H, W, C))
    w = t(rs.randn(3, 3, C, Cout) * np.sqrt(2.0 / (9 * C)))
    g, b, mu = (t(1 + 0.1 * rs.randn(Cout)), t(0.1 * rs.randn(Cout)),
                t(0.1 * rs.randn(Cout)))
    var = t(0.5 + rs.rand(Cout))
    res = t(rs.randn(N, H, W, Cout)) if residual else None
    z = conv_block.conv3x3_plain(x.float(), w.float())
    got = _affine_model(z, g, b, mu, var, res, 1e-5, relu)
    ref = conv_block.conv_affine_plain(x, w, g, b, mu, var, res, 1e-5, relu)
    assert ref.dtype == bf and torch.equal(got, ref)


# ----------------------------------------------- the shape predicate
@pytest.mark.parametrize("offset,takes", [(0, True), (8, True), (4, False),
                                          (2, False)])
def test_wgmma_takes_a_residual_only_aligned(offset, takes):
    """``conv_affine`` takes the wgmma kernel only where its residual too
    is 16-byte aligned (a view at an offset of 8 bf16 values is, of 4 or
    2 is not); without a residual the same tensors take it."""
    bf = torch.bfloat16
    x = torch.zeros(2, 3, 3, 64, dtype=bf)
    w = torch.zeros(3, 3, 64, 64, dtype=bf)
    out = torch.zeros(2, 3, 3, 64, dtype=bf)
    res = torch.zeros(offset + 2 * 3 * 3 * 64, dtype=bf)[offset:].view(
        2, 3, 3, 64)
    assert conv_block.wgmma_takes(64, 64, x, w, out)
    assert conv_block.wgmma_takes(64, 64, x, w, out, res) is takes


# ------------------------------ the card branch with a stand-in library
class _Lib:
    """Records each entry called and its arguments; every call succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mxt_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: a recording library, one
    block an SM on 132 SMs, no device guard, stream or capture; the counts
    saved and restored."""
    lib = _Lib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(conv_block, "_on_card", lambda what, x: True)
    monkeypatch.setattr(conv_block, "_sm_count", lambda index: 132)
    monkeypatch.setattr(conv_block, "_per_sm", lambda *a: 1)
    monkeypatch.setattr(conv_block, "_stream", lambda dev: 0)
    monkeypatch.setattr(conv_block, "_raw_stream", lambda dev: 0)
    monkeypatch.setattr(conv_block, "_device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(conv_block, "_scratch", threading.local())
    conv_block._wgmma_conv_plan.cache_clear()
    fns = (conv_block.conv_stats, conv_block.conv_affine)
    saved = [(fn.launches, dict(fn.launches_by_instance)) for fn in fns]
    yield lib
    conv_block._wgmma_conv_plan.cache_clear()
    for fn, (n, by) in zip(fns, saved):
        fn.launches, fn.launches_by_instance = n, by


def _operands(N, H, W, C, Cout, dtype, residual=False):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(N, H, W, C, generator=g).to(dtype)
    w = torch.randn(3, 3, C, Cout, generator=g).to(dtype)
    vecs = [torch.ones(Cout, dtype=dtype) for _ in range(4)]
    res = torch.randn(N, H, W, Cout, generator=g).to(dtype) \
        if residual else None
    return x, w, vecs, res


@pytest.mark.parametrize("shape,dtype,entry,inst", [
    ((2, 6, 6, 64, 64), torch.bfloat16, "mxt_conv_stats_wgmma_bf16",
     "bf16_wgmma"),
    ((2, 5, 7, 20, 12), torch.bfloat16, "mxt_conv_stats_tc_bf16",
     "bf16_mma_sync"),
    ((2, 6, 6, 64, 64), torch.float32, "mxt_conv_stats_tc_f32", "fp32")])
def test_conv_stats_launches_the_instance_its_shape_takes(card, shape, dtype,
                                                          entry, inst):
    """``conv_stats`` on the card: a bf16 shape the wgmma kernel takes
    calls ``mxt_conv_stats_wgmma_bf16``, the ragged C = 20 the
    ``mma.sync`` entry, fp32 the fp32 entry; each with the argument count
    ``_build`` binds; one launch counted under its kernel."""
    x, w, _, _ = _operands(*shape, dtype)
    before = dict(conv_block.conv_stats.launches_by_instance)
    z, s1, s2 = conv_block.conv_stats(x, w)
    assert [c[0] for c in card.calls] == [entry]
    assert len(card.calls[0][1]) == len(_build._SIGNATURES[entry])
    assert z.dtype == dtype and s1.shape == s2.shape == (shape[4],)
    moved = {k: v - before[k] for k, v in
             conv_block.conv_stats.launches_by_instance.items()}
    assert moved == {k: int(k == inst) for k in conv_block.INSTANCES}


@pytest.mark.parametrize("shape,dtype,residual,offset,entry,inst", [
    ((2, 6, 6, 64, 64), torch.bfloat16, False, 0,
     "mxt_conv_affine_wgmma_bf16", "bf16_wgmma"),
    ((2, 6, 6, 64, 64), torch.bfloat16, True, 0,
     "mxt_conv_affine_wgmma_bf16", "bf16_wgmma"),
    ((2, 6, 6, 64, 64), torch.bfloat16, True, 4, "mxt_conv_affine_bf16",
     "bf16_mma_sync"),
    ((2, 5, 7, 20, 12), torch.bfloat16, False, 0, "mxt_conv_affine_bf16",
     "bf16_mma_sync"),
    ((2, 6, 6, 64, 64), torch.float32, True, 0, "mxt_conv_affine_f32",
     "fp32")])
def test_conv_affine_launches_the_instance_its_shape_takes(
        card, shape, dtype, residual, offset, entry, inst):
    """``conv_affine`` on the card: the wgmma entry where the shape and
    every tensor, the residual included, suit TMA; a residual at a
    misaligned offset or the ragged C = 20 the ``mma.sync`` entry; fp32
    the fp32 entry; each with the argument count ``_build`` binds (the
    residual's pointer, or None), one launch counted under its kernel."""
    x, w, vecs, res = _operands(*shape, dtype, residual)
    if residual and offset:
        res = torch.cat([torch.zeros(offset, dtype=dtype),
                         res.reshape(-1)])[offset:].view(res.shape)
    before = dict(conv_block.conv_affine.launches_by_instance)
    out = conv_block.conv_affine(x, w, *vecs, res, 1e-5, True)
    assert [c[0] for c in card.calls] == [entry]
    args = card.calls[0][1]
    assert len(args) == len(_build._SIGNATURES[entry])
    assert (args[6] is None) == (res is None)
    assert out.dtype == dtype and out.shape == shape[:3] + (shape[4],)
    moved = {k: v - before[k] for k, v in
             conv_block.conv_affine.launches_by_instance.items()}
    assert moved == {k: int(k == inst) for k in conv_block.INSTANCES}


def test_fp16_still_raises_on_the_card(card):
    """What still raises on the card is a dtype no instance takes: fp16,
    refused here until the fp16 training slice, now reaches the fp16
    ``wgmma`` entries of both kernels (``test_torch_fp16_kernels`` holds
    them), and float64 raises ``TypeError`` before any launch."""
    x, w, vecs, _ = _operands(1, 4, 4, 64, 64, torch.float16)
    conv_block.conv_stats(x, w)
    conv_block.conv_affine(x, w, *vecs)
    assert [c[0] for c in card.calls] == ["mxt_conv_stats_wgmma_f16",
                                          "mxt_conv_affine_wgmma_f16"]
    x, w, vecs, _ = _operands(1, 4, 4, 64, 64, torch.float64)
    with pytest.raises(TypeError, match="float64"):
        conv_block.conv_stats(x, w)
    with pytest.raises(TypeError, match="float64"):
        conv_block.conv_affine(x, w, *vecs)
    assert len(card.calls) == 2


@pytest.mark.parametrize("fp32_vecs,bits", [
    ((2, 3), 4 | 8),          # a half step's frozen segment: fp32 mean, var
    ((0, 1, 2, 3), 15),
    ((), 0)])
def test_bf16_conv_affine_takes_fp32_batchnorm_vectors(card, fp32_vecs,
                                                       bits):
    """The repair of a frozen segment in a half step: a bf16
    ``conv_affine`` whose BatchNorm vectors are fp32 (the step keeps its
    running statistics fp32 while γ and β are cast) reaches the ``wgmma``
    entry with each vector's dtype passed on (``vf32``, a bit a vector:
    1 γ, 2 β, 4 μ, 8 σ²) instead of raising, one ``bf16_wgmma`` launch
    counted; bf16 vectors pass 0, the parent's arguments."""
    x, w, vecs, _ = _operands(2, 6, 6, 64, 64, torch.bfloat16)
    vecs = [v.float() if i in fp32_vecs else v for i, v in enumerate(vecs)]
    before = conv_block.conv_affine.launches_by_instance["bf16_wgmma"]
    out = conv_block.conv_affine(x, w, *vecs, None, 1e-5, True)
    (name, args), = card.calls
    assert name == "mxt_conv_affine_wgmma_bf16"
    assert len(args) == len(_build._SIGNATURES[name])
    assert args[16] == bits
    assert out.dtype == torch.bfloat16
    assert conv_block.conv_affine.launches_by_instance["bf16_wgmma"] == \
        before + 1


def test_stats_tile_sums_follow_the_partial_sums_in_the_scratch(card):
    """The wgmma ``conv_stats`` passes its per-tile sums inside its
    scratch, right after the 2 x ranges partial tiles, and the scratch
    holds both."""
    x, w, _, _ = _operands(2, 6, 6, 64, 64, torch.bfloat16)
    conv_block.conv_stats(x, w)
    (name, args), = card.calls
    plan = conv_block._wgmma_conv_plan("conv_stats", None, 72, 64, 64)
    slots = 2 * plan.ranges * conv_block.CONV_ROWS * plan.bn
    assert name == "mxt_conv_stats_wgmma_bf16"
    assert args[4] - args[2] == 4 * slots
    bufs = conv_block._scratch.bufs
    assert max(b.numel() for b in bufs.values()) >= slots + 1 * 2 * 64


# ------------------------------------------ the wgmma launches' scratch
@pytest.fixture
def scratch(monkeypatch):
    """``_part`` on the CPU: the stream handle and the capture state as
    the test sets them, an empty cache."""
    state = {"stream": 1, "capturing": False}
    monkeypatch.setattr(conv_block, "_raw_stream",
                        lambda dev: state["stream"])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    monkeypatch.setattr(conv_block, "_scratch", threading.local())
    return state


CPU = torch.device("cpu")


def test_scratch_is_reused_on_one_stream_and_grows(scratch):
    """One fp32 buffer a stream: a request it covers gets it again, a
    larger one a larger buffer, which later requests then get."""
    a = conv_block._part(CPU, (4, 128, 64))
    assert a.dtype == torch.float32 and a.numel() == 4 * 128 * 64
    assert conv_block._part(CPU, (2, 128, 64)) is a
    b = conv_block._part(CPU, (8, 128, 64))
    assert b is not a and b.numel() == 8 * 128 * 64
    assert conv_block._part(CPU, (4, 128, 64)) is b


def test_scratch_is_kept_apart_for_each_stream_and_thread(scratch):
    """Another stream, or another thread on the same stream, gets a
    buffer of its own: launches that the stream does not order never
    share one."""
    a = conv_block._part(CPU, (2, 128, 64))
    scratch["stream"] = 2
    b = conv_block._part(CPU, (2, 128, 64))
    assert b is not a
    scratch["stream"] = 1
    assert conv_block._part(CPU, (2, 128, 64)) is a
    other = []
    t = threading.Thread(
        target=lambda: other.append(conv_block._part(CPU, (2, 128, 64))))
    t.start()
    t.join()
    assert other[0] is not a


def test_scratch_is_fresh_while_a_graph_is_captured(scratch):
    """Under capture every launch gets a fresh buffer (the graph keeps
    it) and the cached one is left alone."""
    a = conv_block._part(CPU, (2, 128, 64))
    scratch["capturing"] = True
    b = conv_block._part(CPU, (2, 128, 64))
    c = conv_block._part(CPU, (2, 128, 64))
    assert a is not b and b is not c
    scratch["capturing"] = False
    assert conv_block._part(CPU, (2, 128, 64)) is a


# --------------------------------------------------------- the counts
@pytest.mark.parametrize("name", ["conv_stats", "conv_affine"])
def test_epilogue_wrappers_count_by_kernel(name):
    """``conv_stats`` and ``conv_affine`` count each kernel
    (``launches_by_instance``) and no dtype, and a fused step's counts
    list ``<name>_bf16_wgmma`` and ``<name>_bf16_mma_sync`` beside
    ``<name>_bf16``, their sum."""
    fn = getattr(conv_block, name)
    assert not hasattr(fn, "launches_by_dtype")
    assert set(fn.launches_by_instance) == set(conv_block.INSTANCES)
    counts = ptrain._counts()
    for key in (name, name + "_bf16", name + "_bf16_wgmma",
                name + "_bf16_mma_sync"):
        assert key in counts, key
    assert counts[name + "_bf16"] == counts[name + "_bf16_wgmma"] + \
        counts[name + "_bf16_mma_sync"]


def test_new_entries_are_bound():
    """The STATS and AFFINE entries, their occupancy entries and the map
    cache's counter are bound by ``_build``."""
    for name in ("mxt_conv_stats_wgmma_bf16", "mxt_conv_affine_wgmma_bf16",
                 "mxt_conv_stats_wgmma_blocks_per_sm",
                 "mxt_conv_affine_wgmma_blocks_per_sm",
                 "mxt_wgmma_map_cache_stats"):
        assert name in _build._SIGNATURES, name


# ----------------------- the wrappers on CPU tensors against the reference
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
def test_bf16_stats_on_cpu_matches_reference_conv_stats(shape):
    """On bf16 CPU tensors of shapes the STATS kernel takes on the card,
    ``conv_stats`` launches nothing and matches the reference's
    ``_conv_stats`` (its Pallas kernel in interpret mode): z within one
    bf16 step, Σz and Σz² within 1e-5 of their largest."""
    N, H, W, C, Cout = shape
    rs = np.random.RandomState(6)
    x = rs.randn(N, H, W, C).astype(f32)
    w = (rs.randn(3, 3, C, Cout) * np.sqrt(2.0 / (9 * C))).astype(f32)
    tx, tw = (torch.from_numpy(a).bfloat16() for a in (x, w))
    assert conv_block.wgmma_takes(C, Cout, tx, tw)
    before = dict(conv_block.conv_stats.launches_by_instance)
    z, s1, s2 = conv_block.conv_stats(tx, tw)
    rz, r1, r2 = jpb._conv_stats(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(w, jnp.bfloat16))
    _steps_ok(z, rz, "z")
    for got, ref in ((s1, r1), (s2, r2)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= \
            SUM_TOL * np.abs(ref).max()
    assert conv_block.conv_stats.launches_by_instance == before
