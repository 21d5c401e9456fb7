"""The fp16 instances of the fused block's kernels in the PyTorch port
against the JAX package's on the CPU: the plain versions of rows 7
(``conv3x3`` and its dgrad use), 8 (``conv_affine``, fp16 vectors and
the fp32 running statistics a half step passes), 9 (``conv_stats``), 10
(``bn_affine``) and 11 (``conv_wgrad``) against the reference's Pallas
kernels in interpret mode on fp16 operands; the fp16
``residual_block_fused`` forward and VJP, training and frozen (the frozen
one with fp32 statistics: the repair of a frozen segment in a half
step); fp16's overflow; and, with a recording stand-in for the library,
which C entry each fp16 wrapper reaches on the card and under which
instance it counts the launch.  On the card the wrappers launch the
kernels, which ``chip_smoke.py fp16_train_kernels`` holds against these
plain versions.

Tolerances (those of ``test_torch_bf16_train_kernels``, whose helpers
these tests share, at fp16's width).  One fp16 step of a value v is
2^(floor(log2 |v|) - 10).  A plain version and the reference's kernel sum
the same exact fp16 products (11 + 11 significant bits, exact in fp32)
in fp32 in another order, so an fp16 output may round to the
neighbouring value: one step, or, near 0, 1e-5 of the largest output.
fp32 results (the sums, dW) within 1e-5 of their largest magnitude: fp32
rounding over sums of a few thousand terms.  The fused block's
gradients dγ, dβ and the residual's within one fp16 step; dx and dW
within one fp16 step or 2^-10 of their largest magnitude (``CHAIN``): Σz
summed in another order can move the fp32 batch mean by an ulp, which
moves an fp16 x̂, and with it dz, by one fp16 step at a few elements
(the chain itself rounds op for op as the reference's does), and dx and
dW sum those over 9·C taps or N·H·W pixels, so their error is fp16's
relative precision at the scale of the sum, not of each value."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import pallas_block as jpb  # noqa: E402
from mxnet_tpu_torch import _build  # noqa: E402
from mxnet_tpu_torch.ops import conv_block  # noqa: E402
from mxnet_tpu_torch.parallel import train as ptrain  # noqa: E402
from test_torch_bf16_train_kernels import (SUM_TOL, _close, _data,  # noqa
                                           _np, _steps_ok)
from test_torch_bf16_wgmma_epilogues import card  # noqa: E402,F401

torch.set_num_threads(1)

F16 = torch.float16
# two stage shapes and the ragged C = 20 (N, H, W, C, Cout)
SHAPES = [(1, 12, 12, 64, 64), (1, 6, 6, 128, 128), (1, 5, 7, 20, 12)]
CHAIN = 2.0 ** -10      # dx, dW after the dz chain: of the largest


def _tt(a, dtype=F16):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jj(a, dtype=jnp.float16):
    return jnp.asarray(a, dtype)


def _within_step(got, ref, what):
    return _steps_ok(got, ref, "float16", what)


@pytest.fixture
def forced(monkeypatch):
    """The reference's fused block on its Pallas route at the first
    shape (interpret mode on the CPU)."""
    _, H, W, C, _ = SHAPES[0]
    monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
    monkeypatch.setenv("MXNET_TPU_PALLAS_STAGES", f"{H}x{W}x{C}=pallas")


def _bn(Cout, seed):
    rs = np.random.RandomState(seed)
    return ((1 + 0.1 * rs.randn(Cout)).astype(np.float32),
            (0.1 * rs.randn(Cout)).astype(np.float32),
            (0.1 * rs.randn(Cout)).astype(np.float32),
            rs.uniform(0.5, 1.5, Cout).astype(np.float32))


# ------------------------------------------------- the kernels' plain
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv3x3_and_dgrad_plain_fp16_match_reference(shape):
    """Row 7's fp16 instance: the forward conv and the dgrad (the conv of
    dy with the rotated weight, cast to dy's dtype) within one fp16 step
    of the reference's Pallas conv on fp16 operands."""
    x, w, dy = _data(shape, 1)
    out = conv_block.conv3x3(_tt(x), _tt(w))
    assert out.dtype == F16
    _within_step(out, jpb.conv3x3(_jj(x), _jj(w)), "conv3x3")
    dx = conv_block.conv3x3_dgrad(_tt(w), _tt(dy))
    assert dx.dtype == F16
    _within_step(dx, jpb.conv3x3_dgrad(_jj(w), _jj(dy)), "dgrad")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv_stats_plain_fp16_matches_reference(shape):
    """Row 9's fp16 instance: z in fp16 within one step, Σz and Σz² (fp32,
    summed before z is rounded) within 1e-5 of their largest."""
    x, w, _ = _data(shape, 2)
    z, s1, s2 = conv_block.conv_stats(_tt(x), _tt(w))
    rz, r1, r2 = jpb._conv_stats(_jj(x), _jj(w))
    assert z.dtype == F16 and s1.dtype == torch.float32
    _within_step(z, rz, "z")
    _close(s1, r1, SUM_TOL, "sum z")
    _close(s2, r2, SUM_TOL, "sum z^2")


def test_conv_stats_plain_fp16_overflows_as_the_reference():
    """fp16's range: where the fp32 conv passes 65504, z is +inf exactly
    where the reference's is (its cast of the f32 accumulator), while Σz
    and Σz², taken before that rounding, stay finite and agree."""
    rs = np.random.RandomState(3)
    x = (40 * (1 + 0.01 * rs.randn(1, 6, 6, 64))).astype(np.float32)
    w = (4 * (1 + 0.01 * rs.randn(3, 3, 64, 64))).astype(np.float32)
    z, s1, s2 = conv_block.conv_stats(_tt(x), _tt(w))
    rz, r1, r2 = jpb._conv_stats(_jj(x), _jj(w))
    inf = np.isinf(_np(rz))
    assert inf.any() and (~inf).any()
    np.testing.assert_array_equal(np.isinf(_np(z)), inf)
    _within_step(z.float()[torch.from_numpy(~inf)],
                 _np(rz)[~inf], "finite z")
    assert torch.isfinite(s1).all() and torch.isfinite(s2).all()
    _close(s1, r1, SUM_TOL, "sum z")
    _close(s2, r2, SUM_TOL, "sum z^2")


@pytest.mark.parametrize("stats", ["fp16", "fp32"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "residual"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv_affine_plain_fp16_matches_reference(shape, residual, stats):
    """Row 8's fp16 instance: the conv, the frozen BN folded in fp32 (as
    ``_fold``; γ and β fp16, μ and σ² fp16 or, as a half step passes its
    running statistics, fp32), the residual and the ReLU, one rounding:
    within one fp16 step of the reference's ``_conv_affine`` kernel on the
    folded scale and shift."""
    x, w, _ = _data(shape, 5)
    Cout = shape[4]
    g, b, mu, var = _bn(Cout, 6)
    res = np.random.RandomState(7).randn(*shape[:3], Cout).astype(
        np.float32) if residual else None
    sd_t, sd_j = (torch.float32, jnp.float32) if stats == "fp32" else \
        (F16, jnp.float16)
    out = conv_block.conv_affine(
        _tt(x), _tt(w), _tt(g), _tt(b), _tt(mu, sd_t), _tt(var, sd_t),
        None if res is None else _tt(res), 1e-5, True)
    inv = jax.lax.rsqrt(_jj(var, sd_j).astype(jnp.float32) + 1e-5)
    sc, sh = jpb._fold(_jj(g), _jj(b), _jj(mu, sd_j), inv)
    ref = jpb._conv_affine(_jj(x), _jj(w), sc, sh,
                           None if res is None else _jj(res), True)
    assert out.dtype == F16
    _within_step(out, ref, "conv_affine")


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_bn_affine_plain_fp16_matches_reference(shape, residual, relu):
    """Row 10's fp16 instance: fp16 z and residual, fp32 scale and shift,
    the arithmetic in fp32, one rounding: within one fp16 step of the
    reference's ``_affine`` kernel."""
    N, H, W, _, Cout = shape
    rs = np.random.RandomState(3)
    z = rs.randn(N, H, W, Cout).astype(np.float32)
    sc = (1 + 0.2 * rs.randn(Cout)).astype(np.float32)
    sh = (0.1 * rs.randn(Cout)).astype(np.float32)
    res = rs.randn(N, H, W, Cout).astype(np.float32) if residual else None
    out = conv_block.bn_affine(_tt(z), torch.from_numpy(sc),
                               torch.from_numpy(sh),
                               None if res is None else _tt(res), relu)
    ref = jpb._affine(_jj(z), jnp.asarray(sc), jnp.asarray(sh),
                      None if res is None else _jj(res), relu)
    assert out.dtype == F16
    _within_step(out, ref, "bn_affine")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv_wgrad_plain_fp16_matches_reference(shape):
    """Row 11's fp16 instance: dW fp32 from fp16 x and dy within 1e-5 of
    its largest magnitude of the reference's Pallas wgrad."""
    x, _, dy = _data(shape, 4)
    dw = conv_block.conv_wgrad(_tt(x), _tt(dy))
    assert dw.dtype == torch.float32
    _close(dw, jpb.conv3x3_wgrad(_jj(x), _jj(dy)), SUM_TOL, "dW")


# -------------------------------------------------- the fused block
@pytest.mark.parametrize("frozen", [False, True], ids=["train", "frozen"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "residual"])
def test_residual_block_fused_fp16_forward_and_vjp(forced, frozen,
                                                   residual):
    """``residual_block_fused`` on fp16 x, w, γ, β (and residual) with
    fp32 statistics, as an fp16 step passes them (frozen: the running
    statistics, the repair's case), against the reference's with
    ``bwd="pallas"`` under ``jax.vjp``: the output within one fp16 step;
    the batch statistics (training) within 1e-5; dx, dw, dγ, dβ and the
    residual's gradient within one fp16 step."""
    N, H, W, C, Cout = SHAPES[0]
    x, w, dy = _data(SHAPES[0], 12)
    g, b, mu, var = _bn(Cout, 11)
    res = np.random.RandomState(13).randn(N, H, W, Cout).astype(
        np.float32) if residual else None

    def ref_fn(x_, w_, g_, b_, r_):
        return jpb.residual_block_fused(
            x_, w_, g_, b_, jnp.asarray(mu), jnp.asarray(var), r_, eps=1e-5,
            frozen=frozen, relu=True, bwd="pallas")
    args = [_jj(x), _jj(w), _jj(g), _jj(b), None if res is None
            else _jj(res)]
    if res is None:
        (rout, rm, rv), vjp = jax.vjp(
            lambda a, b_, c, d: ref_fn(a, b_, c, d, None), *args[:4])
    else:
        (rout, rm, rv), vjp = jax.vjp(ref_fn, *args)
    tt = [_tt(x).requires_grad_(), _tt(w).requires_grad_(),
          _tt(g).requires_grad_(), _tt(b).requires_grad_()]
    tres = None if res is None else _tt(res).requires_grad_()
    out, tm, tv = conv_block.residual_block_fused(
        *tt, torch.from_numpy(mu), torch.from_numpy(var), tres, eps=1e-5,
        frozen=frozen, relu=True)
    assert out.dtype == F16
    _within_step(out, rout, "out")
    if not frozen:
        _close(tm, rm, SUM_TOL, "batch mean")
        _close(tv, rv, SUM_TOL, "batch var")
    cts = vjp((jnp.asarray(dy, jnp.float16), jnp.zeros_like(rm),
               jnp.zeros_like(rv)))
    wrt = tt + ([tres] if tres is not None else [])
    grads = torch.autograd.grad(out, wrt, _tt(dy))
    for what, got, ref in zip(["dx", "dw", "dgamma", "dbeta", "dres"],
                              grads, cts):
        assert got.dtype == F16, what
        if what in ("dx", "dw"):
            err = np.abs(_np(got) - _np(ref))
            top = np.abs(_np(ref)).max()
            ok = err <= np.maximum(CHAIN * top, 2.0 ** (np.floor(np.log2(
                np.maximum(np.abs(_np(ref)), 1e-30))) - 10))
            assert ok.all(), (what, err.max(), top)
        else:
            _steps_ok(got, ref, "float16", what)


# ------------------------------ the card branch with a stand-in library
def _operands(N, H, W, C, Cout, dtype=F16):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(N, H, W, C, generator=g).to(dtype)
    w = torch.randn(3, 3, C, Cout, generator=g).to(dtype)
    dy = torch.randn(N, H, W, Cout, generator=g).to(dtype)
    return x, w, dy


@pytest.fixture
def counts():
    """The five wrappers' counts, saved and restored around a test."""
    fns = list(ptrain.kernel_wrappers().values())[:5]
    saved = [(fn.launches, dict(getattr(fn, "launches_by_instance", {})),
              dict(getattr(fn, "launches_by_dtype", {}))) for fn in fns]
    yield
    for fn, (n, by_i, by_d) in zip(fns, saved):
        fn.launches = n
        if by_i:
            fn.launches_by_instance = by_i
        if by_d:
            fn.launches_by_dtype = by_d


@pytest.mark.parametrize("shape,kernel", [
    ((2, 6, 6, 64, 64), "wgmma"), ((2, 5, 7, 20, 12), "mma_sync")])
def test_fp16_wrappers_reach_their_f16_entries(card, counts, shape, kernel):
    """On the card each fp16 conv wrapper calls its ``*_f16`` entry, the
    ``wgmma`` one where ``wgmma_takes`` the shape, the ``mma.sync`` one at
    the ragged C = 20, with the argument count ``_build`` binds, and
    counts one launch under ``fp16_<kernel>`` (the fused step's counts
    name it ``<name>_fp16_<kernel>``, ``<name>_fp16`` their sum);
    ``bn_affine`` calls ``mxt_bn_affine_f16`` and counts under fp16."""
    x, w, dy = _operands(*shape)
    Cout = shape[4]
    v = torch.ones(Cout, dtype=F16)
    entry = {"wgmma": {"conv3x3": "mxt_conv3x3_wgmma_f16",
                       "conv_stats": "mxt_conv_stats_wgmma_f16",
                       "conv_affine": "mxt_conv_affine_wgmma_f16",
                       "conv_wgrad": "mxt_conv_wgrad_wgmma_f16"},
             "mma_sync": {"conv3x3": "mxt_conv3x3_tc_f16",
                          "conv_stats": "mxt_conv_stats_tc_f16",
                          "conv_affine": "mxt_conv_affine_f16",
                          "conv_wgrad": "mxt_conv_wgrad_f16"}}[kernel]
    before = ptrain._counts()
    assert conv_block.conv3x3(x, w).dtype == F16
    assert conv_block.conv_stats(x, w)[0].dtype == F16
    assert conv_block.conv_affine(x, w, v, v, v.float(), v.float()).dtype \
        == F16
    assert conv_block.conv_wgrad(x, dy).dtype == torch.float32
    assert conv_block.bn_affine(dy, v.float(), v.float()).dtype == F16
    called = [c[0] for c in card.calls]
    assert called == [entry[n] for n in ("conv3x3", "conv_stats",
                                         "conv_affine", "conv_wgrad")] + \
        ["mxt_bn_affine_f16"]
    for name, args in card.calls:
        assert len(args) == len(_build._SIGNATURES[name]), name
    assert card.calls[2][1][16] == 4 | 8      # fp32 mean and var
    after = ptrain._counts()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    want = {}
    for n in ("conv3x3", "conv_stats", "conv_affine", "conv_wgrad"):
        want.update({n: 1, f"{n}_fp16": 1, f"{n}_fp16_{kernel}": 1})
    want.update({"bn_affine": 1, "bn_affine_fp16": 1})
    assert moved == want


def test_card_half_names_the_instance_and_refuses_float64():
    """``_card_half`` gives the instance a dtype takes (None for fp32,
    ``bf16``, ``fp16``) and raises ``TypeError`` on float64 and on an
    integer dtype, which no instance takes."""
    assert conv_block._card_half("conv3x3", torch.zeros(1)) is None
    assert conv_block._card_half(
        "conv3x3", torch.zeros(1, dtype=torch.bfloat16)) == "bf16"
    assert conv_block._card_half("conv3x3", torch.zeros(1, dtype=F16)) == \
        "fp16"
    for dt in (torch.float64, torch.int32):
        with pytest.raises(TypeError, match="float16"):
            conv_block._card_half("conv3x3", torch.zeros(1, dtype=dt))


# ------------------------------------- the library convs of an fp16 step
@pytest.mark.parametrize("geom", [
    ((2, 32, 32, 3), (7, 7, 3, 16), 2, 3),      # a ResNet stem
    ((2, 8, 8, 16), (1, 1, 16, 32), 2, 0),      # a downsample
    ((2, 8, 8, 16), (3, 3, 16, 32), 2, 1)], ids=["stem", "1x1s2", "3x3s2"])
def test_cpu_fp16_convolution_rounds_once_as_the_reference(geom):
    """The convs an fp16 ResNet step leaves to the library (the stem, the
    strided and 1x1 ones) on the CPU: the output, dx and dW within one
    fp16 step (or 1e-5 of the largest) of the reference's
    ``ops.nn.convolution`` on fp16, which XLA computes in f32 and rounds
    once; and bit for bit the fp32 conv of the widened operands rounded
    once, forward and backward.  (torch's own CPU fp16 conv rounds inside
    its sums on some builds: on the CUDA build of the card's host, a
    ResNet-18 stem's fp16 weight gradient came 639 fp16 steps from the
    once-rounded value, cuDNN's 2; ``chip_smoke.py
    fp16_train_reference`` compares the card with that CPU.)"""
    from mxnet_tpu.ops import nn as jnn
    from mxnet_tpu_torch.ops import nn as tnn
    xs, ws, stride, pad = geom
    rs = np.random.RandomState(21)
    x = rs.rand(*xs).astype(np.float32)
    w = (rs.randn(*ws) * np.sqrt(2.0 / np.prod(ws[:3]))).astype(np.float32)
    tx, tw = _tt(x).requires_grad_(), _tt(w).requires_grad_()
    out = tnn.convolution(tx, tw, None, stride=stride, pad=pad)
    ref, vjp = jax.vjp(lambda a, b: jnn.convolution(a, b, None, stride=stride,
                                                    pad=pad), _jj(x), _jj(w))
    assert out.dtype == F16
    _within_step(out, ref, "out")
    dy = rs.randn(*out.shape).astype(np.float32)
    rdx, rdw = vjp(_jj(dy))
    dx, dw = torch.autograd.grad(out, (tx, tw), _tt(dy))
    assert dx.dtype == dw.dtype == F16
    _within_step(dx, rdx, "dx")
    _within_step(dw, rdw, "dW")
    fx, fw = _tt(x).float().requires_grad_(), _tt(w).float().requires_grad_()
    once = tnn.convolution(fx, fw, None, stride=stride, pad=pad)
    fdx, fdw = torch.autograd.grad(once, (fx, fw), _tt(dy).float())
    for got, want in ((out, once), (dx, fdx), (dw, fdw)):
        assert torch.equal(got, want.half())
