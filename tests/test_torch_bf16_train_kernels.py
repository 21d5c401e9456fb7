"""The bf16 training pieces of the PyTorch port against the JAX package's
on the CPU: the plain versions of the bf16 instances of rows 7, 9, 10 and
11 (``conv3x3`` and its dgrad use, ``conv_stats``, ``bn_affine``,
``conv_wgrad``) against the reference's Pallas kernels in interpret mode
on bf16 operands; the low-precision training BatchNorm (``_BNTrain``)
against the reference's ``batch_norm`` (its ``_bn_train`` custom VJP);
the bf16 ``residual_block_fused`` forward and VJP against the
reference's (``bwd="pallas"``); and the lone bf16 3x3/s1 conv route
against the reference's ``conv3x3_s1``.  On the card the wrappers launch
the kernels, which ``chip_smoke.py bf16_train_kernels`` holds against
these plain versions.

Tolerances.  One bf16 step of a value v is 2^(floor(log2 |v|) - 7).  A
plain version and the reference's kernel sum the same exact bf16
products in fp32 in another order, so a bf16 output may round to the
neighbouring value: one step, or, where the exact value lies near 0 and
the fp32 sums' own rounding is all there is, 1e-5 of the largest output
(as ``chip_smoke.py`` holds the card).  fp32 results (the sums, dW) are
held to 1e-5 of their largest magnitude, fp32 rounding over sums of a
few thousand terms.  The low-precision BatchNorm's output and dx round
where the reference's eager ops round and match bit for bit; its dγ and
dβ are fp32 sums in another order, rounded to their dtype: one step of
it.  The fused block's gradients pass through the dz chain's rounded
means: one bf16 step each; the count of values that differ at all is in
each assertion's message (at these seeds 0-6 of 8-36864 a tensor)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import nn as jnn  # noqa: E402
from mxnet_tpu.ops import pallas_block as jpb  # noqa: E402
from mxnet_tpu.ops import pallas_conv as jpc  # noqa: E402
from mxnet_tpu_torch.ops import conv_block  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402
from mxnet_tpu_torch.ops import pallas_conv  # noqa: E402

torch.set_num_threads(1)

# two stage shapes: (N, H, W, C, Cout)
STAGES = [(2, 12, 12, 64, 64), (2, 6, 6, 128, 128)]
SUM_TOL = 1e-5          # fp32 results: of the largest magnitude
NEAR_ZERO = 1e-5        # a half value near 0: of the largest magnitude
MANTISSA = {"bfloat16": 7, "float16": 10, "float32": 23}


def _step(v, dtype="bfloat16"):
    """One step of ``dtype`` at each |v| (v != 0)."""
    return 2.0 ** (np.floor(np.log2(np.abs(v))) - MANTISSA[dtype])


def _steps_ok(got, ref, dtype, what):
    """Each value within one ``dtype`` step of the reference's, or within
    NEAR_ZERO of the largest magnitude; → how many values differ."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    top = np.abs(ref).max()
    nz = ref != 0
    allowed = np.where(nz, _step(np.where(nz, ref, 1), dtype), 0)
    allowed = np.maximum(allowed, NEAR_ZERO * top)
    err = np.abs(got - ref)
    differ = int((got != ref).sum())
    assert (err <= allowed).all(), (what, err.max(), differ, got.size)
    return differ


def _np(a):
    """A jax or torch array as fp32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _tt(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jj(a, dtype=jnp.bfloat16):
    return jnp.asarray(a, dtype)


def _within_step(got, ref, what):
    return _steps_ok(got, ref, "bfloat16", what)


def _close(got, ref, tol, what):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())


@pytest.fixture
def forced(monkeypatch):
    """The reference's fused block on its Pallas route at the test shapes
    (interpret mode on the CPU)."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
    monkeypatch.setenv("MXNET_TPU_PALLAS_STAGES", ",".join(
        f"{H}x{W}x{C}=pallas" for _, H, W, C, _ in STAGES))


def _data(shape, seed):
    N, H, W, C, Cout = shape
    rs = np.random.RandomState(seed)
    x = rs.randn(N, H, W, C).astype(np.float32)
    w = (rs.randn(3, 3, C, Cout) * np.sqrt(2.0 / (9 * C))).astype(np.float32)
    dy = rs.randn(N, H, W, Cout).astype(np.float32)
    return x, w, dy


# ------------------------------------------------- the kernels' plain
@pytest.mark.parametrize("shape", STAGES, ids=str)
def test_conv3x3_and_dgrad_plain_bf16_match_reference(shape):
    """Row 7's bf16 instance: the forward conv and the dgrad (the conv of
    dy with the rotated weight, cast to dy's dtype) within one bf16 step
    of the reference's Pallas conv on bf16 operands."""
    x, w, dy = _data(shape, 1)
    out = conv_block.conv3x3(_tt(x), _tt(w))
    assert out.dtype == torch.bfloat16
    _within_step(out, jpb.conv3x3(_jj(x), _jj(w)), "conv3x3")
    dx = conv_block.conv3x3_dgrad(_tt(w), _tt(dy))
    assert dx.dtype == torch.bfloat16
    _within_step(dx, jpb.conv3x3_dgrad(_jj(w), _jj(dy)), "dgrad")


@pytest.mark.parametrize("shape", STAGES, ids=str)
def test_conv_stats_plain_bf16_matches_reference(shape):
    """Row 9's bf16 instance: z in bf16 within one step, Σz and Σz² (fp32,
    summed before z is rounded) within 1e-5 of their largest."""
    x, w, _ = _data(shape, 2)
    z, s1, s2 = conv_block.conv_stats(_tt(x), _tt(w))
    rz, r1, r2 = jpb._conv_stats(_jj(x), _jj(w))
    assert z.dtype == torch.bfloat16 and s1.dtype == torch.float32
    _within_step(z, rz, "z")
    _close(s1, r1, SUM_TOL, "sum z")
    _close(s2, r2, SUM_TOL, "sum z^2")


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", STAGES, ids=str)
def test_bn_affine_plain_bf16_matches_reference(shape, residual, relu):
    """Row 10's bf16 instance: bf16 z and residual, fp32 scale and shift,
    the arithmetic in fp32, one rounding: within one bf16 step of the
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
    assert out.dtype == torch.bfloat16
    _within_step(out, ref, "bn_affine")


@pytest.mark.parametrize("shape", STAGES, ids=str)
def test_conv_wgrad_plain_bf16_matches_reference(shape):
    """Row 11's bf16 instance: dW fp32 from bf16 x and dy within 1e-5 of
    its largest magnitude of the reference's Pallas wgrad."""
    x, _, dy = _data(shape, 4)
    dw = conv_block.conv_wgrad(_tt(x), _tt(dy))
    assert dw.dtype == torch.float32
    _close(dw, jpb.conv3x3_wgrad(_jj(x), _jj(dy)), SUM_TOL, "dW")


# --------------------------------------------- low-precision BatchNorm
def _bn_pair(dtype, axis, gamma_f32, seed=5):
    rs = np.random.RandomState(seed)
    shape = (4, 5, 6, 8) if axis == -1 else (4, 8, 5, 6)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    C = shape[axis]
    g = (1 + 0.2 * rs.randn(C)).astype(np.float32)
    b = (0.1 * rs.randn(C)).astype(np.float32)
    rm = (0.1 * rs.randn(C)).astype(np.float32)
    rv = rs.uniform(0.5, 1.5, C).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    return x, g, b, rm, rv, dy


@pytest.mark.parametrize("gamma_f32", [False, True],
                         ids=["gamma_low", "gamma_f32"])
@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_bn_train_low_precision_matches_reference(dtype, axis, gamma_f32):
    """``batch_norm`` in training on bf16 and fp16 ``x`` (NHWC and
    ``axis=1``; γ and β in x's dtype, or fp32 as ``amp`` leaves them)
    against the reference's ``_bn_train`` under ``jax.vjp``: the output
    and dx bit for bit (they round where the reference's eager ops
    round), the running averages within 1e-6 of their largest (their
    batch statistics are fp32 sums in another order), dγ and dβ within
    one step of their dtype."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, g, b, rm, rv, dy = _bn_pair(dtype, axis, gamma_f32)
    gdt_j = jnp.float32 if gamma_f32 else jdt
    gdt_t = torch.float32 if gamma_f32 else tdt

    def ref_fn(x_, g_, b_):
        return jnn.batch_norm(x_, g_, b_, jnp.asarray(rm), jnp.asarray(rv),
                              training=True, axis=axis)
    (rout, rmean, rvar), vjp = jax.vjp(ref_fn, _jj(x, jdt), _jj(g, gdt_j),
                                       _jj(b, gdt_j))
    tx = _tt(x, tdt).requires_grad_()
    tg = _tt(g, gdt_t).requires_grad_()
    tb = _tt(b, gdt_t).requires_grad_()
    out, mean, var = tnn.batch_norm(tx, tg, tb, torch.from_numpy(rm),
                                    torch.from_numpy(rv), training=True,
                                    axis=axis)
    assert out.dtype == (torch.float32 if gamma_f32 else tdt)
    assert str(rout.dtype) == str(out.dtype).rpartition(".")[2]
    _close(mean, rmean, 1e-6, "new running mean")
    _close(var, rvar, 1e-6, "new running var")
    cot = dy.astype(np.float32)
    rdx, rdg, rdb = vjp((jnp.asarray(cot, rout.dtype),
                         jnp.zeros_like(rmean), jnp.zeros_like(rvar)))
    dx, dg, db = torch.autograd.grad(
        out, (tx, tg, tb), torch.from_numpy(cot).to(out.dtype))
    assert dx.dtype == tdt and dg.dtype == gdt_t
    np.testing.assert_array_equal(_np(out), _np(rout))
    np.testing.assert_array_equal(_np(dx), _np(rdx))
    odt = "float32" if gamma_f32 else dtype
    _steps_ok(dg, rdg, odt, "dgamma")
    _steps_ok(db, rdb, odt, "dbeta")


# -------------------------------------------------- the fused block
@pytest.mark.parametrize("frozen", [False, True], ids=["train", "frozen"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "residual"])
def test_residual_block_fused_bf16_forward_and_vjp(forced, frozen,
                                                   residual):
    """``residual_block_fused`` on bf16 x, w, γ, β (and residual; the
    statistics fp32 in training, bf16 when frozen, as a cast net holds
    them) against the reference's with ``bwd="pallas"`` under
    ``jax.vjp``: the output within one bf16 step; the batch statistics
    (training) within 1e-5; dx, dw, dγ, dβ and the residual's gradient
    within one bf16 step (they pass through the dz chain's rounded
    means, which the fp32 sums' order can move by a step)."""
    N, H, W, C, Cout = STAGES[0]
    rs = np.random.RandomState(11)
    x, w, dy = _data(STAGES[0], 12)
    g = (1 + 0.1 * rs.randn(Cout)).astype(np.float32)
    b = (0.1 * rs.randn(Cout)).astype(np.float32)
    mu = (0.1 * rs.randn(Cout)).astype(np.float32)
    var = rs.uniform(0.5, 1.5, Cout).astype(np.float32)
    res = rs.randn(N, H, W, Cout).astype(np.float32) if residual else None
    sdt_j = jnp.bfloat16 if frozen else jnp.float32
    sdt_t = torch.bfloat16 if frozen else torch.float32

    def ref_fn(x_, w_, g_, b_, r_):
        return jpb.residual_block_fused(
            x_, w_, g_, b_, _jj(mu, sdt_j), _jj(var, sdt_j), r_, eps=1e-5,
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
        *tt, _tt(mu, sdt_t), _tt(var, sdt_t), tres, eps=1e-5,
        frozen=frozen, relu=True)
    assert out.dtype == torch.bfloat16
    _within_step(out, rout, "out")
    if not frozen:
        _close(tm, rm, SUM_TOL, "batch mean")
        _close(tv, rv, SUM_TOL, "batch var")
    cts = vjp((jnp.asarray(dy, jnp.bfloat16), jnp.zeros_like(rm),
               jnp.zeros_like(rv)))
    wrt = tt + ([tres] if tres is not None else [])
    grads = torch.autograd.grad(out, wrt, _tt(dy))
    names = ["dx", "dw", "dgamma", "dbeta", "dres"]
    for what, got, ref in zip(names, grads, cts):
        assert got.dtype == torch.bfloat16, what
        _steps_ok(got, ref, "bfloat16", what)


# ---------------------------------------------- the lone bf16 conv route
def test_lone_bf16_conv_routes_to_kernels_and_matches_reference(
        monkeypatch):
    """``ops.nn.convolution`` sends a bf16 3x3/s1 conv to ``Conv3x3Fn``
    (``eligible`` admits bf16 as the reference's does), whose forward and
    gradients match the reference's ``conv3x3_s1`` on bf16 operands: the
    output, dx and dW (fp32 sums cast to bf16) within one bf16 step."""
    assert pallas_conv.eligible((2, 8, 8, 16), (3, 3, 16, 24), 1, 1, 1, 1,
                                torch.bfloat16)
    # fp16 since the fp16 training slice; float64 stays with cuDNN
    assert pallas_conv.eligible((2, 8, 8, 16), (3, 3, 16, 24), 1, 1, 1, 1,
                                torch.float16)
    assert not pallas_conv.eligible((2, 8, 8, 16), (3, 3, 16, 24), 1, 1, 1,
                                    1, torch.float64)
    calls = []
    real = pallas_conv.conv3x3_s1
    monkeypatch.setattr(pallas_conv, "conv3x3_s1",
                        lambda x, w: calls.append(x.dtype) or real(x, w))
    x, w, dy = _data((2, 8, 8, 16, 24), 21)
    tx, tw = _tt(x).requires_grad_(), _tt(w).requires_grad_()
    out = tnn.convolution(tx, tw, None, stride=1, pad=1)
    assert calls == [torch.bfloat16] and out.dtype == torch.bfloat16
    ref, vjp = jax.vjp(jpc.conv3x3_s1, _jj(x), _jj(w))
    _within_step(out, ref, "conv3x3_s1")
    rdx, rdw = vjp(_jj(dy))
    dx, dw = torch.autograd.grad(out, (tx, tw), _tt(dy))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16
    _within_step(dw, rdw, "dW")
    _within_step(dx, rdx, "dx")
