"""The port's transformer attention ops (``mxnet_tpu_torch/ops/attention.py``)
and masked softmax pair (``ops/nn.py masked_softmax``,
``masked_log_softmax``) against the JAX package's on the CPU, from the
same ``RandomState`` inputs: forwards, and gradients (``jax.vjp`` against
``torch.autograd`` with one numpy cotangent).

Tolerances.  fp32 within 1e-5 of the tensor's largest magnitude: the
products and the gathers' scatter-add sum in another order.  bf16 and
fp16 within one step of the dtype at the larger of the two values
(``np.spacing`` in the dtype): the products accumulate in fp32 on both
sides and round once, in another order.  Infinite values (fp16's causal
-1e30) must sit at the same positions with the same sign.
``sldwin_atten_mask_like`` is bit for bit: it is integer arithmetic."""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import attention as jatt  # noqa: E402
from mxnet_tpu.ops import nn as jnn  # noqa: E402
from mxnet_tpu_torch.ops import attention as tatt  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
HALF = {"bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
        "float16": (torch.float16, np.float16)}
L, B, HEADS, D = 5, 2, 3, 6          # √6 rounds differently in each dtype


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.asarray(a)).to(dtype).requires_grad_(grad)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _within_one_step(got, want, npdt, what):
    """Half-dtype arrays (as float32) within one step of ``npdt``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf, err_msg=what)
    np.testing.assert_array_equal(got[inf], want[inf], err_msg=what)
    g, w = got[~inf], want[~inf]
    m = np.maximum(np.abs(g), np.abs(w)).astype(npdt)
    with np.errstate(over="ignore"):
        up = np.spacing(m).astype(np.float32)
    # the dtype's largest finite value has no step above: the one below
    down = (m - np.nextafter(m, np.zeros_like(m))).astype(np.float32)
    step = np.where(np.isfinite(up), up, down)
    bad = np.abs(g - w) > step
    assert not bad.any(), (what, g[bad][:5], w[bad][:5])


def _vjp_pair(jfn, tfn, inputs, diff, rs):
    """Forward and gradients of the differentiable inputs (positions
    ``diff``) on both sides, one cotangent from ``rs``."""
    jin = [jnp.asarray(a) for a in inputs]

    def jf(*d):
        args = list(jin)
        for i, v in zip(diff, d):
            args[i] = v
        return jfn(*args)

    jout, pull = jax.vjp(jf, *[jin[i] for i in diff])
    cot = rs.randn(*jout.shape).astype(np.float32)
    jgrads = pull(jnp.asarray(cot))
    tin = [_t(a, grad=i in diff) if np.asarray(a).dtype == np.float32
           else torch.from_numpy(np.asarray(a)) for i, a in enumerate(inputs)]
    tout = tfn(*tin)
    tout.backward(torch.from_numpy(cot))
    _close(tout.detach().numpy(), jout, "forward")
    for i, jg in zip(diff, jgrads):
        _close(tin[i].grad.numpy(), jg, f"gradient of input {i}")


def _qkv(rs, parts=3, n=L):
    return rs.randn(n, B, HEADS * parts * D).astype(np.float32)


# ------------------------------------------------------------ interleaved
@pytest.mark.parametrize("causal", [False, True])
def test_selfatt_qk_and_valatt(causal):
    rs = np.random.RandomState(0)
    qkv = _qkv(rs)
    _vjp_pair(lambda x: jatt.interleaved_matmul_selfatt_qk(x, HEADS, causal),
              lambda x: tatt.interleaved_matmul_selfatt_qk(x, HEADS, causal),
              [qkv], [0], rs)
    att = rs.rand(B * HEADS, L, L).astype(np.float32)
    _vjp_pair(lambda x, a: jatt.interleaved_matmul_selfatt_valatt(
                  x, a, HEADS),
              lambda x, a: tatt.interleaved_matmul_selfatt_valatt(
                  x, a, HEADS), [qkv, att], [0, 1], rs)


def test_encdec_qk_and_valatt():
    rs = np.random.RandomState(1)
    q = rs.randn(L - 2, B, HEADS * D).astype(np.float32)
    kv = _qkv(rs, parts=2)
    _vjp_pair(lambda a, b: jatt.interleaved_matmul_encdec_qk(a, b, HEADS),
              lambda a, b: tatt.interleaved_matmul_encdec_qk(a, b, HEADS),
              [q, kv], [0, 1], rs)
    att = rs.rand(B * HEADS, L - 2, L).astype(np.float32)
    _vjp_pair(lambda a, b: jatt.interleaved_matmul_encdec_valatt(
                  a, b, HEADS),
              lambda a, b: tatt.interleaved_matmul_encdec_valatt(
                  a, b, HEADS), [kv, att], [0, 1], rs)


@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("causal", [False, True])
def test_interleaved_half(half, causal):
    """The four ops in bf16 and fp16: q divided by √D rounded to the
    dtype, the causal mask -1e30 cast to it (-inf in fp16, at the
    reference's positions)."""
    tdt, npdt = HALF[half]
    rs = np.random.RandomState(2)
    qkv = (3 * _qkv(rs)).astype(npdt)
    att = rs.rand(B * HEADS, L, L).astype(npdt)
    q = rs.randn(L, B, HEADS * D).astype(npdt)
    kv = _qkv(rs, parts=2).astype(npdt)
    tq = lambda a: torch.from_numpy(a.astype(np.float32)).to(tdt)  # noqa
    pairs = [
        (jatt.interleaved_matmul_selfatt_qk(jnp.asarray(qkv), HEADS, causal),
         tatt.interleaved_matmul_selfatt_qk(tq(qkv), HEADS, causal)),
        (jatt.interleaved_matmul_selfatt_valatt(jnp.asarray(qkv),
                                                jnp.asarray(att), HEADS),
         tatt.interleaved_matmul_selfatt_valatt(tq(qkv), tq(att), HEADS)),
        (jatt.interleaved_matmul_encdec_qk(jnp.asarray(q), jnp.asarray(kv),
                                           HEADS),
         tatt.interleaved_matmul_encdec_qk(tq(q), tq(kv), HEADS)),
        (jatt.interleaved_matmul_encdec_valatt(jnp.asarray(kv),
                                               jnp.asarray(att), HEADS),
         tatt.interleaved_matmul_encdec_valatt(tq(kv), tq(att), HEADS)),
    ]
    for n, (want, got) in enumerate(pairs):
        assert got.dtype == tdt and want.dtype == npdt
        _within_one_step(got.float().numpy(), np.asarray(want, np.float32),
                         npdt, f"op {n}")
    s = pairs[0][1].float().numpy()
    upper = np.triu(np.ones((L, L), bool), 1)
    if causal:
        masked = s[:, upper]
        want = np.asarray(pairs[0][0], np.float32)[:, upper]
        np.testing.assert_array_equal(masked, want)
        if half == "float16":
            assert np.isneginf(masked).all()
        else:
            assert np.isfinite(masked).all() and (masked < -1e29).all()
    assert np.isfinite(s[:, ~upper]).all()


def test_scale_is_rounded_in_the_dtype():
    """√96 is 9.8125 in bf16, not fp32's 9.797959: with k one-hot the
    scores are q₀ / 9.8125 rounded to bf16, bit for bit as the
    reference's, and for some q₀ not the quotient by fp32's root."""
    n, d = 64, 96
    rs = np.random.RandomState(7)
    x = np.zeros((n, 1, 3 * d), np.float32)
    x[:, 0, 0] = rs.uniform(1, 2, n)            # q₀ of each position
    x[:, 0, d] = 1.0                            # k = e₀
    xb = torch.from_numpy(x).to(torch.bfloat16)
    s = tatt.interleaved_matmul_selfatt_qk(xb, 1)[0, :, 0].float()
    q0 = xb[:, 0, 0].float()
    assert torch.equal(s, (q0 / 9.8125).to(torch.bfloat16).float())
    assert not torch.equal(s, (q0 / np.sqrt(96.0)).to(torch.bfloat16)
                           .float())
    ref = jatt.interleaved_matmul_selfatt_qk(
        jnp.asarray(x.astype(ml_dtypes.bfloat16)), 1)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(ref, np.float32)[0, :, 0])


# -------------------------------------------------------- sliding window
SL, SH, SD, SW = 12, 3, 4, 3
DIL = np.array([1, 2, 3], np.int32)


@pytest.mark.parametrize("symmetric", [True, False])
def test_sldwin_score_and_context(symmetric):
    rs = np.random.RandomState(3)
    q = rs.randn(B, SL, SH, SD).astype(np.float32)
    k = rs.randn(B, SL, SH, SD).astype(np.float32)
    _vjp_pair(lambda a, b: jatt.sldwin_atten_score(a, b, DIL, SW, symmetric),
              lambda a, b: tatt.sldwin_atten_score(a, b, DIL, SW, symmetric),
              [q, k], [0, 1], rs)
    w_len = 2 * SW + 1 if symmetric else SW + 1
    s = rs.randn(B, SL, SH, w_len).astype(np.float32)
    v = rs.randn(B, SL, SH, SD).astype(np.float32)
    _vjp_pair(lambda a, b: jatt.sldwin_atten_context(a, b, DIL, SW,
                                                     symmetric),
              lambda a, b: tatt.sldwin_atten_context(a, b, DIL, SW,
                                                     symmetric),
              [s, v], [0, 1], rs)


def test_sldwin_out_of_range_keys_score_zero():
    """A window slot before the sequence start scores 0 and takes no
    gradient, though its key was gathered clipped to row 0."""
    q = torch.ones(1, SL, 1, SD, requires_grad=True)
    k = torch.ones(1, SL, 1, SD, requires_grad=True)
    s = tatt.sldwin_atten_score(q, k, [1], SW)
    assert (s[0, 0, 0, :SW] == 0).all() and (s[0, 0, 0, SW:] == SD).all()
    s.sum().backward()
    # key row 0 is a real key of queries 0..SW only
    assert k.grad[0, 0, 0, 0].item() == SW + 1


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("valid", [(2, SL), (SL, 7), (1, 5)])
def test_sldwin_mask_like_bitwise(symmetric, valid):
    """valid_length below w (1, 2), equal to L, and between."""
    w = 4
    w_len = 2 * w + 1 if symmetric else w + 1
    score = np.zeros((B, SL, SH, w_len), np.float32)
    vl = np.array(valid, np.int32)
    want = np.asarray(jatt.sldwin_atten_mask_like(jnp.asarray(score), DIL,
                                                  vl, w, symmetric))
    got = tatt.sldwin_atten_mask_like(torch.from_numpy(score), DIL, vl, w,
                                      symmetric)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for half, (tdt, npdt) in HALF.items():
        g = tatt.sldwin_atten_mask_like(torch.zeros(score.shape, dtype=tdt),
                                        DIL, vl, w, symmetric)
        assert g.dtype == tdt
        np.testing.assert_array_equal(g.float().numpy(), want)


# ------------------------------------------------------ masked softmax
def _masked_inputs(rs):
    x = (3 * rs.randn(3, 4, 7)).astype(np.float32)
    mask = rs.rand(3, 1, 7) > 0.4
    mask[1] = False                     # fully masked rows
    mask[2, 0, 0] = True
    return x, mask


@pytest.mark.parametrize("axis,temperature", [(-1, 1.0), (-1, 2.5),
                                              (1, 0.5)])
def test_masked_softmax_matches_reference(axis, temperature):
    rs = np.random.RandomState(4)
    x, mask = _masked_inputs(rs)
    if axis == 1:
        mask = np.broadcast_to(mask.transpose(0, 2, 1)[:, :4], (3, 4, 7))
    _vjp_pair(lambda a: jnn.masked_softmax(a, jnp.asarray(mask), axis=axis,
                                           temperature=temperature),
              lambda a: tnn.masked_softmax(a, torch.from_numpy(mask.copy()),
                                           axis=axis,
                                           temperature=temperature),
              [x], [0], rs)
    got = tnn.masked_softmax(_t(x), torch.from_numpy(mask.copy()), axis=axis)
    assert (got[~torch.from_numpy(np.broadcast_to(mask, x.shape).copy())]
            == 0).all()
    if axis == -1:
        assert (got[1] == 0).all()


@pytest.mark.parametrize("axis", [-1, 1])
def test_masked_log_softmax_matches_reference(axis):
    rs = np.random.RandomState(5)
    x, mask = _masked_inputs(rs)
    _vjp_pair(lambda a: jnn.masked_log_softmax(a, jnp.asarray(mask),
                                               axis=axis),
              lambda a: tnn.masked_log_softmax(
                  a, torch.from_numpy(mask.copy()), axis=axis),
              [x], [0], rs)
    got = tnn.masked_log_softmax(_t(x), torch.from_numpy(mask.copy()))
    # a fully masked row is -log(n), not zeroed
    np.testing.assert_allclose(got[1].numpy(), -np.log(7), rtol=1e-6)


@pytest.mark.parametrize("half", sorted(HALF))
def test_masked_pair_half(half):
    tdt, npdt = HALF[half]
    rs = np.random.RandomState(6)
    x, mask = _masked_inputs(rs)
    xh = x.astype(npdt)
    tx = torch.from_numpy(xh.astype(np.float32)).to(tdt)
    tm = torch.from_numpy(mask.copy())
    for jfn, tfn, kw in ((jnn.masked_softmax, tnn.masked_softmax, {}),
                         (jnn.masked_softmax, tnn.masked_softmax,
                          {"temperature": 2.0}),
                         (jnn.masked_log_softmax, tnn.masked_log_softmax,
                          {})):
        want = jfn(jnp.asarray(xh), jnp.asarray(mask), axis=-1, **kw)
        got = tfn(tx, tm, axis=-1, **kw)
        assert got.dtype == tdt
        _within_one_step(got.float().numpy(), np.asarray(want, np.float32),
                         npdt, f"{tfn.__name__} {kw}")


def test_masked_softmax_takes_a_numeric_mask():
    """A 0/1 integer mask keeps its non-zero entries, as ``jnp.where``
    reads it."""
    x = torch.randn(2, 5)
    m = torch.tensor([[1, 0, 2, 0, 1], [0, 0, 0, 0, 3]])
    np.testing.assert_array_equal(tnn.masked_softmax(x, m).numpy(),
                                  tnn.masked_softmax(x, m != 0).numpy())
