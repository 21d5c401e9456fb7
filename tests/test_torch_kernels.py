"""Op-level parity of the PyTorch port's kernel modules against the JAX
package: LayerNorm (``mxnet_tpu_torch.ops.cuda_kernels``) and causal
attention (``mxnet_tpu_torch.ops.cuda_attention``).

On the CPU each port wrapper takes its plain version; the JAX reference
runs its Pallas kernels in interpret mode.  The CUDA kernels themselves
are held against their plain versions on the card by ``chip_smoke.py``.
"""
import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import nn as jnn  # noqa: E402
from mxnet_tpu.ops import pallas_attention as jpa  # noqa: E402
from mxnet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mxnet_tpu_torch.ops import cuda_attention, cuda_kernels  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(7, 256), (16, 768)])
def test_layer_norm_matches_pallas_interpret(shape, monkeypatch):
    monkeypatch.setattr(jpk, "_FORCE_INTERPRET", True)
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 3 + 1).astype(np.float32)
    g = rs.randn(shape[-1]).astype(np.float32)
    b = rs.randn(shape[-1]).astype(np.float32)
    ref = np.asarray(jnn.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b)))
    out = tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                         torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def _qkv(shape, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(1, 2, 128, 128), (2, 1, 64, 64)])
def test_causal_attention_matches_pallas_interpret(shape):
    q, k, v = _qkv(shape, 1)
    scale = 1.0 / np.sqrt(shape[-1])
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_kernel = np.asarray(jpa._causal_attention_pallas(jq, jk, jv, scale))
    ref_xla = np.asarray(jpa.causal_attention_xla(jq, jk, jv, scale))
    out = cuda_attention.causal_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), scale).numpy()
    np.testing.assert_allclose(out, ref_kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, ref_xla, atol=2e-5, rtol=2e-5)
    # row 0 attends key 0 only
    np.testing.assert_allclose(out[:, :, 0], v[:, :, 0], atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("lq,lk", [(40, 40), (24, 40)])
def test_causal_attention_ragged_matches_xla(lq, lk):
    rs = np.random.RandomState(2)
    q = rs.randn(2, 3, lq, 64).astype(np.float32)
    k = rs.randn(2, 3, lk, 64).astype(np.float32)
    v = rs.randn(2, 3, lk, 64).astype(np.float32)
    ref = np.asarray(jpa.causal_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125))
    out = cuda_attention.causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        0.125).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_causal_attention_default_scale_and_strided_views():
    """The GPT prefill passes views into its fused per-head [q|k|v]
    projection; the plain version takes them like contiguous tensors."""
    rs = np.random.RandomState(3)
    B, T, H, hd = 2, 16, 2, 64
    t5 = torch.from_numpy(rs.randn(B, T, H, 3, hd).astype(np.float32))
    q, k, v = (t5[:, :, :, i].transpose(1, 2) for i in range(3))
    out = cuda_attention.causal_attention(q, k, v)
    ref = cuda_attention.causal_attention_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), hd ** -0.5)
    assert torch.equal(out, ref)


def test_gelu_is_tanh_approximation():
    import jax
    x = np.linspace(-3, 3, 61).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(tnn.gelu(torch.from_numpy(x)).numpy(), ref,
                               atol=1e-6, rtol=1e-6)


def test_wrappers_refuse_devices_without_a_kernel():
    # meta tensors carry shape/dtype/strides without storage
    x = torch.empty(1, 2, 4, 64, device="meta")
    with pytest.raises(ValueError):
        cuda_kernels.layernorm_fused(x, x[0, 0, 0], x[0, 0, 0])
    with pytest.raises(ValueError):
        cuda_attention.causal_attention(x, x, x)


class _FakeCuda:
    """Stands in for a CUDA tensor in the wrappers' argument checks, which
    run before any launch; the checks must refuse it before the kernel
    library is touched."""

    def __init__(self, t, aligned=True):
        self._t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape
        self._aligned = aligned

    def dim(self):
        return self._t.dim()

    def stride(self, i=None):
        return self._t.stride() if i is None else self._t.stride(i)

    def is_contiguous(self):
        return self._t.is_contiguous()

    def data_ptr(self):
        return 0 if self._aligned else 4

    def numel(self):
        return self._t.numel()


@pytest.mark.parametrize("x,g,b,exc", [
    (torch.zeros(4, 8, dtype=torch.float64), torch.zeros(8),
     torch.zeros(8), TypeError),                               # dtype
    (torch.zeros(4, 8), torch.zeros(7), torch.zeros(8), ValueError),  # gamma
    (torch.zeros(8, 4).t(), torch.zeros(8), torch.zeros(8), ValueError),
])
def test_layernorm_wrapper_refuses(x, g, b, exc, monkeypatch):
    monkeypatch.setattr(cuda_kernels._build, "lib", _no_lib)
    with pytest.raises(exc):
        cuda_kernels.layernorm_fused(_FakeCuda(x), _FakeCuda(g),
                                     _FakeCuda(b))


def _no_lib():
    raise AssertionError("the kernel library must not be reached")


@pytest.mark.parametrize("C", [8192, 30522])
def test_layernorm_wrapper_passes_wide_rows_to_the_kernel(C, monkeypatch):
    """Rows wider than 4096 (beyond a warp's registers) go to the kernel
    like any other: its block-a-row path takes them.  The library is a
    recorder here; the CUDA calls around it are stubbed."""
    calls = []

    class _Lib:
        def mxt_layernorm_f32(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(cuda_kernels._build, "lib", _Lib)
    monkeypatch.setattr(torch, "empty_like",
                        lambda t: _FakeCuda(torch.zeros(t.shape)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=7))
    x, g = torch.zeros(3, C), torch.zeros(C)
    before = cuda_kernels.layernorm_fused.launches
    cuda_kernels.layernorm_fused(_FakeCuda(x), _FakeCuda(g), _FakeCuda(g))
    assert len(calls) == 1 and calls[0][4:6] == (3, C)
    assert cuda_kernels.layernorm_fused.launches == before + 1


@pytest.mark.parametrize("q,k,v,exc", [
    (torch.zeros(1, 2, 8, 64, dtype=torch.float16),
     torch.zeros(1, 2, 8, 64, dtype=torch.float16),
     torch.zeros(1, 2, 8, 64, dtype=torch.float16), TypeError),  # dtype
    (torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32),
     torch.zeros(1, 2, 8, 32), ValueError),                    # head dim
    (torch.zeros(1, 2, 8, 64), torch.zeros(1, 3, 8, 64),
     torch.zeros(1, 3, 8, 64), ValueError),                    # k shape
    (torch.zeros(2, 8, 64), torch.zeros(2, 8, 64),
     torch.zeros(2, 8, 64), ValueError),                       # rank
    (torch.zeros(1, 2, 64, 8).transpose(2, 3), torch.zeros(1, 2, 8, 64),
     torch.zeros(1, 2, 8, 64), ValueError),                    # last stride
])
def test_attention_wrapper_refuses(q, k, v, exc, monkeypatch):
    monkeypatch.setattr(cuda_attention._build, "lib", _no_lib)
    with pytest.raises(exc):
        cuda_attention.causal_attention(_FakeCuda(q), _FakeCuda(k),
                                        _FakeCuda(v))


def test_attention_wrapper_refuses_misaligned_rows(monkeypatch):
    monkeypatch.setattr(cuda_attention._build, "lib", _no_lib)
    t = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        cuda_attention.causal_attention(_FakeCuda(t, aligned=False),
                                        _FakeCuda(t), _FakeCuda(t))


def test_plain_route_counts_no_launches():
    before = (cuda_kernels.layernorm_fused.launches,
              cuda_attention.causal_attention.launches)
    x = torch.zeros(2, 8)
    cuda_kernels.layernorm_fused(x, torch.ones(8), torch.zeros(8))
    t = torch.zeros(1, 1, 4, 64)
    cuda_attention.causal_attention(t, t, t)
    # the plain versions are not kernel launches
    assert (cuda_kernels.layernorm_fused.launches,
            cuda_attention.causal_attention.launches) == before


# ------------------------------------ non-causal flash attention (BERT)

from mxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402


def _bhld(rs, B, H, L, D):
    return rs.randn(B, H, L, D).astype(np.float32)


# D = 64 and 128; L = 40 is not a multiple of the kernels' 64-row tiles
ATTN_SHAPES = [(2, 2, 32, 64), (1, 2, 16, 128), (2, 3, 40, 64)]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_fwd_plain_matches_pallas_interpret(shape):
    q, k, v = _qkv(shape, 4)
    scale = 1.0 / np.sqrt(shape[-1])
    o_ref, lse_ref = jpk._attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v)), scale)
    o, lse = fa.attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                              scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_bwd_plain_matches_pallas_interpret(shape):
    """dq and dk/dv from the same saved o/lse on both sides; Δ =
    rowsum(g ⊙ o) is the plain reduction, as in ``_attn_bwd_pallas``."""
    q, k, v = _qkv(shape, 5)
    g = np.random.RandomState(6).randn(*shape).astype(np.float32)
    scale = 1.0 / np.sqrt(shape[-1])
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = jpk._attention_pallas(jq, jk, jv, scale)
    rdq, rdk, rdv = jpk._attn_bwd_pallas(scale, jq, jk, jv, jg, o, lse)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    to, tlse = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))
    delta = (tg * to).sum(-1)
    dq = fa.attention_dq(tq, tk, tv, tg, tlse, delta, scale)
    dk, dv = fa.attention_dkv(tq, tk, tv, tg, tlse, delta, scale)
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_fused_grads_match_jax_grad_of_reference(shape):
    import jax
    q, k, v = _qkv(shape, 7)
    g = np.random.RandomState(8).randn(*shape).astype(np.float32)
    scale = 1.0 / np.sqrt(shape[-1])

    def loss(q, k, v):
        return jnp.sum(jpk._attention_ref(q, k, v, scale) * jnp.asarray(g))

    refs = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.attention_fused(*ts)                 # default scale
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "_AttentionBackward"
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ts)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jpk._attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                      scale)), atol=1e-5, rtol=1e-5)
    for got, ref in zip(grads, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)


def test_attention_fused_takes_strided_qkv_views():
    """BERT passes (B, H, T, hd) views into one (B, T, 3·D) projection;
    values and gradients equal those of contiguous copies."""
    rs = np.random.RandomState(9)
    B, T, H, hd = 2, 24, 2, 64
    qkv = torch.from_numpy(rs.randn(B, T, 3 * H * hd).astype(np.float32))
    qkv.requires_grad_()
    q, k, v = (t.view(B, T, H, hd).transpose(1, 2)
               for t in qkv.split(H * hd, dim=-1))
    assert q.stride() == (T * 3 * H * hd, hd, 3 * H * hd, 1)
    out = fa.attention_fused(q, k, v)
    (gq,) = torch.autograd.grad(out.square().sum(), qkv)
    c = qkv.detach().clone().requires_grad_()
    q2, k2, v2 = (t.view(B, T, H, hd).transpose(1, 2).contiguous()
                  for t in c.split(H * hd, dim=-1))
    out2 = fa.attention_fused(q2, k2, v2)
    (gq2,) = torch.autograd.grad(out2.square().sum(), c)
    torch.testing.assert_close(out, out2, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(gq, gq2, atol=1e-6, rtol=1e-6)


def test_attention_fused_makes_no_node_without_grad():
    t = torch.zeros(1, 1, 8, 64)
    assert fa.attention_fused(t, t, t).grad_fn is None
    with torch.no_grad():
        r = torch.zeros(1, 1, 8, 64, requires_grad=True)
        assert fa.attention_fused(r, r, r).grad_fn is None


@pytest.mark.parametrize("shape", [(7, 256), (2, 5, 768)])
def test_layer_norm_autograd_matches_ln_bwd(shape):
    rs = np.random.RandomState(10)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rs.randn(shape[-1])).astype(np.float32)
    up = rs.randn(*shape).astype(np.float32)
    out, res = jpk._ln_fwd(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                           1e-5)
    rdx, rdg, rdb = jpk._ln_bwd(1e-5, res, jnp.asarray(up))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    y = tnn.layer_norm(tx, tg, tb)
    assert type(y.grad_fn).__name__ == "LayerNormFnBackward"
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-5)
    dx, dg, db = torch.autograd.grad(y, (tx, tg, tb), torch.from_numpy(up))
    for got, ref in ((dx, rdx), (dg, rdg), (db, rdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)


def test_layer_norm_makes_no_node_without_grad():
    x, g, b = torch.randn(3, 8), torch.ones(8), torch.zeros(8)
    assert tnn.layer_norm(x, g, b).grad_fn is None
    with torch.no_grad():
        assert tnn.layer_norm(x.requires_grad_(), g, b).grad_fn is None


_REFUSALS = [("dtype", TypeError), ("head_dim", ValueError),
             ("k_shape", ValueError), ("last_stride", ValueError),
             ("misaligned", ValueError)]


@pytest.mark.parametrize("which,bad,exc", [
    (w, b, e) for w in ("fwd", "dq", "dkv") for b, e in _REFUSALS] +
    [(w, "lse_shape", ValueError) for w in ("dq", "dkv")])
def test_flash_wrappers_refuse(which, bad, exc, monkeypatch):
    monkeypatch.setattr(fa._build, "lib", _no_lib)
    B, H, L, D = 1, 2, 8, 64
    dt = torch.float16 if bad == "dtype" else torch.float32
    D = 32 if bad == "head_dim" else D
    q = torch.zeros(B, H, L, D, dtype=dt)
    k = torch.zeros(B, 3 if bad == "k_shape" else H, L, D, dtype=dt)
    if bad == "last_stride":
        k = torch.zeros(B, H, D, L, dtype=dt).transpose(2, 3)
    lse = torch.zeros(B, H, L + (bad == "lse_shape"))
    args = [_FakeCuda(q, aligned=bad != "misaligned"), _FakeCuda(k),
            _FakeCuda(q)]
    if which == "fwd":
        call = lambda: fa.attention_fwd(*args, 0.125)  # noqa: E731
    else:
        fn = fa.attention_dq if which == "dq" else fa.attention_dkv
        call = lambda: fn(*args, _FakeCuda(q), _FakeCuda(lse),  # noqa: E731
                          _FakeCuda(lse), 0.125)
    with pytest.raises(exc):
        call()


def test_flash_plain_route_counts_no_launches():
    before = (fa.attention_fwd.launches, fa.attention_dq.launches,
              fa.attention_dkv.launches)
    t = torch.randn(1, 1, 8, 64, requires_grad=True)
    fa.attention_fused(t, t, t).sum().backward()
    assert (fa.attention_fwd.launches, fa.attention_dq.launches,
            fa.attention_dkv.launches) == before


# ------------------------- fused conv3x3 + folded frozen BN (image serving)

from mxnet_tpu.ops import pallas_block as jpb  # noqa: E402
from mxnet_tpu_torch.ops import conv_block  # noqa: E402


def _conv_data(rs, N, H, W, C, Cout, res):
    x = rs.randn(N, H, W, C).astype(np.float32)
    w = (rs.randn(3, 3, C, Cout) * np.sqrt(2.0 / (9 * C))).astype(np.float32)
    gamma = (1 + 0.1 * rs.randn(Cout)).astype(np.float32)
    beta = (0.1 * rs.randn(Cout)).astype(np.float32)
    mean = (0.1 * rs.randn(Cout)).astype(np.float32)
    var = rs.uniform(0.5, 1.5, Cout).astype(np.float32)
    r = rs.randn(N, H, W, Cout).astype(np.float32) if res else None
    return x, w, gamma, beta, mean, var, r


# (N, H, W, C, Cout, residual, relu): with and without the add, ReLU on
# and off, C != Cout, ragged spatial sizes
CONV_CASES = [(1, 8, 8, 16, 16, True, True), (2, 6, 7, 8, 12, False, True),
              (1, 5, 9, 16, 16, True, False), (2, 4, 4, 24, 40, False, False)]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv_affine_plain_matches_pallas_interpret(case, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
    N, H, W, C, Cout, res, relu = case
    monkeypatch.setenv("MXNET_TPU_PALLAS_STAGES", f"{H}x{W}x{C}=pallas")
    data = _conv_data(np.random.RandomState(7), N, H, W, C, Cout, res)
    ref = np.asarray(jpb.residual_block_fused(
        *(None if a is None else jnp.asarray(a) for a in data),
        eps=1e-5, frozen=True, relu=relu)[0])
    out = conv_block.conv_affine(
        *(None if a is None else torch.from_numpy(a) for a in data),
        eps=1e-5, relu=relu).numpy()
    assert out.shape == (N, H, W, Cout)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_residual_block_matches_reference_on_forced_pallas_route(
        monkeypatch):
    """ops.nn.residual_block against the JAX package's, routed to its
    Pallas kernel by the per-stage table."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
    monkeypatch.setenv("MXNET_TPU_PALLAS_STAGES", "6x6x16=pallas")
    x, w, g, b, m, v, r = _conv_data(np.random.RandomState(8), 2, 6, 6, 16,
                                     16, True)
    assert jpb.decide(x.shape, w.shape, jnp.float32, True).fwd == "pallas"
    ref = jnn.residual_block(*(jnp.asarray(a) for a in (x, w, g, b, m, v)),
                             residual=jnp.asarray(r), training=False)
    out = tnn.residual_block(*(torch.from_numpy(a)
                               for a in (x, w, g, b, m, v)),
                             residual=torch.from_numpy(r), training=False)
    ref0 = np.asarray(ref[0])
    assert np.abs(out[0].numpy() - ref0).max() <= 1e-5 * np.abs(ref0).max()
    # the running statistics come back unchanged
    np.testing.assert_array_equal(out[1].numpy(), m)
    np.testing.assert_array_equal(out[2].numpy(), v)


def test_fold_matches_reference():
    rs = np.random.RandomState(9)
    g, b, m = (rs.randn(32).astype(np.float32) for _ in range(3))
    v = rs.uniform(0.5, 1.5, 32).astype(np.float32)
    inv = 1.0 / np.sqrt(jnp.asarray(v) + 1e-5)
    ref = jpb._fold(jnp.asarray(g), jnp.asarray(b), jnp.asarray(m), inv)
    out = conv_block.fold(*(torch.from_numpy(a) for a in (g, b, m, v)))
    for a, e in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-6,
                                   atol=1e-6)


def _conv_args(bad):
    N, H, W, C, Cout = 1, 4, 4, 16, 8
    dt = torch.float64 if bad == "dtype" else torch.float32
    x = torch.zeros(N, H, W, C, dtype=dt)
    if bad == "strided":
        x = torch.zeros(N, C, H, W).permute(0, 2, 3, 1)    # NCHW storage
    if bad == "rank":
        x = torch.zeros(H, W, C)
    kh = 1 if bad == "kernel" else 3
    cin = C + 1 if bad == "channels" else C
    w = torch.zeros(kh, kh, cin, Cout, dtype=dt)
    vec = torch.zeros(Cout + (bad == "vector"), dtype=dt)
    r = torch.zeros(N, H, W, Cout + 1) if bad == "residual" else None
    return x, w, vec, r


@pytest.mark.parametrize("bad,exc", [
    ("dtype", TypeError), ("strided", ValueError), ("rank", ValueError),
    ("kernel", ValueError), ("channels", ValueError), ("vector", ValueError),
    ("residual", ValueError)])
def test_conv_affine_wrapper_refuses(bad, exc, monkeypatch):
    monkeypatch.setattr(conv_block._build, "lib", _no_lib)
    x, w, vec, r = _conv_args(bad)
    fake = [_FakeCuda(t) for t in (x, w, vec, vec, vec, vec)]
    with pytest.raises(exc):
        conv_block.conv_affine(*fake,
                               residual=None if r is None else _FakeCuda(r))


def test_conv_affine_plain_route_counts_no_launches():
    before = conv_block.conv_affine.launches
    x, w, g, b, m, v, r = (None if a is None else torch.from_numpy(a)
                           for a in _conv_data(np.random.RandomState(1),
                                               1, 3, 3, 4, 4, True))
    conv_block.conv_affine(x, w, g, b, m, v, r)
    assert conv_block.conv_affine.launches == before


@pytest.mark.parametrize("bad", ["w", "gamma", "var", "residual"])
def test_conv_affine_wrapper_refuses_a_tensor_on_another_device(
        bad, monkeypatch):
    """x on the card and one argument on the CPU: refused before the
    kernel library is touched."""
    monkeypatch.setattr(conv_block._build, "lib", _no_lib)
    x, w, vec, _ = _conv_args(None)
    r = torch.zeros(tuple(x.shape[:3]) + (w.shape[3],))
    args = dict(x=x, w=w, gamma=vec, beta=vec, mean=vec, var=vec,
                residual=r)
    args = {k: (t if k == bad else _FakeCuda(t)) for k, t in args.items()}
    with pytest.raises(ValueError, match="is on cpu"):
        conv_block.conv_affine(**args)


@pytest.mark.parametrize("shape,vec", [((8, 56, 56, 64, 64), 1),
                                       ((1, 7, 7, 512, 512), 1),
                                       ((2, 13, 17, 22, 40), 0)])
def test_conv_affine_wrapper_passes_its_plan_to_the_kernel(shape, vec,
                                                           monkeypatch):
    """On a (stand-in) card the wrapper asks the affine instance's own
    occupancy entry for its blocks an SM, cuts the work by
    ``conv3x3_splits`` and hands the kernel that plan (bn, ranges), a
    slot buffer of 2·ranges tiles, and the 16-byte path only where C % 4
    == 0 and Cout % 4 == 0; one call counts one launch.  The library is a
    recorder here and the CUDA calls around it are stubbed."""
    N, H, W, C, Cout = shape
    calls, asked, made = [], [], []

    class _Lib:
        def mxt_conv_affine_f32(self, *args):
            calls.append(args)
            return 0

    def empty(size, device=None, dtype=None):
        made.append((tuple(size), dtype))
        return _FakeCuda(torch.zeros(1, dtype=dtype).expand(size))

    monkeypatch.setattr(conv_block._build, "lib", _Lib)
    monkeypatch.setattr(conv_block, "_sm_count", lambda i: 132)
    monkeypatch.setattr(conv_block, "_per_sm",
                        lambda *a: asked.append(a) or 1)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=7))
    vecs = torch.zeros(Cout)
    args = [_FakeCuda(t) for t in (torch.zeros(N, H, W, C),
                                   torch.zeros(3, 3, C, Cout), vecs, vecs,
                                   vecs, vecs, torch.zeros(N, H, W, Cout))]
    before = conv_block.conv_affine.launches
    conv_block.conv_affine(*args, eps=1e-3, relu=False)
    plan = conv_block.conv3x3_splits(N * H * W, 9 * C, Cout, 132, 1)
    assert asked == [("mxt_conv_affine_tc_blocks_per_sm", 0, plan.bn, vec)]
    assert made == [((N, H, W, Cout), torch.float32),
                    ((2 * plan.ranges, 128, plan.bn), torch.float32)]
    assert len(calls) == 1
    assert len(calls[0]) == len(conv_block._build._SIGNATURES[
        "mxt_conv_affine_f32"])
    assert calls[0][9:14] == (N, H, W, C, Cout)
    assert calls[0][14] == pytest.approx(1e-3)
    assert calls[0][15:19] == (0, plan.bn, plan.ranges, vec)
    assert conv_block.conv_affine.launches == before + 1


def test_conv_affine_wrapper_raises_on_a_cuda_tensor_without_a_card(
        monkeypatch):
    """Arguments the kernel takes, on a (stand-in) CUDA device: the
    wrapper goes for the card and raises; it never computes the plain
    version instead, and counts no launch.  A device with no kernel is
    refused."""
    def plain(*a, **k):
        raise AssertionError("the plain version must not be reached")
    monkeypatch.setattr(conv_block, "conv_affine_plain", plain)
    x, w, vec, _ = _conv_args(None)
    fake = [_FakeCuda(t) for t in (x, w, vec, vec, vec, vec)]
    before = conv_block.conv_affine.launches
    with pytest.raises((RuntimeError, AssertionError, TypeError)) as e:
        conv_block.conv_affine(*fake)
    assert "plain version" not in str(e.value)
    assert conv_block.conv_affine.launches == before
    meta = torch.empty(1, 4, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        conv_block.conv_affine(meta, meta, meta, meta, meta, meta)


# ----------------------- training kernels: conv3x3, conv_stats, bn_affine,
# conv_wgrad (their numbers are held against the JAX package in
# test_torch_resnet_train.py; here: what the wrappers refuse)
@pytest.mark.parametrize("fn", ["conv3x3", "conv_stats"])
@pytest.mark.parametrize("bad,exc", [
    ("dtype", TypeError), ("strided", ValueError), ("rank", ValueError),
    ("kernel", ValueError), ("channels", ValueError)])
def test_train_conv_wrappers_refuse(fn, bad, exc, monkeypatch):
    monkeypatch.setattr(conv_block._build, "lib", _no_lib)
    x, w, _, _ = _conv_args(bad)
    with pytest.raises(exc):
        getattr(conv_block, fn)(_FakeCuda(x), _FakeCuda(w))


@pytest.mark.parametrize("x,dy,exc", [
    (torch.zeros(1, 4, 4, 8, dtype=torch.float64),
     torch.zeros(1, 4, 4, 8, dtype=torch.float64), TypeError),
    (torch.zeros(1, 8, 4, 4).permute(0, 2, 3, 1), torch.zeros(1, 4, 4, 8),
     ValueError),                                         # NCHW storage
    (torch.zeros(4, 4, 8), torch.zeros(4, 4, 8), ValueError),    # rank
    (torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 5, 8), ValueError)])
def test_conv_wgrad_wrapper_refuses(x, dy, exc, monkeypatch):
    monkeypatch.setattr(conv_block._build, "lib", _no_lib)
    with pytest.raises(exc):
        conv_block.conv_wgrad(_FakeCuda(x), _FakeCuda(dy))


@pytest.mark.parametrize("z,vec,res,exc", [
    (torch.zeros(2, 3, 8, dtype=torch.float64),
     torch.zeros(8, dtype=torch.float64), None, TypeError),
    (torch.zeros(2, 8, 3).transpose(1, 2), torch.zeros(8), None,
     ValueError),                                          # strided z
    (torch.zeros(2, 3, 8), torch.zeros(7), None, ValueError),     # Cout
    (torch.zeros(2, 3, 8), torch.zeros(8), torch.zeros(2, 3, 7),
     ValueError)])                                         # residual
def test_bn_affine_wrapper_refuses(z, vec, res, exc, monkeypatch):
    monkeypatch.setattr(conv_block._build, "lib", _no_lib)
    with pytest.raises(exc):
        conv_block.bn_affine(_FakeCuda(z), _FakeCuda(vec), _FakeCuda(vec),
                             None if res is None else _FakeCuda(res))


def test_train_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(1, 4, 4, 16, device="meta")
    w = torch.empty(3, 3, 16, 16, device="meta")
    for call in (lambda: conv_block.conv3x3(x, w),
                 lambda: conv_block.conv_stats(x, w),
                 lambda: conv_block.conv_wgrad(x, x),
                 lambda: conv_block.bn_affine(x, x[0, 0, 0], x[0, 0, 0])):
        with pytest.raises(ValueError):
            call()


def test_train_plain_routes_count_no_launches():
    counted = (conv_block.conv3x3, conv_block.conv_stats,
               conv_block.bn_affine, conv_block.conv_wgrad)
    before = [f.launches for f in counted]
    x, w, g, b, m, v, r = (None if a is None else torch.from_numpy(a)
                           for a in _conv_data(np.random.RandomState(2),
                                               2, 3, 4, 4, 6, True))
    x.requires_grad_()
    out, _, _ = conv_block.residual_block_fused(x, w, g, b, m, v, r)
    out.sum().backward()
    conv_block.conv_wgrad(x.detach(), r)
    assert [f.launches for f in counted] == before


@pytest.mark.parametrize("per_sm", [1, 2])
def test_wgrad_splits_fill_the_card_and_cover_every_pixel(per_sm):
    """ResNet-50's four stages at batch 64 on 132 SMs that hold
    ``per_sm`` blocks each: the tiles × 32-pixel chunks of work are cut
    into exactly 132·per_sm ranges (one whole wave) of whole chunks,
    within one chunk of each other in size, that cover every unit once
    (so every pixel of every tile), and no tile is cut between more
    ranges than it has partial slots."""
    tiles = {}
    for H, C in ((56, 64), (28, 128), (14, 256), (7, 512)):
        M = 64 * H * H
        plan = conv_block.wgrad_splits(M, 9 * C, C, 132, per_sm)
        assert plan.bn == conv_block.wgrad_tile_cols(C) == \
            (64 if C == 64 else 128)
        assert plan.ranges == 132 * per_sm
        assert (plan.chunks - 1) * 32 < M <= plan.chunks * 32
        total = plan.tiles * plan.chunks
        # range b's units, and the range holding unit u, as the kernel
        # computes them (csrc/conv_wgrad.cu)
        bounds = [(b * total // plan.ranges, (b + 1) * total // plan.ranges)
                  for b in range(plan.ranges)]

        def range_of(u):
            return ((u + 1) * plan.ranges - 1) // total

        assert bounds[0][0] == 0 and bounds[-1][1] == total
        assert all(bounds[b][1] == bounds[b + 1][0]
                   for b in range(plan.ranges - 1))
        sizes = [hi - lo for lo, hi in bounds]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        for u in range(total):
            lo, hi = bounds[range_of(u)]
            assert lo <= u < hi
        for t in range(plan.tiles):
            first = range_of(t * plan.chunks)
            last = range_of((t + 1) * plan.chunks - 1)
            assert last - first + 1 <= plan.jmax
        tiles[H] = plan.tiles
    assert tiles == {56: 5, 28: 9, 14: 36, 7: 144}
    # fewer units than slots: one range a unit
    assert conv_block.wgrad_splits(100, 72, 8, 132, per_sm) == \
        conv_block.WgradPlan(64, 1, 4, 4, 4)


def _tf32(t, rounding="rna"):
    """Round fp32 ``t`` to TF32 (10 mantissa bits) by integer bit
    operations: ``rna`` to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32`` does; ``rz`` toward zero, as a mask of the low 13
    bits does (the kernel's hi) and as the tensor core reads an fp32
    register (the kernel's lo)."""
    bits = t.contiguous().view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("rounding", ["rna", "rz"])
@pytest.mark.parametrize("N", [1, 2])
@pytest.mark.parametrize("H,C", [(56, 64), (28, 128), (14, 256), (7, 512)])
def test_wgrad_3xtf32_model_is_fp32_accurate_and_1xtf32_is_not(
        N, H, C, rounding):
    """A plain-torch model of ``conv_wgrad``'s arithmetic: each operand
    split into TF32 hi = round(v) and lo = round(v − hi), dW = lo·hi' +
    hi·lo' + hi·hi' (TF32 products are exact in fp32, summed in fp32), with
    round-to-nearest (CUTLASS's split) or toward zero (the kernel's mask
    and the tensor core's read of lo).  At ResNet-50's stage widths it is
    within 1e-5 of the fp64 dW (of its largest magnitude), well inside the
    card's 1e-4 gate, while hi·hi' alone (1×TF32) is over that gate."""
    rs = np.random.RandomState(N * 1000 + C)
    x = torch.from_numpy(rs.randn(N, H, H, C).astype(np.float32))
    dy = torch.from_numpy(rs.randn(N, H, H, C).astype(np.float32))
    ref = conv_block.conv_wgrad_plain(x.double(), dy.double())
    xh, dh = _tf32(x, rounding), _tf32(dy, rounding)
    xl, dl = _tf32(x - xh, rounding), _tf32(dy - dh, rounding)
    assert torch.equal(_tf32(xh, "rz"), xh) and \
        torch.equal(_tf32(xl, "rz"), xl)
    three = (conv_block.conv_wgrad_plain(xl, dh) +
             conv_block.conv_wgrad_plain(xh, dl) +
             conv_block.conv_wgrad_plain(xh, dh))
    one = conv_block.conv_wgrad_plain(xh, dh)
    scale = ref.abs().max().item()
    assert (three.double() - ref).abs().max().item() / scale <= 1e-5
    assert (one.double() - ref).abs().max().item() / scale > 1e-4


def _conv3x3_segments(plan):
    """The segments ``csrc/conv3x3_tc.cu`` runs for ``plan``, as its main
    kernel walks them: (range, tile, first chunk, chunks, slot), slot None
    for a segment that covers its whole tile (written to the output).
    Ranges start on multiples of the plan's ``grain`` where it has one."""
    total, g = plan.tiles * plan.chunks, getattr(plan, "grain", 1)
    for b in range(plan.ranges):
        u0 = b * (total // g) // plan.ranges * g
        u1 = (b + 1) * (total // g) // plan.ranges * g
        u = u0
        while u < u1:
            tile = u // plan.chunks
            c0 = u - tile * plan.chunks
            send = min(u1, (tile + 1) * plan.chunks)
            whole = c0 == 0 and send - u == plan.chunks
            yield (b, tile, c0, send - u,
                   None if whole else 2 * b + (0 if u == u0 else 1))
            u = send


def _conv3x3_reduced(plan):
    """{tile: slots in summing order} as ``conv3x3_reduce_kernel`` picks
    them: the block of range start r takes the tile cut there when no
    earlier range start cut it."""
    total, R = plan.tiles * plan.chunks, plan.ranges
    g = getattr(plan, "grain", 1)

    def range_of(u):
        return ((u // g + 1) * R - 1) // (total // g)

    out = {}
    for r in range(1, R):
        sr = r * (total // g) // R * g
        if sr % plan.chunks == 0:
            continue
        tile = sr // plan.chunks
        t0 = tile * plan.chunks
        if range_of(t0) != r - 1:
            continue
        assert tile not in out
        out[tile] = [2 * q + (0 if q * total // R >= t0 else 1)
                     for q in range(r - 1, range_of(t0 + plan.chunks - 1)
                                    + 1)]
    return out


@pytest.mark.parametrize("per_sm", [1, 2])
def test_conv3x3_splits_fill_the_card_and_cover_every_tile(per_sm):
    """ResNet-50's four 3×3 stages at batch 64 on 132 SMs that hold
    ``per_sm`` blocks each: one full wave of ranges whose segments cover
    every k chunk of every output tile exactly once; each tile is either
    written whole by one segment or cut, and then summed by exactly one
    reduce block from exactly its segments' slots, in chunk order, no slot
    written twice.  7×7×512 (100 tiles of 128 × 128) is no longer under
    one wave."""
    tiles = {}
    for H, C in ((56, 64), (28, 128), (14, 256), (7, 512)):
        M = 64 * H * H
        plan = conv_block.conv3x3_splits(M, 9 * C, C, 132, per_sm)
        assert plan.bn == conv_block.wgrad_tile_cols(C) == \
            (64 if C == 64 else 128)
        assert plan.ranges == 132 * per_sm
        assert plan.chunks == 9 * C // 32
        covered = {}
        whole, cut, slots = set(), {}, set()
        for b, tile, c0, nk, slot in _conv3x3_segments(plan):
            for c in range(c0, c0 + nk):
                assert (tile, c) not in covered
                covered[tile, c] = b
            if slot is None:
                whole.add(tile)
            else:
                assert slot not in slots
                slots.add(slot)
                cut.setdefault(tile, []).append((c0, slot))
        assert len(covered) == plan.tiles * plan.chunks
        assert not whole & set(cut)
        assert whole | set(cut) == set(range(plan.tiles))
        assert _conv3x3_reduced(plan) == \
            {t: [sl for _, sl in sorted(segs)] for t, segs in cut.items()}
        tiles[H] = plan.tiles
    assert tiles == {56: 1568, 28: 392, 14: 196, 7: 100}
    assert conv_block.conv3x3_splits(64 * 49, 9 * 512, 512, 132,
                                     per_sm).ranges > 100
    # fewer units than slots: one range a unit
    assert conv_block.conv3x3_splits(50, 72, 8, 132, per_sm) == \
        conv_block.Conv3x3Plan(64, 1, 3, 3)


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("H,C", [(56, 64), (28, 128), (14, 256), (7, 512)])
def test_conv_stats_writes_every_stats_row_and_column_once(H, C, per_sm):
    """``tile_writers``, the host's view of which kernel writes each
    tile's row of per-tile sums, at ResNet-50's four 3×3 stages at batch
    64 with 1 or 2 blocks an SM: every (row tile, channel) of the
    (ceil(M/128), 2, Cout) partials is written exactly once; the main
    kernel writes exactly the tiles one segment covers whole, from that
    segment's range, and the cut-tile kernel exactly the tiles
    ``conv3x3_reduce_kernel`` sums, from the block of the same range
    start."""
    M = 64 * H * H
    plan = conv_block.conv3x3_splits(M, 9 * C, C, 132, per_sm)
    tiles_n = -(-C // plan.bn)
    count = np.zeros((-(-M // conv_block.CONV_ROWS), C), np.int64)
    writers = conv_block.tile_writers(plan)
    for tile, _, _ in writers:
        rt, ct = divmod(tile, tiles_n)
        count[rt, ct * plan.bn:(ct + 1) * plan.bn] += 1
    assert (count == 1).all()
    whole = {(tile, b) for b, tile, _, _, slot in _conv3x3_segments(plan)
             if slot is None}
    assert {(t, blk) for t, k, blk in writers if k == "main"} == whole
    cut = {t: blk + 1 for t, k, blk in writers if k == "cut"}
    reduced = _conv3x3_reduced(plan)
    assert set(cut) == set(reduced)
    total = plan.tiles * plan.chunks
    for t, r in cut.items():        # found where range r starts
        assert (r * total // plan.ranges) // plan.chunks == t
    if H == 7:
        assert not whole        # 100 tiles in 132 ranges: every one is cut


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("N", [8, 1])
@pytest.mark.parametrize("H,C", [(56, 64), (28, 128), (14, 256), (7, 512)])
def test_conv_affine_plan_finishes_every_tile_once(H, C, N, per_sm):
    """``conv_affine``'s plan (``conv3x3_splits`` at the path's batches,
    8 for serving's largest bucket and 1) and ``tile_writers``: every
    output tile is finished exactly once, by the main kernel when one
    segment covers it whole (from that segment's range) or else by the
    block of ``conv_affine_reduce_kernel`` at the range start that cut
    it, from exactly its segments' slots.  The grid is one full wave at
    every stage (a range a unit where there are fewer units): 7×7×512
    at batch 1 is 4 tiles cut over 132·per_sm ranges, where one block a
    tile left 128 SMs idle."""
    M = N * H * H
    plan = conv_block.conv3x3_splits(M, 9 * C, C, 132, per_sm)
    assert plan.ranges == min(132 * per_sm, plan.tiles * plan.chunks)
    writers = conv_block.tile_writers(plan)
    tiles = [t for t, _, _ in writers]
    assert sorted(tiles) == list(range(plan.tiles))
    whole = {(t, b) for b, t, _, _, slot in _conv3x3_segments(plan)
             if slot is None}
    assert {(t, b) for t, k, b in writers if k == "main"} == whole
    cut = {t: b + 1 for t, k, b in writers if k == "cut"}
    assert set(cut) == set(_conv3x3_reduced(plan))
    total = plan.tiles * plan.chunks
    for t, r in cut.items():
        assert (r * total // plan.ranges) // plan.chunks == t
    if N == 1 and H == 7:
        assert plan.tiles == 4 and len(cut) == 4


def _conv_stats_order(z):
    """Σz and Σz² of ``z`` (M, Cout) fp32 in ``conv_stats``' fixed order:
    a 128-pixel tile's rows wm·32 + mi·16 + hf·8 + g summed by each lane
    over (mi, hf) in turn, then over g by an xor-butterfly, then over the
    4 pixel-warps wm in order; then the ceil(M/128) tile rows of each
    column by 32 threads (thread y its rows y, y + 32, ... in turn) and
    their 32 partials in order."""
    M, C = z.shape
    rows = -(-M // 128)
    t = torch.zeros(rows * 128, C)
    t[:M] = z
    t = t.reshape(rows, 4, 2, 2, 8, C)          # wm, mi, hf, g
    lane1 = lane2 = torch.zeros(rows, 4, 8, C)
    for mi in range(2):
        for hf in range(2):
            a = t[:, :, mi, hf]
            lane1 = lane1 + a
            lane2 = lane2 + a * a
    sums = []
    for lane in (lane1, lane2):
        for step in (1, 2, 4):                  # xor over the bits of g
            lane = lane + lane[:, :, torch.arange(8) ^ step]
        tile = lane[:, 0, 0]
        for wm in range(1, 4):
            tile = tile + lane[:, wm, 0]
        part = torch.zeros(32, C)
        for r in range(rows):
            part[r % 32] = part[r % 32] + tile[r]
        acc = part[0]
        for y in range(1, 32):
            acc = acc + part[y]
        sums.append(acc)
    return sums


@pytest.mark.parametrize("M,C", [(64 * 56 * 56 // 8, 64), (64 * 7 * 7, 512),
                                 (2 * 13 * 17, 40)])
def test_conv_stats_fixed_order_is_fp32_accurate(M, C):
    """The fixed summation order of ``conv_stats`` (per-tile partials,
    then the tile rows in order), modelled in plain fp32 torch, is within
    1e-6 of the fp64 Σz (relative to Σ|z|) and Σz² on conv-like outputs
    (an eighth of the 56² stage's pixels, the 7² stage, a ragged M)."""
    rs = np.random.RandomState(3)
    z = torch.from_numpy((rs.randn(M, C) * rs.uniform(0.2, 3.0, C)
                          + rs.randn(C)).astype(np.float32))
    s1, s2 = _conv_stats_order(z)
    zd = z.double()
    e1 = ((s1.double() - zd.sum(0)).abs() / zd.abs().sum(0)).max().item()
    e2 = ((s2.double() - (zd * zd).sum(0)).abs() /
          (zd * zd).sum(0)).max().item()
    assert e1 <= 1e-6 and e2 <= 1e-6, (e1, e2)


@pytest.mark.parametrize("rounding", ["rna", "rz"])
@pytest.mark.parametrize("use", ["forward", "dgrad"])
@pytest.mark.parametrize("H,C", [(56, 64), (28, 128), (14, 256), (7, 512)])
def test_conv3x3_3xtf32_model_is_fp32_accurate_and_1xtf32_is_not(
        H, C, use, rounding):
    """A plain-torch model of ``conv3x3``'s arithmetic on the tensor cores,
    forward and as the dgrad (the rotated weight): each operand split into
    TF32 hi and lo, out = lo·hi' + hi·lo' + hi·hi' (TF32 products are
    exact in fp32).  At ResNet-50's stage widths, batch 1, it is within
    1e-5 of the fp64 conv (of its largest magnitude), while hi·hi' alone
    (1×TF32) is over the card's 1e-4 gate."""
    rs = np.random.RandomState(C + (use == "dgrad"))
    x = torch.from_numpy(rs.randn(1, H, H, C).astype(np.float32))
    w = torch.from_numpy((rs.randn(3, 3, C, C) *
                          np.sqrt(2.0 / (9 * C))).astype(np.float32))
    if use == "dgrad":
        w = conv_block.rotate(w)
    ref = conv_block.conv3x3_plain(x.double(), w.double())
    xh, wh = _tf32(x, rounding), _tf32(w, rounding)
    xl, wl = _tf32(x - xh, rounding), _tf32(w - wh, rounding)
    three = (conv_block.conv3x3_plain(xl, wh) +
             conv_block.conv3x3_plain(xh, wl) +
             conv_block.conv3x3_plain(xh, wh))
    one = conv_block.conv3x3_plain(xh, wh)
    scale = ref.abs().max().item()
    assert (three.double() - ref).abs().max().item() / scale <= 1e-5
    assert (one.double() - ref).abs().max().item() / scale > 1e-4


def _prod_3xtf32(eq, a, b, rounding):
    """The einsum ``eq`` of fp32 ``a`` and ``b`` from their TF32 hi/lo
    parts, lo·hi' + hi·lo' + hi·hi' (TF32 products are exact in fp32)."""
    ah = _tf32(a, rounding)
    bh = _tf32(b, rounding)
    al, bl = _tf32(a - ah, rounding), _tf32(b - bh, rounding)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) +
            torch.einsum(eq, ah, bh))


def _attn_3xtf32_model(q, k, v, scale, rounding):
    """The causal kernel's arithmetic (``csrc/flash_fwd_tc.cuh`` with the
    mask) in plain torch: q scaled in fp32 then split, S and P·V from
    hi/lo parts, P = exp(S − row max) in fp32 split too, divided by its
    fp32 row sum at the end."""
    Lq, Lk = q.shape[2], k.shape[2]
    s = _prod_3xtf32("bhqd,bhkd->bhqk", q * scale, k, rounding)
    keep = torch.arange(Lk)[None, :] <= torch.arange(Lq)[:, None]
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _prod_3xtf32("bhqk,bhkd->bhqd", p, v, rounding) / \
        p.sum(-1, keepdim=True)


@pytest.mark.parametrize("rounding", ["rna", "rz"])
@pytest.mark.parametrize("L", [512, 77])
@pytest.mark.parametrize("D", [64, 128])
def test_causal_attention_3xtf32_model_is_fp32_accurate(D, L, rounding):
    """The kernel's 3×TF32 arithmetic is within 1e-5 of the output's
    largest magnitude of the fp64 plain version, at both head dims, the
    GPT prefill's 512 rows and a ragged length."""
    rs = np.random.RandomState(D + L)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, L, D).astype(np.float32))
               for _ in range(3))
    scale = D ** -0.5
    ref = cuda_attention.causal_attention_plain(q.double(), k.double(),
                                                v.double(), scale)
    out = _attn_3xtf32_model(q, k, v, scale, rounding)
    err = (out.double() - ref).abs().max().item()
    assert err / ref.abs().max().item() <= 1e-5


def _flash_fwd_3xtf32_model(q, k, v, scale, rounding, bkv=32):
    """``csrc/flash_fwd_tc.cu``'s arithmetic in plain torch: q scaled in
    fp32 then split; K and V streamed 32 keys at a time, padded with zero
    rows whose scores are the finite −1e30; per tile S = Q·Kᵀ and P·V
    from hi/lo parts, the online softmax in fp32 (running max m, sum l,
    acc·corr + P·V); o = acc / l and lse = m + log l at the end."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    pad = -Lk % bkv
    k = torch.cat([k, k.new_zeros(B, H, pad, D)], dim=2)
    v = torch.cat([v, v.new_zeros(B, H, pad, D)], dim=2)
    qs = q * scale
    m = torch.full((B, H, Lq, 1), -float("inf"))
    l = torch.zeros(B, H, Lq, 1)
    acc = torch.zeros(B, H, Lq, D)
    for k0 in range(0, Lk + pad, bkv):
        s = _prod_3xtf32("bhqd,bhkd->bhqk", qs, k[:, :, k0:k0 + bkv],
                         rounding)
        past = torch.arange(k0, k0 + bkv) >= Lk
        s = torch.where(past, torch.full_like(s, -1e30), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _prod_3xtf32("bhqk,bhkd->bhqd", p,
                                        v[:, :, k0:k0 + bkv], rounding)
        m = m_new
    return acc / l, (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("rounding", ["rna", "rz"])
@pytest.mark.parametrize("L", [128, 200])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_fwd_3xtf32_model_is_fp32_accurate(D, L, rounding):
    """The non-causal forward's 3×TF32 arithmetic, online over 32-key
    tiles, is within 1e-5 of the output's largest magnitude (o) and 1e-5
    absolute (lse) of the fp64 plain version, at both head dims, BERT's
    128 rows and a length that is ragged for the key tiles."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    rs = np.random.RandomState(D + L + 1)
    q, k, v = (torch.from_numpy(rs.randn(2, 2, L, D).astype(np.float32))
               for _ in range(3))
    scale = D ** -0.5
    ref, ref_lse = fa.attention_fwd_plain(q.double(), k.double(),
                                          v.double(), scale)
    out, lse = _flash_fwd_3xtf32_model(q, k, v, scale, rounding)
    err = (out.double() - ref).abs().max().item()
    assert err / ref.abs().max().item() <= 1e-5
    assert (lse.double() - ref_lse).abs().max().item() <= 1e-5


def test_build_digest_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a ``csrc/*.cuh`` header changes the build stamp, so the
    library is rebuilt rather than run stale."""
    from mxnet_tpu_torch import _build
    assert any(h.name == "tf32x3.cuh" for h in _build.HEADERS)
    hdr = tmp_path / "tf32x3.cuh"
    hdr.write_text("// one\n")
    monkeypatch.setattr(_build, "HEADERS", (hdr,))
    before = _build._digest()
    hdr.write_text("// two\n")
    assert _build._digest() != before


# ------------------------------------------------ row softmax (Gluon BERT)
SOFTMAX_SHAPES = [(7, 77), (16, 128), (3, 5, 256), (4, 1000), (2, 1030)]


def _logits(rs, shape, masked=False):
    x = (rs.randn(*shape) * 4).astype(np.float32)
    if masked:
        x[..., ::3] = -1e9                  # the model's finite mask value
        x.reshape(-1, shape[-1])[0] = -1e9  # a row masked everywhere
    return x


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", SOFTMAX_SHAPES, ids=str)
def test_softmax_fused_matches_pallas_interpret(shape, masked, monkeypatch):
    monkeypatch.setattr(jpk, "_FORCE_INTERPRET", True)
    x = _logits(np.random.RandomState(11), shape, masked)
    ref = np.asarray(jpk.softmax_fused(jnp.asarray(x)))
    out = cuda_kernels.softmax_fused(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
    if masked:          # the all-masked row is uniform, not NaN
        np.testing.assert_allclose(out.reshape(-1, shape[-1])[0],
                                   1.0 / shape[-1], atol=1e-9)


@pytest.mark.parametrize("temperature", [None, 1.0, 0.5, 3.0])
def test_nn_softmax_temperature_matches_reference(temperature, monkeypatch):
    monkeypatch.setattr(jpk, "_FORCE_INTERPRET", True)
    x = _logits(np.random.RandomState(12), (6, 256))
    ref = np.asarray(jnn.softmax(jnp.asarray(x), axis=-1,
                                 temperature=temperature))
    out = tnn.softmax(torch.from_numpy(x), axis=-1,
                      temperature=temperature).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("axis", [0, 1, -2])
def test_nn_softmax_other_axes_match_reference(axis):
    x = _logits(np.random.RandomState(13), (4, 6, 5))
    ref = np.asarray(jnn.softmax(jnp.asarray(x), axis=axis))
    out = tnn.softmax(torch.from_numpy(x), axis=axis).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(5, 128), (2, 3, 77)], ids=str)
def test_softmax_fn_grad_matches_jax_grad_of_reference(shape, monkeypatch):
    import jax
    monkeypatch.setattr(jpk, "_FORCE_INTERPRET", True)
    rs = np.random.RandomState(14)
    x = _logits(rs, shape)
    g = rs.randn(*shape).astype(np.float32)
    ref = np.asarray(jax.grad(lambda a: jnp.sum(
        jpk.softmax_fused(a) * jnp.asarray(g)))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    y = tnn.softmax(tx)
    assert type(y.grad_fn).__name__ == "SoftmaxFnBackward"
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), ref, atol=1e-5, rtol=0)
    # the closed form against autograd through the plain version
    px = torch.from_numpy(x).requires_grad_()
    cuda_kernels.softmax_plain(px).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), px.grad.numpy(), atol=1e-6,
                               rtol=0)


def test_softmax_makes_no_node_without_grad():
    x = torch.randn(3, 8)
    assert tnn.softmax(x).grad_fn is None
    with torch.no_grad():
        assert tnn.softmax(x.requires_grad_()).grad_fn is None


def test_gelu_exact_matches_reference():
    x = np.linspace(-5, 5, 101).astype(np.float32)
    ref = np.asarray(jnn.gelu(jnp.asarray(x), approximate=False))
    out = tnn.gelu(torch.from_numpy(x), approximate=False).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("x,exc", [
    (torch.zeros(4, 8, dtype=torch.float64), TypeError),       # dtype
    (torch.zeros(4, 8, dtype=torch.bfloat16), TypeError),
    (torch.zeros(()), ValueError),                             # no axis
])
def test_softmax_wrapper_refuses(x, exc, monkeypatch):
    monkeypatch.setattr(cuda_kernels._build, "lib", _no_lib)
    with pytest.raises(exc):
        cuda_kernels.softmax_fused(_FakeCuda(x))


def test_softmax_wrapper_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError):
        cuda_kernels.softmax_fused(torch.empty(2, 8, device="meta"))


def test_softmax_plain_route_counts_no_launches():
    before = cuda_kernels.softmax_fused.launches
    tnn.softmax(torch.randn(2, 3, 8))
    cuda_kernels.softmax_fused(torch.zeros(0, 8))
    assert cuda_kernels.softmax_fused.launches == before


def test_softmax_kernel_is_built_and_bound():
    from mxnet_tpu_torch import _build
    assert any(s.name == "softmax.cu" for s in _build.SOURCES)
    assert len(_build._SIGNATURES["mxt_softmax_f32"]) == 6
