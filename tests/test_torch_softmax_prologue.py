"""The softmax kernel's prologue, ``softmax_fused(x, div=, keep=)``: the
attention's ``softmax(where(keep, x / div, -1e9))`` in one call, against
the JAX package on the CPU (its Pallas softmax in interpret mode, fed the
reference's own division and ``jnp.where``), at the Gluon BERT's shapes
with a head dim whose square root is a power of two (64) and one whose
is not (48), at widths that take each of the card's kernels, and through
the Gluon BERT: its inference forward calls the prologue once a layer
and its logits match the reference's; a recording forward keeps the
divide, ``torch.where`` and ``SoftmaxFn`` composition and its gradients
match the reference's.  The wrapper's refusals and what it hands the
kernel are held with a stand-in for a CUDA tensor."""
import contextlib
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.models import bert_gluon as jbert  # noqa: E402
from mxnet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mxnet_tpu_torch.models import bert_gluon as tbert  # noqa: E402
from mxnet_tpu_torch.ops import cuda_kernels  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402

from test_torch_bert_gluon import (_close, _port, _ref,  # noqa: E402
                                   _tokens, bert_weights)
from test_torch_kernels import _FakeCuda, _no_lib  # noqa: E402

torch.set_num_threads(1)

SOFTMAX_TOL = 1e-6      # absolute: every softmax value lies in [0, 1]
GRAD_TOL = 1e-4         # of the parameter's largest gradient magnitude


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The reference's Pallas softmax and LayerNorm run in interpret
    mode (they would fall back to jnp on a host without a TPU)."""
    monkeypatch.setattr(jpk, "_FORCE_INTERPRET", True)


def _reference(x, div, keep):
    """``pallas_kernels.softmax_fused(jnp.where(keep, x / div, -1e9))``,
    ``keep`` (M, cols) broadcast over runs of x's rows."""
    s = jnp.asarray(x)
    if div is not None:
        s = s / div
    if keep is not None:
        m, cols = keep.shape
        s = jnp.where(jnp.asarray(keep).reshape(m, 1, cols),
                      s.reshape(m, -1, cols), -1e9).reshape(x.shape)
    return np.asarray(jpk.softmax_fused(s))


def _check(out, ref, x_shape):
    np.testing.assert_allclose(out, ref, atol=SOFTMAX_TOL, rtol=0)
    assert out.shape == x_shape and np.isfinite(out).all()
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


# ------------------------------------------------------ against the kernel
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hd", [64, 48])
def test_prologue_matches_pallas_on_attention_scores(hd, masked):
    """(B, H, T, T) raw scores q·kᵀ, divided by √hd (8, or √48, which is
    not a power of two) and masked by a (B, T) key mask whose second
    sequence is masked everywhere (its rows must come out 1/T)."""
    B, H, T = 3, 2, 24
    rs = np.random.RandomState(hd)
    x = (rs.randn(B, H, T, T) * 3 * math.sqrt(hd)).astype(np.float32)
    keep = None
    if masked:
        keep = rs.rand(B, T) > 0.3
        keep[1] = False
    out = cuda_kernels.softmax_fused(
        torch.from_numpy(x), div=math.sqrt(hd),
        keep=None if keep is None else torch.from_numpy(keep)).numpy()
    _check(out, _reference(x, math.sqrt(hd), keep), x.shape)
    if masked:
        np.testing.assert_allclose(out[1], 1.0 / T, atol=1e-9)


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("cols", [77, 1000, 1030, 4099, 30522])
def test_widths_of_every_kernel_route_match_pallas(cols, prologue):
    """Widths the card sends to each of its kernels: a warp a row,
    scalar (77) and 16-byte (1000); a cluster a row, 1030, 4099 (scalar)
    and 30522 (four CTAs).  With the prologue: √48 and a uint8 keep mask
    of two rows, each shared by two rows of x."""
    rs = np.random.RandomState(cols)
    x = (rs.randn(4, cols) * 4).astype(np.float32)
    div = keep = None
    if prologue:
        div = math.sqrt(48)
        keep = (rs.rand(2, cols) > 0.25).astype(np.uint8)
    out = cuda_kernels.softmax_fused(
        torch.from_numpy(x), div=div,
        keep=None if keep is None else torch.from_numpy(keep)).numpy()
    _check(out, _reference(x, div, None if keep is None else keep != 0),
           x.shape)


def test_divisor_alone_and_unit_divisor():
    """A divisor without a mask is the reference's division; div = 1 is
    the plain softmax bit for bit."""
    x = (np.random.RandomState(5).randn(6, 128) * 20).astype(np.float32)
    tx = torch.from_numpy(x)
    _check(cuda_kernels.softmax_fused(tx, div=math.sqrt(48)).numpy(),
           _reference(x, math.sqrt(48), None), x.shape)
    assert torch.equal(cuda_kernels.softmax_fused(tx, div=1.0),
                       cuda_kernels.softmax_fused(tx))


# ------------------------------------------------------- through the model
@pytest.fixture(scope="module")
def nets():
    """The reference's bert_small with seeded numpy weights, and the
    arrays."""
    jnet = jbert.bert_small()
    jnet.initialize()
    jnet(mx.np.array(_tokens(1)))
    params = jnet.collect_params()
    arrays = bert_weights([(k, p.shape) for k, p in params.items()], 37)
    for k, p in params.items():
        p.set_data(mx.np.array(arrays[k])._data)
    return jnet, arrays


def _mask(tokens, seed=2):
    mask = (np.random.RandomState(seed).rand(*tokens.shape) > 0.3).astype(
        np.float32)
    mask[1] = 0.0                       # a sequence masked everywhere
    return mask


@pytest.mark.parametrize("with_mask", [False, True])
def test_inference_logits_match_reference(nets, with_mask):
    jnet, arrays = nets
    net = _port(arrays)
    tokens = _tokens(3, seed=1)
    mask = _mask(tokens) if with_mask else None
    with torch.inference_mode():
        out = net(torch.from_numpy(tokens), None,
                  None if mask is None else torch.from_numpy(mask))
    _close(out.numpy(), _ref(jnet, tokens, None, mask))


def _recorder(calls):
    def fused(x, **kw):
        calls.append(kw)
        return cuda_kernels.softmax_fused(x, **kw)
    return fused


@pytest.mark.parametrize("with_mask", [False, True])
def test_inference_forward_folds_scale_and_mask_once_a_layer(
        nets, with_mask, monkeypatch):
    """bert_small (2 layers, 4 heads of 16): one ``softmax_fused`` call a
    layer with div = √16 and the (B, T) keep mask."""
    calls = []
    monkeypatch.setattr(tbert, "softmax_fused", _recorder(calls))
    tokens = _tokens(3, seed=1)
    mask = _mask(tokens) if with_mask else None
    with torch.inference_mode():
        _port(nets[1])(torch.from_numpy(tokens), None,
                       None if mask is None else torch.from_numpy(mask))
    assert [c["div"] for c in calls] == [4.0, 4.0]
    for c in calls:
        if with_mask:
            assert c["keep"].dtype == torch.bool
            assert torch.equal(c["keep"], torch.from_numpy(mask != 0))
        else:
            assert c["keep"] is None


def _reference_grads(jnet, tokens, mask, g, names):
    with mx.autograd.record():
        out = jnet(mx.np.array(tokens), mask=mx.np.array(mask))
        loss = (out * mx.np.array(g)).sum()
    loss.backward()
    params = jnet.collect_params()
    return {n: np.asarray(params[n].grad()._data) for n in names}


def test_recording_forward_keeps_softmax_fn_and_matches_reference_grads(
        nets, monkeypatch):
    """With autograd recording, the scores are divided, masked and sent
    through ``ops.nn.softmax`` → ``SoftmaxFn`` (its closed-form backward),
    never through the prologue; the gradients of the attention and
    embedding weights match the reference's ``autograd.record()``."""
    jnet, arrays = nets
    fn_calls, fused_calls = [], []

    class Counting(cuda_kernels.SoftmaxFn):
        @staticmethod
        def forward(ctx, x):
            fn_calls.append(tuple(x.shape))
            return cuda_kernels.SoftmaxFn.forward(ctx, x)

    monkeypatch.setattr(tnn, "SoftmaxFn", Counting)
    monkeypatch.setattr(tbert, "softmax_fused", _recorder(fused_calls))
    tokens = _tokens(2, seed=6)
    mask = _mask(tokens, seed=7)
    g = np.random.RandomState(8).randn(2, tokens.shape[1], 1000).astype(
        np.float32)
    names = ["encoder.layer0.attention.qkv.weight",
             "encoder.layer1.attention.qkv.weight",
             "encoder.layer1.attention.proj.weight",
             "encoder.word_embed.weight"]
    net = _port(arrays)
    out = net(torch.from_numpy(tokens), None, torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()
    assert fn_calls == [(2, 4, 16, 16)] * 2 and fused_calls == []
    ref = _reference_grads(jnet, tokens, mask, g, names)
    params = net.collect_params()
    for n in names:
        got = params[n].grad.numpy()
        scale = np.abs(ref[n]).max()
        assert scale > 0 and np.isfinite(got).all()
        assert np.abs(got - ref[n]).max() <= GRAD_TOL * scale, n


# ------------------------------------------------------------- the wrapper
class _FakeCudaMask(_FakeCuda):
    """A stand-in CUDA mask the wrapper may make contiguous and view as
    bytes before the launch."""

    def contiguous(self):
        return self

    def view(self, dtype):
        return _FakeCudaMask(self._t.view(dtype))

    def data_ptr(self):
        return 64


@pytest.mark.parametrize("x,keep,exc", [
    (torch.zeros(4, 8, dtype=torch.float64), None, TypeError),   # x dtype
    (torch.zeros(4, 8, dtype=torch.int32), None, TypeError),
    (torch.zeros(4, 8), torch.ones(2, 8, dtype=torch.bool),
     ValueError),                                       # mask on the CPU
    (torch.zeros(4, 8), _FakeCudaMask(torch.ones(3, 8, dtype=torch.bool)),
     ValueError),                                       # 3 rows into 4
    (torch.zeros(4, 8), _FakeCudaMask(torch.ones(2, 7, dtype=torch.bool)),
     ValueError),                                       # last dim
    (torch.zeros(4, 8), _FakeCudaMask(torch.ones(2, 8)), TypeError),
])
def test_prologue_wrapper_refuses(x, keep, exc, monkeypatch):
    monkeypatch.setattr(cuda_kernels._build, "lib", _no_lib)
    with pytest.raises(exc):
        cuda_kernels.softmax_fused(_FakeCuda(x), div=8.0, keep=keep)


def test_prologue_cpu_route_refuses_a_mask_that_does_not_divide_the_rows():
    with pytest.raises(ValueError):
        cuda_kernels.softmax_fused(torch.zeros(2, 3, 5, 8), div=8.0,
                                   keep=torch.ones(4, 8, dtype=torch.bool))


def test_wrapper_hands_the_kernel_its_prologue(monkeypatch):
    """What reaches the C entry: the prologue flag, the divisor, the mask
    as bytes and the rows a mask row serves (H·T for (B, H, T, T)
    scores); without div and keep, no prologue.  The library is a
    recorder; the CUDA calls around it are stubbed."""
    calls = []

    class _Lib:
        def mxt_softmax_f32(self, *args):
            calls.append(args)
            return 0

    class _X(_FakeCudaMask):
        def data_ptr(self):
            return 0

    monkeypatch.setattr(cuda_kernels._build, "lib", lambda: _Lib())
    monkeypatch.setattr(torch, "empty_like",
                        lambda t: _FakeCuda(torch.zeros(t.shape)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=7))
    B, H, T = 2, 12, 16
    x = _X(torch.zeros(B, H, T, T))
    keep = _FakeCudaMask(torch.ones(B, T, dtype=torch.bool))
    before = cuda_kernels.softmax_fused.launches
    cuda_kernels.softmax_fused(x, div=math.sqrt(48), keep=keep)
    cuda_kernels.softmax_fused(x)
    assert cuda_kernels.softmax_fused.launches == before + 2
    (_, _, rows, cols, vec, pro, div, kptr, per, stream), plain = calls
    assert (rows, cols, vec, pro, per, stream) == (B * H * T, T, 4, 1,
                                                   H * T, 7)
    assert div == math.sqrt(48) and kptr == 64
    assert plain[2:] == (B * H * T, T, 4, 0, 1.0, None, 1, 7)
