"""Three parity repairs of the port against the JAX package, each held on
the CPU with the same ``numpy.random.RandomState`` inputs fed to both:

- ``ops.nn.batch_norm`` and ``ops.nn.residual_block`` default to
  training, as the reference's do;
- the mode-dependent Gluon blocks (``BatchNorm``, ``Dropout``, the fused
  conv + BN segment) follow ``autograd.record()`` / ``train_mode()`` /
  ``predict_mode()``, as the reference's follow ``tape.is_training()``;
  outside every scope they keep their own ``train()`` / ``eval()``;
- bf16 and fp16 GELU (tanh and erf forms), log-softmax (both axes),
  sigmoid and softrelu round where XLA rounds them, so they equal the
  reference's jitted public ops bit for bit.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.ops import nn as jnn  # noqa: E402
from mxnet_tpu_torch import autograd as tautograd  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tgnn  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5          # of the reference's largest magnitude
OUTSIDE_TOL = 4.8e-7  # absolute: the two packages' inference BatchNorm


def _close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())
    return err


def _np(a):
    """numpy of a port tensor or a reference array / NDArray."""
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a)


def _bn_x():
    return (np.random.RandomState(0).randn(4, 5, 5, 3) * 2 + 1).astype(
        np.float32)


# ------------------------------------------------- fault 1: the default
def test_batch_norm_defaults_to_training_as_the_reference():
    """No ``training`` argument: both normalize by the batch statistics
    and move the running ones (the port normalized by the running ones
    and left them at 0 and 1)."""
    x = _bn_x()
    one, zero = np.ones(3, np.float32), np.zeros(3, np.float32)
    ref = jnn.batch_norm(*map(jnp.asarray, (x, one, zero, zero, one)))
    out = tnn.batch_norm(*map(torch.from_numpy, (x, one, zero, zero, one)))
    for a, b, what in zip(out, ref, ("out", "mean", "var")):
        _close(_np(a), _np(b), TOL, what)


def test_residual_block_defaults_to_training_as_the_reference():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 6, 6, 8).astype(np.float32)
    w = (rs.randn(3, 3, 8, 8) * 0.2).astype(np.float32)
    one, zero = np.ones(8, np.float32), np.zeros(8, np.float32)
    ref = jnn.residual_block(*map(jnp.asarray, (x, w, one, zero, zero,
                                                one)))
    out = tnn.residual_block(*map(torch.from_numpy, (x, w, one, zero, zero,
                                                     one)))
    for a, b, what in zip(out, ref, ("out", "mean", "var")):
        _close(_np(a), _np(b), TOL, what)


# ---------------------------------------- fault 2: the mode from autograd
def _scope(ag, scope):
    return getattr(ag, scope)() if scope else contextlib.nullcontext()


def _bn_pair():
    jbn = jgnn.BatchNorm()
    jbn.initialize()
    bn = tgnn.BatchNorm()
    bn.initialize(ctx="cpu")
    return jbn, bn


def _running(jbn, bn):
    return [(_np(getattr(bn, n)), _np(getattr(jbn, n).data()))
            for n in ("running_mean", "running_var")]


@pytest.mark.parametrize("scope", ["record", "train_mode", None])
def test_batchnorm_block_follows_the_autograd_scope(scope):
    """A fresh ``BatchNorm`` (its own flag: inference) called inside
    ``record()`` or ``train_mode()`` trains in both packages: batch
    statistics, running statistics moved.  Outside both, both infer and
    agree within 4.8e-7, as before the repair."""
    x = _bn_x()
    jbn, bn = _bn_pair()
    with _scope(mx.autograd, scope):
        ref = jbn(mx.np.array(x))
    with _scope(tautograd, scope):
        out = bn(torch.from_numpy(x))
    err = _close(_np(out), _np(ref), TOL, "out")
    for a, b in _running(jbn, bn):
        _close(a, b, TOL, "running")
    moved = not np.array_equal(_np(bn.running_mean), np.zeros(3))
    assert moved == (scope is not None)
    if scope is None:
        assert err <= OUTSIDE_TOL


def test_predict_mode_inside_record_gives_inference():
    """An explicit ``predict_mode()`` inside ``record()`` infers, also
    for a block set to ``train()``: the scope decides, as in the
    reference."""
    x = _bn_x()
    jbn, bn = _bn_pair()
    bn.train()
    with mx.autograd.record(), mx.autograd.predict_mode():
        ref = jbn(mx.np.array(x))
    with tautograd.record(), tautograd.predict_mode():
        out = bn(torch.from_numpy(x))
    _close(_np(out), _np(ref), TOL, "out")
    for a, b in _running(jbn, bn):
        _close(a, b, TOL, "running")
    assert np.array_equal(_np(bn.running_mean), np.zeros(3))
    assert tautograd.training_scope() is None      # the scopes restored


def test_dropout_drops_inside_record_and_not_outside():
    """``Dropout(0.5)`` inside ``record()`` zeroes some values and scales
    the others by 2; outside every scope a fresh block is the identity."""
    x = torch.from_numpy(np.random.RandomState(1).randn(64, 64).astype(
        np.float32))
    drop = tgnn.Dropout(0.5)
    with tautograd.record():
        y = drop(x)
    kept = y != 0
    assert 0 < int(kept.sum()) < x.numel()
    assert torch.equal(y[kept], x[kept] * 2)
    assert drop(x) is x


def test_fused_segment_trains_inside_record():
    """The fused conv + BN (+ ReLU) segment inside ``record()``: batch
    statistics and running-statistics write-back, equal to the
    reference's segment on the same weights."""
    rs = np.random.RandomState(2)
    x = rs.randn(2, 6, 6, 8).astype(np.float32)
    w = (rs.randn(3, 3, 8, 8) * 0.2).astype(np.float32)
    jconv = jgnn.Conv2D(8, 3, padding=1, use_bias=False, in_channels=8)
    jconv.initialize()
    jconv.weight.set_data(mx.np.array(w))
    jbn = jgnn.BatchNorm(in_channels=8)
    jbn.initialize()
    conv = tgnn.Conv2D(8, 3, padding=1, use_bias=False, in_channels=8)
    conv.initialize(ctx="cpu")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
    bn = tgnn.BatchNorm(in_channels=8)
    bn.initialize(ctx="cpu")
    with mx.autograd.record():
        ref = jgnn.fused_conv_bn_relu(jconv, jbn, mx.np.array(x))
    with tautograd.record():
        out = tgnn.fused_conv_bn_relu(conv, bn, torch.from_numpy(x))
    _close(_np(out), _np(ref), TOL, "out")
    for a, b in _running(jbn, bn):
        _close(a, b, TOL, "running")


# ------------------------------------ fault 3: half-precision roundings
HALF_OPS = {
    "gelu_tanh": lambda m, x: m.gelu(x, approximate=True),
    "gelu_erf": lambda m, x: m.gelu(x, approximate=False),
    "log_softmax_last": lambda m, x: m.log_softmax(x, axis=-1),
    "log_softmax_0": lambda m, x: m.log_softmax(x, axis=0),
    "sigmoid": lambda m, x: m.activation(x, "sigmoid"),
    "softrelu": lambda m, x: m.activation(x, "softrelu"),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("op", sorted(HALF_OPS))
def test_half_precision_op_matches_the_reference_bit_for_bit(op, dtype):
    """x (8, 768) = randn · 3 in bf16 or fp16 through the reference's
    public op (jitted by its dispatch cache) and the port's: bit for bit
    (the tolerance is none).  In particular every exact 0 of the
    reference is an exact 0 of the port (tanh-GELU of negative inputs in
    bf16, where the port gave up to 0.003 before)."""
    x = (np.random.RandomState(0).randn(8, 768) * 3).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
    assert np.array_equal(xt.float().numpy(),
                          np.asarray(xj.astype(jnp.float32)))
    ref = np.asarray(HALF_OPS[op](jnn, xj).astype(jnp.float32))
    out = HALF_OPS[op](tnn, xt)
    assert out.dtype == xt.dtype
    out = out.float().numpy()
    zeros = ref == 0
    assert (out[zeros] == 0).all(), int((out[zeros] != 0).sum())
    np.testing.assert_array_equal(out, ref)


def test_fp32_ops_keep_torch_s_own_functions():
    """fp32 takes the torch functions it took before (no fp32 path
    moves)."""
    x = torch.from_numpy(np.random.RandomState(4).randn(4, 32).astype(
        np.float32))
    assert torch.equal(tnn.gelu(x), torch.nn.functional.gelu(
        x, approximate="tanh"))
    assert torch.equal(tnn.log_softmax(x), torch.log_softmax(x, -1))
    assert torch.equal(tnn.activation(x, "sigmoid"), torch.sigmoid(x))
    assert torch.equal(tnn.activation(x, "softrelu"),
                       torch.nn.functional.softplus(x))
