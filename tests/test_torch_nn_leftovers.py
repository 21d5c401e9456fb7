"""The Gluon nn blocks and ops the model zoo brought into the port
(``mxnet_tpu_torch/ops/nn.py``, ``mxnet_tpu_torch/gluon/nn``) against the
JAX package on the CPU: each op on the same seeded numpy inputs, forward
and, where the reference differentiates it, the gradient under one
random cotangent; each block on the same numpy weights.

Tolerances: element-wise ops within 1e-6 of the largest magnitude (the
same operations, rounded alike up to libm differences); convolutions,
pools and norms within 1e-5 (sums in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.ops import nn as jnn  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tgnn  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402

torch.set_num_threads(1)

EW_TOL = 1e-6       # element-wise: of the largest magnitude
SUM_TOL = 1e-5      # convolutions, pools, norms: sums in another order


def _close(out, ref, tol, what=""):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    assert out.dtype == ref.dtype, (what, out.dtype, ref.dtype)
    assert np.isfinite(out).all() == np.isfinite(ref).all(), what
    err = np.abs(out - ref).max() if out.size else 0.0
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (what, err)


def _rand(rs, *shape, scale=1.0):
    return (scale * rs.randn(*shape)).astype(np.float32)


def _both(tfn, jfn, args, tol, grad=True, seed=0):
    """``tfn`` on torch tensors and ``jfn`` on jax arrays of the same
    numpy ``args``; with ``grad``, the gradient of every float argument
    under one random cotangent too."""
    targs = [torch.from_numpy(a).requires_grad_(grad and a.dtype ==
                                                np.float32)
             for a in args]
    out = tfn(*targs)
    ref, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    _close(out.detach().numpy(), ref, tol, "value")
    if not grad:
        return
    g = np.random.RandomState(seed + 100).randn(*ref.shape).astype(
        np.float32)
    out.backward(torch.from_numpy(g))
    rgrads = vjp(jnp.asarray(g))
    for i, (t, r) in enumerate(zip(targs, rgrads)):
        if t.requires_grad:
            _close(t.grad.numpy(), r, tol, f"grad {i}")


# ------------------------------------------------------------ activations
ACTS = ["relu", "sigmoid", "tanh", "softrelu", "softsign", "gelu", "silu",
        "swish", "mish", "elu", "selu", "leaky", "log_sigmoid"]


@pytest.mark.parametrize("act", ACTS)
def test_activation_matches_reference(act):
    x = _rand(np.random.RandomState(0), 4, 33, scale=3.0)
    _both(lambda t: tnn.activation(t, act),
          lambda a: jnn.activation(a, act), [x], EW_TOL)


# fp16 expm1 is XLA's own (its exp differs from libm's by a step, which
# SELU's two constant products can carry to three), so ELU and SELU on
# fp16 are held to three fp16 steps of the value
EXPM1_STEPS = 3
EXPM1 = ("elu", "selu", "elu_fn")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("act", ACTS + ["hard_sigmoid", "elu_fn",
                                        "leaky_fn"])
def test_half_activation_keeps_the_references_roundings(act, dtype):
    """bf16 and fp16 activations equal the reference's bit for bit:
    each step rounded to the dtype as XLA rounds it, the weakly typed
    constants (slopes, SELU's scale and alpha) rounded first, fp16
    ``hard_sigmoid`` one fused multiply-add."""
    x = _rand(np.random.RandomState(19), 4000, scale=4.0)
    fns = {"hard_sigmoid": ("hard_sigmoid", {}),
           "elu_fn": ("elu", {"alpha": 0.7}),
           "leaky_fn": ("leaky_relu", {"slope": 0.2})}
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    if act in fns:
        name, kw = fns[act]
        out = getattr(tnn, name)(torch.from_numpy(x).to(tdt), **kw)
        ref = getattr(jnn, name)(jnp.asarray(x).astype(jdt), **kw)
    else:
        out = tnn.activation(torch.from_numpy(x).to(tdt), act)
        ref = jnn.activation(jnp.asarray(x).astype(jdt), act)
    assert out.dtype == tdt
    out = out.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float16" and act in EXPM1:
        step = np.spacing(np.abs(ref).astype(np.float16)).astype(np.float32)
        assert (np.abs(out - ref) <= EXPM1_STEPS * step).all()
    else:
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name,kw", [
    ("leaky_relu", {"slope": 0.2}), ("elu", {"alpha": 0.7}),
    ("selu", {}), ("hard_sigmoid", {}),
    ("hard_sigmoid", {"alpha": 0.3, "beta": 0.4})])
def test_free_activation_matches_reference(name, kw):
    x = _rand(np.random.RandomState(1), 3, 17, scale=4.0)
    _both(lambda t: getattr(tnn, name)(t, **kw),
          lambda a: getattr(jnn, name)(a, **kw), [x], EW_TOL)


def test_prelu_matches_reference():
    rs = np.random.RandomState(2)
    x, alpha = _rand(rs, 2, 5, 6), _rand(rs, 6)
    _both(tnn.prelu, jnn.prelu, [x, alpha], EW_TOL)


def test_dense_takes_every_activation_name():
    d = tgnn.Dense(3, activation="gelu", in_units=4)
    d.initialize(ctx="cpu", seed=0)
    x = torch.randn(2, 4)
    torch.testing.assert_close(d(x), tnn.gelu(x @ d.weight.T + d.bias))


# ------------------------------------------------------------ convolutions
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("kw", [{"stride": 1, "pad": 1},
                                {"stride": 2, "pad": 0, "dilate": 2}])
def test_convolution_layouts_match_reference(layout, kw):
    rs = np.random.RandomState(3)
    x = _rand(rs, 2, 9, 9, 4)
    if layout == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    w, b = _rand(rs, 3, 3, 4, 6), _rand(rs, 6)
    _both(lambda *a: tnn.convolution(*a, layout=layout, **kw),
          lambda *a: jnn.convolution(*a, layout=layout, **kw),
          [x, w, b], SUM_TOL)


@pytest.mark.parametrize("kw", [
    {"stride": 2, "pad": 1},
    {"stride": 2, "pad": 1, "output_padding": 1},
    {"stride": 1, "pad": 0, "dilate": 2},
    {"stride": (2, 3), "pad": (1, 0), "groups": 2},
    {"stride": 2, "pad": 1, "layout": "NCHW"}])
def test_conv_transpose_matches_reference(kw):
    rs = np.random.RandomState(4)
    x = _rand(rs, 2, 5, 6, 4)
    if kw.get("layout") == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    groups = kw.get("groups", 1)
    w, b = _rand(rs, 3, 3, 4 // groups, 6), _rand(rs, 6)
    _both(lambda *a: tnn.conv_transpose(*a, **kw),
          lambda *a: jnn.conv_transpose(*a, **kw), [x, w, b], SUM_TOL)


@pytest.mark.parametrize("ndims,kw", [(1, {"stride": 2, "pad": 1}),
                                      (3, {"stride": 1, "pad": 1}),
                                      (3, {"stride": 2, "groups": 2})])
def test_convolution_nd_matches_reference(ndims, kw):
    rs = np.random.RandomState(5)
    x = _rand(rs, 2, *([6] * ndims), 4)
    w = _rand(rs, *([3] * ndims), 4 // kw.get("groups", 1), 6)
    b = _rand(rs, 6)
    _both(lambda *a: tnn.convolution_nd(*a, ndims=ndims, **kw),
          lambda *a: jnn.convolution_nd(*a, ndims=ndims, **kw),
          [x, w, b], SUM_TOL)


# ------------------------------------------------------------------ pools
@pytest.mark.parametrize("pool_type", ["max", "avg", "sum", "lp"])
@pytest.mark.parametrize("kw", [
    {"kernel": 3, "stride": 2, "pad": 1},
    {"kernel": 3, "stride": 1, "pad": 1, "count_include_pad": False},
    {"kernel": (2, 3), "stride": (2, 1)},
    {"global_pool": True},
    {"global_pool": True, "layout": "NCHW"},
    {"kernel": 2, "stride": 2, "layout": "NCHW"}])
def test_pooling_matches_reference(pool_type, kw):
    x = _rand(np.random.RandomState(6), 2, 7, 8, 3)
    if kw.get("layout") == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    _both(lambda t: tnn.pooling(t, pool_type=pool_type, **kw),
          lambda a: jnn.pooling(a, pool_type=pool_type, **kw), [x],
          SUM_TOL)


@pytest.mark.parametrize("ndims", [1, 3])
@pytest.mark.parametrize("pool_type,kw", [
    ("max", {"kernel": 2}), ("avg", {"kernel": 3, "stride": 1, "pad": 1}),
    ("avg", {"kernel": 3, "stride": 2, "pad": 1,
             "count_include_pad": False}),
    ("sum", {"kernel": 2, "stride": 1}), ("max", {"kernel": 1,
                                                  "global_pool": True}),
    ("avg", {"kernel": 1, "global_pool": True})])
def test_pooling_nd_matches_reference(ndims, pool_type, kw):
    x = _rand(np.random.RandomState(7), 2, *([5] * ndims), 3)
    _both(lambda t: tnn.pooling_nd(t, pool_type=pool_type, ndims=ndims,
                                   **kw),
          lambda a: jnn.pooling_nd(a, pool_type=pool_type, ndims=ndims,
                                   **kw), [x], SUM_TOL)


@pytest.mark.parametrize("pad", [1, (2, 1)])
def test_reflection_pad2d_matches_reference(pad):
    x = _rand(np.random.RandomState(8), 2, 5, 4, 3)
    _both(lambda t: tnn.reflection_pad2d(t, pad),
          lambda a: jnn.reflection_pad2d(a, pad), [x], EW_TOL)


# ------------------------------------------------------------------ norms
def test_rms_norm_matches_reference():
    rs = np.random.RandomState(9)
    x, g = _rand(rs, 3, 4, 16, scale=2.0), _rand(rs, 16)
    _both(tnn.rms_norm, jnn.rms_norm, [x, g], SUM_TOL)


@pytest.mark.parametrize("axis", [-1, 1])
def test_instance_norm_matches_reference(axis):
    rs = np.random.RandomState(10)
    x = _rand(rs, 2, 5, 6, 4, scale=2.0) + 1.0
    c = x.shape[axis]
    g, b = _rand(rs, c), _rand(rs, c)
    _both(lambda *a: tnn.instance_norm(*a, eps=1e-5, axis=axis),
          lambda *a: jnn.instance_norm(*a, eps=1e-5, axis=axis),
          [x, g, b], SUM_TOL)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_norm_matches_reference(groups):
    rs = np.random.RandomState(11)
    x = _rand(rs, 2, 5, 3, 8, scale=2.0) - 0.5
    g, b = _rand(rs, 8), _rand(rs, 8)
    _both(lambda *a: tnn.group_norm(*a, num_groups=groups),
          lambda *a: jnn.group_norm(*a, num_groups=groups), [x, g, b],
          SUM_TOL)


@pytest.mark.parametrize("axis", [-1, 0])
def test_l2_normalize_matches_reference(axis):
    x = _rand(np.random.RandomState(12), 4, 7)
    _both(lambda t: tnn.l2_normalize(t, axis=axis),
          lambda a: jnn.l2_normalize(a, axis=axis), [x], SUM_TOL)


# --------------------------------------------------------------- the tail
@pytest.mark.parametrize("kw", [{}, {"on_value": 5.0, "off_value": -1.0}])
def test_one_hot_matches_reference(kw):
    idx = np.array([[0, 3, 5], [-1, 2, 6]], np.int32)      # 6, -1: rows of 0
    out = tnn.one_hot(torch.from_numpy(idx), 6, **kw)
    _close(out.numpy(), jnn.one_hot(jnp.asarray(idx), 6, **kw), 0.0)


@pytest.mark.parametrize("kw", [
    {"k": 3}, {"k": 2, "axis": 0, "ret_typ": "value"},
    {"k": 4, "ret_typ": "both", "is_ascend": True}])
def test_topk_matches_reference(kw):
    x = _rand(np.random.RandomState(13), 5, 9)
    out = tnn.topk(torch.from_numpy(x), **kw)
    ref = jnn.topk(jnp.asarray(x), **kw)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(outs, refs):
        _close(o.numpy(), np.asarray(r), 0.0)


SEQ = np.array([3, 1, 5, 4], np.int32)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("op", ["sequence_mask", "sequence_last",
                                "sequence_reverse"])
def test_sequence_ops_match_reference(op, axis):
    x = _rand(np.random.RandomState(14), 5, 4, 3)
    if axis == 1:
        x = np.ascontiguousarray(x.transpose(1, 0, 2))
    kw = {"axis": axis, "use_sequence_length": True}
    extra = {"value": -2.0} if op == "sequence_mask" else {}
    _both(lambda t, n: getattr(tnn, op)(t, n, **kw, **extra),
          lambda a, n: getattr(jnn, op)(a, n, **kw, **extra),
          [x, SEQ], EW_TOL)
    _close(getattr(tnn, op)(torch.from_numpy(x), axis=axis).numpy(),
           getattr(jnn, op)(jnp.asarray(x), axis=axis), 0.0)


def test_clip_global_norm_matches_reference():
    rs = np.random.RandomState(15)
    arrays = [_rand(rs, 3, 4, scale=3.0), _rand(rs, 7)]
    for max_norm in (1.0, 1e3):
        out, total = tnn.clip_global_norm(
            [torch.from_numpy(a) for a in arrays], max_norm)
        ref, rtotal = jnn.clip_global_norm(
            [jnp.asarray(a) for a in arrays], max_norm)
        _close(total.numpy(), rtotal, SUM_TOL)
        for o, r in zip(out, ref):
            _close(o.numpy(), r, SUM_TOL)


# ----------------------------------------------------------------- blocks
def _block_pair(make_t, make_j, x, seed):
    """The port's and the reference's block, initialized, shapes
    deferred to ``x``, the port's given the reference's weights
    replaced by seeded numpy ones."""
    jb = make_j()
    jb.initialize()
    jb(mx.np.array(x))
    rs = np.random.RandomState(seed)
    arrays = {}
    for k, p in jb.collect_params().items():
        a = (0.5 * rs.randn(*p.shape)).astype(np.float32)
        if k.endswith("gamma"):
            a = a + 1.0
        arrays[k] = a
        p.set_data(jnp.asarray(a))
    tb = make_t()
    tb.initialize(ctx="cpu", seed=0)
    tgluon.load_numpy(tb, arrays)
    return tb, jb


BLOCKS = [
    ("LeakyReLU", (0.1,), {}, (2, 5, 3)),
    ("PReLU", (), {"in_channels": 3}, (2, 5, 3)),
    ("ELU", (0.5,), {}, (2, 5, 3)),
    ("SELU", (), {}, (2, 5, 3)),
    ("Swish", (), {}, (2, 5, 3)),
    ("SiLU", (), {}, (2, 5, 3)),
    ("Conv1D", (6, 3), {"strides": 2, "padding": 1}, (2, 9, 4)),
    ("Conv2DTranspose", (5, 3), {"strides": 2, "padding": 1,
                                 "output_padding": 1}, (2, 4, 5, 3)),
    ("Conv2DTranspose", (4, (2, 3)), {"groups": 2}, (1, 4, 4, 6)),
    ("Conv3D", (5, 3), {"padding": 1}, (1, 4, 5, 4, 3)),
    ("Conv1DTranspose", (5, 3), {"strides": 2, "padding": 1}, (2, 6, 4)),
    ("Conv2D", (5, 3), {"padding": 1, "layout": "NCHW"}, (2, 3, 6, 6)),
    ("MaxPool1D", (3, 2, 1), {}, (2, 9, 4)),
    ("AvgPool2D", (3, 2, 1), {}, (2, 7, 7, 3)),
    ("AvgPool2D", (3, 1, 1), {"count_include_pad": False}, (2, 5, 6, 3)),
    ("MaxPool2D", (3, 2), {"ceil_mode": True}, (1, 8, 8, 2)),
    ("GlobalMaxPool2D", (), {}, (2, 5, 6, 3)),
    ("GlobalAvgPool2D", (), {"layout": "NCHW"}, (2, 3, 5, 6)),
    ("MaxPool3D", (2,), {}, (1, 4, 4, 6, 2)),
    ("AvgPool3D", (3, 1, 1), {"count_include_pad": False},
     (1, 4, 5, 3, 2)),
    ("AvgPool1D", (3, 2, 1), {}, (2, 9, 3)),
    ("GlobalMaxPool1D", (), {}, (2, 9, 3)),
    ("GlobalAvgPool1D", (), {}, (2, 9, 3)),
    ("GlobalMaxPool3D", (), {}, (1, 3, 4, 5, 2)),
    ("GlobalAvgPool3D", (), {}, (1, 3, 4, 5, 2)),
    ("GroupNorm", (2,), {}, (2, 4, 5, 6)),
    ("InstanceNorm", (), {}, (2, 4, 5, 6)),
    ("ReflectionPad2D", (2,), {}, (2, 4, 5, 3)),
    ("Identity", (), {}, (2, 4)),
]


@pytest.mark.parametrize("name,args,kw,shape", BLOCKS,
                         ids=[f"{b[0]}-{i}" for i, b in enumerate(BLOCKS)])
def test_block_matches_reference(name, args, kw, shape):
    x = _rand(np.random.RandomState(16), *shape)
    tb, jb = _block_pair(lambda: getattr(tgnn, name)(*args, **kw),
                         lambda: getattr(jgnn, name)(*args, **kw), x, 17)
    got = {k: tuple(t.shape) for k, t in tb.collect_params().items()}
    assert got == {k: tuple(p.shape) for k, p in
                   jb.collect_params().items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = tb(xt)
    ref = np.asarray(jb(mx.np.array(x))._data)
    _close(out.detach().numpy(), ref, SUM_TOL, name)
    out.sum().backward()
    assert torch.isfinite(xt.grad).all()


@pytest.mark.parametrize("cls", ["HybridConcatenate", "Concatenate"])
def test_concatenate_names_its_children_and_joins_on_the_last_axis(cls):
    x = _rand(np.random.RandomState(18), 2, 5, 5, 3)

    def make(nn):
        c = getattr(nn, cls)()
        c.add(nn.Conv2D(4, 1), nn.Conv2D(2, 3, padding=1), nn.Identity())
        return c
    tb, jb = _block_pair(lambda: make(tgnn), lambda: make(jgnn), x, 19)
    assert list(tb.collect_params()) == ["0.weight", "0.bias", "1.weight",
                                         "1.bias"]
    out = tb(torch.from_numpy(x))
    assert out.shape == (2, 5, 5, 9)
    _close(out.detach().numpy(), np.asarray(jb(mx.np.array(x))._data),
           SUM_TOL)


@pytest.mark.parametrize("cls", ["Lambda", "HybridLambda"])
def test_lambda_blocks_call_their_function(cls):
    b = getattr(tgnn, cls)(lambda a, c: a * 2 + c)
    x = torch.arange(4.0)
    torch.testing.assert_close(b(x, x), 3 * x)
    assert isinstance(b, tgnn.Block)
