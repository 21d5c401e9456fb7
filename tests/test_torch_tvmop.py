"""The generated-op registry of the PyTorch port (``mxnet_tpu_torch
.tvmop``) against the JAX package's (``mxnet_tpu.tvmop``) on the CPU.

The JAX ops run their Pallas bodies in interpret mode (their own
route off a TPU); the port's ops take their plain functions, because
the tensors lie on the CPU.  The CUDA source each op generates is
checked as text here (this host has no NVRTC); ``chip_smoke.py``
compiles it and holds each kernel against its plain version on the
card.  Tolerances: ``x + y`` and ``x * y`` are one IEEE operation, so
bit for bit; the sigmoid and its gradient within 1e-6 absolute
(``exp`` differs by a few ulp between the two libraries).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import autograd, nd, tvmop  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(4, 8), (3, 5, 7)]
SIGMOID_TOL = 1e-6


def _pair(shape, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        return [rs.randint(-1000, 1000, shape).astype(dtype)
                for _ in range(2)]
    return [(rs.randn(*shape) * 3).astype(dtype) for _ in range(2)]


def test_stock_ops_registered_on_nd():
    assert {"tvm_vadd", "tvm_vmul", "tvm_sigmoid"} <= set(tvmop.list_ops())
    assert set(tvmop.list_ops()) == set(mx.tvmop.list_ops())
    for name in ("tvm_vadd", "tvm_vmul", "tvm_sigmoid"):
        assert getattr(nd, name) is tvmop.get(name)
        assert getattr(mt.nd, name) is tvmop.get(name)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", ["tvm_vadd", "tvm_vmul"])
def test_binary_ops_bitwise_equal_to_reference(op, shape):
    a, b = _pair(shape, 0)
    ref = getattr(mx.nd, op)(mx.np.array(a), mx.np.array(b)).asnumpy()
    out = getattr(nd, op)(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("op", ["tvm_vadd", "tvm_vmul"])
def test_binary_ops_int32_bitwise_equal_to_reference(op):
    a, b = _pair((4, 8), 1, np.int32)
    ref = getattr(mx.nd, op)(mx.np.array(a), mx.np.array(b)).asnumpy()
    out = getattr(nd, op)(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_sigmoid_and_grad_match_reference(shape):
    x, g = _pair(shape, 2)
    jx = mx.np.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jy = mx.nd.tvm_sigmoid(jx)
    jy.backward(mx.np.array(g))
    tx = torch.from_numpy(x).requires_grad_()
    with autograd.record():
        ty = nd.tvm_sigmoid(tx)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(),
                               rtol=0, atol=SIGMOID_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                               rtol=0, atol=SIGMOID_TOL)
    # the closed form g·y·(1−y)
    y = 1 / (1 + np.exp(-x.astype(np.float64)))
    np.testing.assert_allclose(tx.grad.numpy(), g * y * (1 - y), rtol=0,
                               atol=SIGMOID_TOL * np.abs(g).max())


def test_user_registration_and_lookup():
    @mx.tvmop.register("tvm_test_relu")
    def _jrelu(x_ref, o_ref):
        import jax.numpy as jnp
        o_ref[...] = jnp.maximum(x_ref[...], 0.0)

    @tvmop.register("tvm_test_relu", body="o = x0 < T(0) ? T(0) : x0;")
    def _relu(x):
        return torch.clamp_min(x, 0)

    try:
        x = np.random.RandomState(3).randn(3, 5, 7).astype(np.float32)
        ref = mx.nd.tvm_test_relu(mx.np.array(x)).asnumpy()
        out = nd.tvm_test_relu(torch.from_numpy(x))
        np.testing.assert_array_equal(out.numpy(), ref)
        assert tvmop.get("tvm_test_relu") is _relu
        assert "tvm_test_relu" in tvmop.list_ops()
        assert _relu.num_inputs == 1
        assert "#define MXT_BODY o = x0 < T(0) ? T(0) : x0;" in \
            _relu.source(torch.float32)
    finally:
        for reg, ns in ((mx.tvmop._REGISTRY, mx.nd), (tvmop._REGISTRY, nd)):
            reg.pop("tvm_test_relu", None)
            if hasattr(ns, "tvm_test_relu"):
                delattr(ns, "tvm_test_relu")
    assert "tvm_test_relu" not in tvmop.list_ops()


def test_no_vjp_op_refuses_to_record():
    x = torch.ones(4, requires_grad=True)
    with autograd.record():
        with pytest.raises(RuntimeError, match="no registered vjp"):
            nd.tvm_vadd(x, x)
    with autograd.pause():
        out = nd.tvm_vadd(x, x)
    np.testing.assert_array_equal(out.numpy(), 2.0)
    # the reference refuses the same call
    jx = mx.np.array(np.ones(4, np.float32))
    jx.attach_grad()
    with mx.autograd.record():
        with pytest.raises(RuntimeError, match="no registered vjp"):
            mx.nd.tvm_vadd(jx, jx)


@pytest.mark.parametrize("dtype,ctype,tag", [
    (torch.float32, "float", "f32"), (torch.float64, "double", "f64"),
    (torch.int32, "int", "i32"), (torch.int64, "long long", "i64")])
@pytest.mark.parametrize("op,body,nin", [
    ("tvm_vadd", "o = x0 + x1;", 2), ("tvm_vmul", "o = x0 * x1;", 2),
    ("tvm_sigmoid", "o = T(1) / (T(1) + mxt_exp(-x0));", 1)])
def test_generated_source_splices_type_and_body(op, body, nin, dtype, ctype,
                                                tag):
    src = tvmop.get(op).source(dtype)
    head, template = src.split("\n// The generated-op kernel template", 1)
    assert f"typedef {ctype} T;" in head
    assert f"#define MXT_NIN {nin}" in head
    assert f"#define MXT_KERNEL mxt_tvmop_{op}_{tag}" in head
    assert f"#define MXT_BODY {body}" in head
    assert tvmop.get(op).kernel_name(dtype) == f"mxt_tvmop_{op}_{tag}"
    # the hand-written template follows, whole, and includes nothing
    assert src.endswith(tvmop.TEMPLATE.read_text())
    assert "#include" not in src
    assert 'extern "C" __global__' in template and "MXT_KERNEL(" in template


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int8, torch.bool])
def test_unsupported_dtype_raises(dtype):
    x = torch.zeros(4, dtype=dtype)
    with pytest.raises(TypeError, match="is not one of"):
        nd.tvm_vadd(x, x)
    with pytest.raises(TypeError, match="is not one of"):
        tvmop.get("tvm_vadd").source(dtype)


def test_mismatched_inputs_and_arity_raise():
    with pytest.raises(ValueError, match="share one device, dtype and shape"):
        nd.tvm_vadd(torch.zeros(4), torch.zeros(5))
    with pytest.raises(ValueError, match="share one device, dtype and shape"):
        nd.tvm_vadd(torch.zeros(4), torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="takes 2 inputs"):
        nd.tvm_vadd(torch.zeros(4))
    with pytest.raises(TypeError, match="needs body="):
        tvmop.register("tvm_test_nobody")(lambda x: x)


def test_cpu_tensor_never_reaches_the_kernel():
    """``_launch`` is the CUDA route only; the CPU route is the plain
    function, and nothing was compiled or launched for it."""
    with pytest.raises(ValueError, match="no kernel for cpu"):
        tvmop.get("tvm_vadd")._launch(torch.zeros(4), torch.zeros(4))
    for name in ("tvm_vadd", "tvm_vmul", "tvm_sigmoid"):
        assert tvmop.get(name).launches == 0
        assert tvmop.get(name).compiles == 0


def test_numpy_inputs_are_taken():
    a, b = _pair((4, 8), 4)
    np.testing.assert_array_equal(nd.tvm_vadd(a, b).numpy(), a + b)


@pytest.mark.parametrize("n,itemsize,ptrs,want", [
    # 16-byte aligned: one block per 1024 vectors
    (51_380_224, 4, [0x1000, 0x2000, 0x3000], (12_544, 1)),
    (1, 4, [0x1000, 0x2000], (1, 0)),               # under one vector
    (1_000_003, 4, [0x1000, 0x2000], (245, 1)),     # 250001 vectors
    (1_000_003, 4, [0x1004, 0x2000], (977, 0)),     # an offset view
    (1_000_003, 8, [0x1000, 0x2000], (489, 1)),     # doubles: 2 a vector
    (2, 8, [0x1000, 0x2008], (1, 0)),
    (2 ** 45, 4, [0], (2 ** 31 - 1, 1))])           # the grid's limit
def test_launch_config(n, itemsize, ptrs, want):
    assert tvmop.launch_config(n, itemsize, ptrs) == want


def test_interpret_fallback_is_accepted():
    op = tvmop.GeneratedOp("tvm_test_neg", lambda x: -x, "o = -x0;",
                           interpret_fallback=False)
    np.testing.assert_array_equal(op(torch.ones(3)).numpy(), -1.0)
    assert "tvm_test_neg" not in tvmop.list_ops()
