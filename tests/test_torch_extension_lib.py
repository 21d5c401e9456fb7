"""External extension libraries and the function registry of the
PyTorch port (``mxnet_tpu_torch.library``, ``mxnet_tpu_torch._ffi``)
against the JAX package's, on the CPU.

The example library (``example/extensions/lib_custom_op/custom_ops.cc``)
is built with ``g++`` by each package's ``compile_example``, as
``tests/test_extension_lib.py`` builds it, and loaded by both.  Its
hooks are host float32 code, so the two packages hand the same buffers
to the same functions: forward and backward are compared bit for bit.
"""
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu import library as jlib  # noqa: E402
from mxnet_tpu_torch import autograd, library, nd  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The example library built by each package into its own
    directory: (port's path, reference's path)."""
    port = library.compile_example(str(tmp_path_factory.mktemp("port")))
    ref = jlib.compile_example(str(tmp_path_factory.mktemp("ref")))
    return port, ref


def test_compile_example_builds_the_repo_example(libs):
    port, ref = libs
    assert os.path.basename(port) == os.path.basename(ref) == \
        "libcustom_ops.so"
    assert os.path.getsize(port) > 0


def test_load_registers_ops_on_nd(libs):
    ops = library.load(libs[0], verbose=False)
    assert set(ops) == {"my_relu6", "my_scale"}
    assert nd.my_relu6 is ops["my_relu6"] and mt.nd.my_scale is \
        ops["my_scale"]
    assert libs[0] in library.loaded_libs()
    assert (ops["my_relu6"].n_in, ops["my_relu6"].n_out) == (1, 1)
    assert ops["my_relu6"]._bwd is not None
    assert ops["my_relu6"]._infer is None


def test_load_reports_each_op(libs, capsys):
    library.load(libs[0])
    out = capsys.readouterr().out
    assert "registered external op nd.my_relu6 (1→1, differentiable)" in out


@pytest.mark.parametrize("shape", [(3,), (4, 8), (3, 5, 7)])
def test_ops_forward_backward_match_reference(libs, shape):
    library.load(libs[0], verbose=False)
    jops = jlib.load(libs[1], verbose=False)
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 5).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    for name, kw in (("my_relu6", {}), ("my_scale", {"k": 3.0}),
                     ("my_scale", {})):
        jx = mx.np.array(x)
        jx.attach_grad()
        with mx.autograd.record():
            jy = jops[name](jx, **kw)
        jy.backward(mx.np.array(g))
        tx = torch.from_numpy(x).requires_grad_()
        with autograd.record():
            ty = getattr(nd, name)(tx, **kw)
        ty.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(ty.detach().numpy(), jy.asnumpy())
        np.testing.assert_array_equal(tx.grad.numpy(), jx.grad.asnumpy())


def test_reference_cases(libs):
    """``tests/test_extension_lib.py``'s forward and backward cases."""
    library.load(libs[0], verbose=False)
    x = torch.tensor([[-2.0, 3.0, 9.0]])
    np.testing.assert_array_equal(nd.my_relu6(x).numpy(), [[0., 3., 6.]])
    np.testing.assert_array_equal(nd.my_scale(x, k=3.0).numpy(),
                                  [[-6., 9., 27.]])
    x = torch.tensor([-2.0, 3.0, 9.0], requires_grad=True)
    with autograd.record():
        nd.my_relu6(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0., 1., 0.])
    x2 = torch.tensor([1.0, 2.0], requires_grad=True)
    with autograd.record():
        nd.my_scale(x2, k=4.0).sum().backward()
    np.testing.assert_array_equal(x2.grad.numpy(), [4., 4.])


def test_wrong_arity_errors(libs):
    ops = library.load(libs[0], verbose=False)
    with pytest.raises(ValueError, match="expects 1 inputs, got 2"):
        ops["my_relu6"](torch.zeros(1), torch.zeros(1))


def test_output_keeps_the_input_device_and_takes_float64(libs):
    """The host round trip: float64 in, float32 buffers for the
    library, the result back on the input's device."""
    ops = library.load(libs[0], verbose=False)
    x = torch.tensor([[-1.5, 2.25, 7.0]], dtype=torch.float64,
                     requires_grad=True)
    with autograd.record():
        y = ops["my_relu6"](x)
    y.backward(torch.ones_like(y))
    assert y.device == x.device and y.dtype == torch.float32
    np.testing.assert_array_equal(y.detach().numpy(), [[0., 2.25, 6.]])
    assert x.grad.dtype == torch.float64
    np.testing.assert_array_equal(x.grad.numpy(), [[0., 1., 0.]])


@pytest.mark.parametrize("version", [0, 2])
def test_version_handshake_refuses_other_versions(tmp_path, version):
    src = tmp_path / "v.c"
    src.write_text(f"int MXTLibVersion(void) {{ return {version}; }}\n"
                   "int MXTLibNumOps(void) { return 0; }\n")
    so = str(tmp_path / f"libv{version}.so")
    subprocess.run(["g++", "-x", "c", "-shared", "-fPIC", str(src), "-o", so],
                   check=True)
    for lib in (library, jlib):
        with pytest.raises(RuntimeError, match=f"version {version} != "
                                               "supported 1"):
            lib.load(so, verbose=False)
    assert so not in library.loaded_libs()


# ------------------------------------------------------------------ _ffi
def test_register_and_call_match_reference():
    for m in (mx, mt):
        m._ffi.remove_global_func("test.add3")

        @m.register_func("test.add3")
        def add3(a, b, c):
            return a + b + c

        fn = m.get_global_func("test.add3")
        assert fn(1, 2, 3) == 6
        assert fn.name == "test.add3" and fn.is_global
        assert "test.add3" in m._ffi.list_global_func_names()
        with pytest.raises(ValueError, match="already registered"):
            m.register_func("test.add3", lambda: None)
        m.register_func("test.add3", lambda a, b, c: 0, override=True)
        assert m.get_global_func("test.add3")(1, 2, 3) == 0
        m._ffi.remove_global_func("test.add3")
        with pytest.raises(KeyError):
            m.get_global_func("test.add3")
        assert m.get_global_func("test.add3", allow_missing=True) is None


def test_bare_decorator_and_tensor_args():
    mt._ffi.remove_global_func("scale_it")

    @mt.register_func
    def scale_it(x, k):
        return x * k

    try:
        out = mt.get_global_func("scale_it")(torch.ones(2, 2), 3.0)
        np.testing.assert_array_equal(out.numpy(), 3.0)
        assert repr(mt.get_global_func("scale_it")) == \
            "<ffi.Function scale_it>"
    finally:
        mt._ffi.remove_global_func("scale_it")


def test_builtin_runtime_funcs(libs):
    names = mt._ffi.list_global_func_names()
    assert {"runtime.Features", "runtime.LoadLib"} <= set(names)
    feats = mt.get_global_func("runtime.Features")()
    assert feats["CUDA"] is torch.cuda.is_available()
    assert feats["TORCH"] == torch.__version__
    assert "NVRTC" in feats
    ops = mt.get_global_func("runtime.LoadLib")(libs[0])
    assert set(ops) == {"my_relu6", "my_scale"}
