"""The rtc route of the PyTorch port (``mxnet_tpu_torch.rtc`` over
``mxnet_tpu_torch._nvrtc``) on the CPU: signature parsing (given, and
read from the source), the argument and dtype checks a launch makes
before anything reaches the card, ``block_shapes`` and CPU tensors
refused, ``PallasModule`` refused as the JAX package refuses
``CudaModule``, the program and disk-cache keys, and where libnvrtc is
looked for.  This host has no NVRTC and no card: compiling and launching
are held against plain torch on the card by ``chip_smoke.py``.  The
example kernels' plain versions (``examples/rtc_example.py``) are held
here against the JAX package's Pallas kernels in interpret mode, bit
for bit (2x is exact, so ``2x + y`` rounds once either way).
"""
import ctypes
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu_torch import _nvrtc, rtc  # noqa: E402
from mxnet_tpu_torch.examples import rtc_example  # noqa: E402

torch.set_num_threads(1)

P = rtc.Param


# ------------------------------------------------------------ signatures
@pytest.mark.parametrize("sig,want", [
    ("const float *x, const float *y, float *o, int n",
     [P("x", "float", True, True), P("y", "float", True, True),
      P("o", "float", True, False), P("n", "int", False, False)]),
    ("const double* __restrict__ a, long long n, unsigned char *m",
     [P("a", "double", True, True), P("n", "long long", False, False),
      P("m", "unsigned char", True, False)]),
    ("float *, int", [P("arg0", "float", True, False),
                      P("arg1", "int", False, False)]),
    ("", []), ("void", []),
    ("const T *x, T *o, size_t n",
     [P("x", "T", True, True), P("o", "T", True, False),
      P("n", "size_t", False, False)]),
])
def test_parse_signature(sig, want):
    assert rtc.parse_signature(sig, templates=("T",)) == want


@pytest.mark.parametrize("sig,match", [
    ("float **p", "pointer to a pointer"),
    ("float &r", "pointers and plain scalars"),
    ("float a[4]", "pointers and plain scalars"),
    ("Foo x", "unknown type"),
    ("const T *x", "unknown type"),          # T is not a template here
    ("void v", "is void"),
])
def test_parse_signature_refuses(sig, match):
    with pytest.raises(ValueError, match=match):
        rtc.parse_signature(sig)


def test_signature_read_from_the_source():
    mod = rtc_example.module()
    axpy = mod.get_kernel("axpy")
    assert axpy.params == rtc.parse_signature(
        "const float *x, const float *y, float *o, long long n")
    assert axpy.template is None and axpy._outs == [2]
    dbl = mod.get_kernel("double_it")
    assert dbl.template == "T"
    assert [p.ctype for p in dbl.params] == ["float", "T", "long long"]
    # explicit template arguments make the instantiation
    dbl_i = mod.get_kernel("double_it<int>")
    assert dbl_i.template is None and dbl_i.name == "double_it<int>"
    assert [p.ctype for p in dbl_i.params] == ["float", "int", "long long"]
    # a given signature is taken as is
    k = mod.get_kernel("axpy", "const float *a, const float *b, float *c, "
                               "long long n")
    assert [p.name for p in k.params] == ["a", "b", "c", "n"]


def test_declaration_forms():
    src = """
    // __global__ void commented_out(int n)
    extern "C" __global__ void __launch_bounds__(128, 2)
    k1(const int *a, /* the output */ int *b) {}
    template <class U>
    __global__ void k2(U *o) {}
    __global__ void k3(float *o, float s) {}
    """
    mod = rtc.CudaModule(src, exports=("k3",))
    assert [p.name for p in mod.get_kernel("k1").params] == ["a", "b"]
    assert mod.get_kernel("k2").template == "U"
    assert mod.get_kernel("k3").params[1] == P("s", "float", False, False)
    with pytest.raises(ValueError, match="pass signature="):
        mod.get_kernel("commented_out")
    with pytest.raises(ValueError, match="cannot have 3 outputs"):
        mod.get_kernel("k1", n_outputs=3)
    with pytest.raises(ValueError, match="points to const"):
        rtc.CudaModule("extern \"C\" __global__ void k(const float *o) {}"
                       ).get_kernel("k")
    with pytest.raises(TypeError):
        rtc.CudaModule(b"bytes are not source")


# ---------------------------------------------------------- launch checks
def _axpy():
    return rtc_example.module().get_kernel("axpy")


def test_cpu_tensor_refused():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        _axpy().launch([x, x, 8])


def test_block_shapes_refused():
    x = torch.zeros(16)
    with pytest.raises(ValueError, match="BlockSpec has no CUDA counterpart"):
        rtc_example.module().get_kernel("double_it").launch(
            [x, 16], grid=(2,), block_shapes=[(8,)], out_shape=(16,))


def test_argument_count_checked():
    with pytest.raises(TypeError, match=r"takes 3 arguments \(x, y, n\)"):
        _axpy().launch([torch.zeros(8), torch.zeros(8)])


@pytest.mark.parametrize("grid", [(0,), (1, 2, 3, 4), (1.5,), "x"])
def test_grid_checked(grid):
    with pytest.raises(ValueError, match="grid must be"):
        _axpy().launch([torch.zeros(8), torch.zeros(8), 8], grid=grid)


def test_argument_types_checked():
    """The per-argument check a launch makes (here on CPU tensors, which
    the launch itself refuses first)."""
    k = _axpy()
    cpu = torch.device("cpu")
    x, n = k.params[0], k.params[3]
    t = torch.zeros(4)
    assert k._carg(x, t, cpu, None).value == t.data_ptr()
    with pytest.raises(TypeError, match=r"torch.float64, the signature says "
                                        r"float \*"):
        k._carg(x, torch.zeros(4, dtype=torch.float64), cpu, None)
    with pytest.raises(ValueError, match="not contiguous"):
        k._carg(x, torch.zeros(4, 4).t(), cpu, None)
    with pytest.raises(TypeError, match="takes a tensor"):
        k._carg(x, [1.0, 2.0], cpu, None)
    with pytest.raises(ValueError, match="the launch is on"):
        k._carg(x, torch.zeros(4), torch.device("meta"), None)
    assert k._carg(n, 2 ** 40, cpu, None).value == 2 ** 40
    assert k._carg(n, np.int64(5), cpu, None).value == 5
    with pytest.raises(ValueError, match="does not fit long long"):
        k._carg(n, 2 ** 64, cpu, None)
    with pytest.raises(TypeError, match="takes an integer"):
        k._carg(n, 8.0, cpu, None)
    with pytest.raises(TypeError, match="takes a number, got a tensor"):
        k._carg(n, torch.tensor(8), cpu, None)
    s = P("s", "float", False, False)
    assert k._carg(s, 2, cpu, None).value == 2.0
    assert isinstance(k._carg(s, 0.5, cpu, None), ctypes.c_float)
    with pytest.raises(TypeError, match="takes a number"):
        k._carg(s, "0.5", cpu, None)
    i = P("i", "int", False, False)
    with pytest.raises(ValueError, match="does not fit int"):
        k._carg(i, 2 ** 31, cpu, None)
    # a template pointer follows the bound dtype
    t = P("o", "T", True, False)
    dbl = rtc_example.module().get_kernel("double_it")
    dbl._carg(t, torch.zeros(2, dtype=torch.int32), cpu, torch.int32)
    with pytest.raises(TypeError, match="signature says T"):
        dbl._carg(t, torch.zeros(2), cpu, torch.int32)


def test_pallas_module_refused_as_the_reference_refuses_cuda():
    with pytest.raises(RuntimeError, match="use mxnet_tpu_torch.rtc"):
        rtc.PallasModule(axpy=lambda x_ref, o_ref: None)
    with pytest.raises(RuntimeError, match="PallasModule"):
        mx.rtc.CudaModule("__global__ void k() {}")


# ------------------------------------------------------ plain vs Pallas
def test_axpy_plain_matches_the_reference_kernel():
    def axpy_kernel(x_ref, y_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0 + y_ref[:]

    rs = np.random.RandomState(0)
    for n in (8, 1000):
        x = (rs.randn(n) * 100).astype(np.float32)
        y = rs.randn(n).astype(np.float32)
        kern = mx.rtc.PallasModule(axpy=axpy_kernel).get_kernel("axpy")
        ref = kern.launch([mx.np.array(x), mx.np.array(y)], out_shape=(n,),
                          interpret=True).asnumpy()
        out = rtc_example.axpy_plain(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_array_equal(out.numpy(), ref)
    # the JAX test's own case
    x = torch.arange(8, dtype=torch.float32)
    np.testing.assert_array_equal(
        rtc_example.axpy_plain(x, torch.ones(8)).numpy(),
        np.arange(8) * 2 + 1)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.int32, jnp.int32)])
def test_double_plain_matches_the_reference_kernel(dtype, jdtype):
    def double_kernel(x_ref, o_ref):
        o_ref[:] = (x_ref[:] * 2.0).astype(o_ref.dtype)

    x = (np.random.RandomState(1).randn(16) * 50).astype(np.float32)
    kern = mx.rtc.PallasModule(double=double_kernel).get_kernel("double")
    ref = kern.launch([mx.np.array(x)], grid=(2,), block_shapes=[(8,)],
                      out_shape=(16,), out_dtype=jdtype,
                      interpret=True).asnumpy()
    out = rtc_example.double_plain(torch.from_numpy(x), dtype)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out.numpy(), ref)


# ------------------------------------------------- axpy launch geometry
def _axpy_writes(n, aligned, grid):
    """How often ``examples/rtc_kernels.cu``'s ``axpy`` writes each of
    ``n`` elements when launched on ``grid`` blocks of 256 threads, by
    its index arithmetic: aligned operands take a pass over n // 4
    16-byte vectors and a scalar pass over the last n % 4 elements, an
    unaligned operand one scalar pass over all of them.  In a pass over
    ``count`` items, thread t of block b takes items b·1024 + u·256 + t
    (u < 4) below ``count``, and again a grid's items further on while
    its first item is below ``count``."""
    T, U = rtc_example.THREADS, rtc_example.AXPY_ITEMS
    W = rtc_example.AXPY_VEC
    writes = np.zeros(n, np.uint8)

    def one_pass(start, count, width):
        step = grid * T * U
        for chunk in range(0, grid, 1024):      # blocks, 1024 at a time
            blocks = np.arange(chunk, min(grid, chunk + 1024))
            base0 = blocks[:, None] * T * U + np.arange(T)[None, :]
            items0 = (base0[:, None, :] +
                      np.arange(U)[None, :, None] * T).ravel()
            for s in range(0, count, step):
                base = (base0 + s).ravel()
                live = np.repeat(base < count, U)   # the loop's own test
                items = (items0 + s)[live]
                items = items[items < count]
                for j in range(width):
                    # items are distinct, so += counts each once
                    writes[start + items * width + j] += 1

    done = 0
    if aligned:
        one_pass(0, n // W, W)
        done = n // W * W
    one_pass(done, n - done, 1)
    return writes


@pytest.mark.parametrize("start", ["aligned", "offset"])
@pytest.mark.parametrize("n", [1, 3, 8, 4097, 64 * 56 * 56 * 256])
def test_axpy_launch_geometry_covers_every_element_once(n, start):
    """``grid_axpy``'s grid, one block per 256 × 4 × 4 floats on the
    16-byte path and per 256 × 4 on the scalar path, makes the kernel
    write every element exactly once on the 16-byte path with its scalar
    tail and on the scalar path of an offset view; so does a single
    block, as the kernel loops over what the grid leaves."""
    aligned = start == "aligned"
    grid = rtc_example.grid_axpy(n, aligned)[0]
    assert grid == max(1, -(-n // (4096 if aligned else 1024)))
    assert (_axpy_writes(n, aligned, grid) == 1).all()
    if n < 10 ** 6:
        assert (_axpy_writes(n, aligned, 1) == 1).all()
    # the host's view of the kernel's own alignment test
    base = torch.zeros(min(n, 4097) + 1)
    x = base[1:] if start == "offset" else base[:-1]
    o = torch.zeros(x.numel())
    assert rtc_example.vector_path(x, x, o) == (aligned and x.numel() >= 4)


# ------------------------------------------------------- program caching
class _FakeNvrtc:
    """Stands in for NVRTC and the driver: counts compiles and loads."""

    def __init__(self):
        self.compiled = []
        self.loaded = []

    def compile_program(self, source, options=(), name_exprs=()):
        self.compiled.append(tuple(name_exprs))
        lowered = {e: f"_Z{len(e)}{e.replace('<', 'I').replace('>', 'E')}"
                   for e in name_exprs}
        return _nvrtc.Cubin(b"", f"d{len(self.compiled)}", lowered, "",
                            False, 0.0)

    def load_function(self, cubin, symbol, device):
        self.loaded.append((cubin.digest, symbol, device))
        return ctypes.c_void_p(len(self.loaded))


def test_programs_keyed_by_name_expressions(monkeypatch):
    fake = _FakeNvrtc()
    monkeypatch.setattr(_nvrtc, "compile_program", fake.compile_program)
    monkeypatch.setattr(_nvrtc, "load_function", fake.load_function)
    mod = rtc_example.module()
    mod.function("axpy", 0)
    mod.function("axpy", 0)
    mod.function("double_it<float>", 0)
    mod.function("double_it<int>", 1)
    # one program holds the extern "C" kernel and both exported
    # instantiations; an unexported one gets a program of its own
    assert fake.compiled == [rtc_example.EXPORTS]
    assert mod.compiles == 1
    mod.function("double_it<double>", 0)
    mod.function("double_it<double>", 0)
    assert fake.compiled == [rtc_example.EXPORTS,
                             rtc_example.EXPORTS + ("double_it<double>",)]
    assert mod.compiles == 2
    syms = [s for _, s, _ in fake.loaded]
    assert syms[0] == "axpy" and syms[2] == "_Z16double_itIfloatE"
    assert fake.loaded[3][2] == 1


def test_one_program_under_concurrent_first_launches(monkeypatch):
    """Many threads asking for a module's function at once compile its
    program once (the double-checked lock in ``CudaModule._cubin``)."""
    import threading
    import time
    fake = _FakeNvrtc()
    slow = fake.compile_program

    def compile_slowly(*a, **k):
        time.sleep(0.01)
        return slow(*a, **k)

    monkeypatch.setattr(_nvrtc, "compile_program", compile_slowly)
    monkeypatch.setattr(_nvrtc, "load_function", fake.load_function)
    mod = rtc_example.module()
    errs = []

    def worker():
        try:
            for name in ("axpy", "double_it<int>", "double_it<double>"):
                mod.function(name, 0)
        except Exception as e:      # reported below, not swallowed
            errs.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts) and not errs
    assert sorted(fake.compiled) == sorted(
        [rtc_example.EXPORTS, rtc_example.EXPORTS + ("double_it<double>",)])
    assert mod.compiles == 2


def test_disk_cache_key_and_read(monkeypatch, tmp_path):
    monkeypatch.setattr(_nvrtc, "version", lambda: (12, 8))
    d = _nvrtc._digest
    base = d("src", ("-O3",), ("k<int>",), "sm_90a")
    assert base == d("src", ("-O3",), ("k<int>",), "sm_90a")
    for other in (d("src2", ("-O3",), ("k<int>",), "sm_90a"),
                  d("src", (), ("k<int>",), "sm_90a"),
                  d("src", ("-O3",), ("k<float>",), "sm_90a"),
                  d("src", ("-O3",), ("k<int>",), "sm_90")):
        assert other != base
    monkeypatch.setattr(_nvrtc, "version", lambda: (12, 9))
    assert d("src", ("-O3",), ("k<int>",), "sm_90a") != base
    monkeypatch.setattr(_nvrtc, "version", lambda: (12, 8))
    # a cached program is read without NVRTC compiling
    monkeypatch.setattr(_nvrtc, "CACHE_DIR", tmp_path)
    (tmp_path / f"{base}.cubin").write_bytes(b"\x7fELF-cubin")
    (tmp_path / f"{base}.json").write_text('{"k<int>": "_Z1kIiEvv"}')

    def no_nvrtc():
        raise AssertionError("NVRTC loaded for a cached program")

    monkeypatch.setattr(_nvrtc, "_load_nvrtc", no_nvrtc)
    cub = _nvrtc.compile_program("src", ("-O3",), ("k<int>",))
    assert cub.cached and cub.image == b"\x7fELF-cubin"
    assert cub.lowered == {"k<int>": "_Z1kIiEvv"} and cub.digest == base
    with pytest.raises(AssertionError, match="NVRTC loaded"):
        _nvrtc.compile_program("src", ("-O3",), ("k<int>",), use_cache=False)


def test_nvrtc_search_order(monkeypatch, tmp_path):
    home = tmp_path / "cuda"
    (home / "lib64").mkdir(parents=True)
    (home / "lib64" / "libnvrtc.so.12").write_bytes(b"")
    (home / "lib64" / "libnvrtc-builtins.so.12").write_bytes(b"")
    wheel = tmp_path / "site" / "nvidia" / "cuda_nvrtc" / "lib"
    wheel.mkdir(parents=True)
    (wheel / "libnvrtc.so.12").write_bytes(b"")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(sys, "path", [str(tmp_path / "site")])
    c = _nvrtc._candidates()
    assert c[0] == str(home / "lib64" / "libnvrtc.so.12")
    assert not any("builtins" in p for p in c)
    assert c.index(str(wheel / "libnvrtc.so.12")) > \
        c.index("/usr/local/cuda/lib64/libnvrtc.so")
    assert c[-2:] == ["libnvrtc.so.12", "libnvrtc.so"]


def test_nvrtc_not_found_names_every_path(monkeypatch, tmp_path):
    missing = str(tmp_path / "nope" / "libnvrtc.so.12")
    monkeypatch.setattr(_nvrtc, "_nvrtc", None)
    monkeypatch.setattr(_nvrtc, "_candidates",
                        lambda: [missing, "libnvrtc-not-a-soname.so.99"])
    with pytest.raises(RuntimeError) as e:
        _nvrtc._load_nvrtc()
    assert missing in str(e.value) and "not-a-soname" in str(e.value)
