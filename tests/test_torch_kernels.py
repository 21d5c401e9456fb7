"""Op-level parity of the PyTorch port's kernel modules against the JAX
package: LayerNorm (``mxnet_tpu_torch.ops.cuda_kernels``) and causal
attention (``mxnet_tpu_torch.ops.cuda_attention``).

On the CPU each port wrapper takes its plain version; the JAX reference
runs its Pallas kernels in interpret mode.  The CUDA kernels themselves
are held against their plain versions on the card by ``chip_smoke.py``.
"""
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


@pytest.mark.parametrize("x,g,b,exc", [
    (torch.zeros(4, 8, dtype=torch.float64), torch.zeros(8),
     torch.zeros(8), TypeError),                               # dtype
    (torch.zeros(4, 8), torch.zeros(7), torch.zeros(8), ValueError),  # gamma
    (torch.zeros(8, 4).t(), torch.zeros(8), torch.zeros(8), ValueError),
    (torch.zeros(2, 5000), torch.zeros(5000), torch.zeros(5000),
     ValueError),                                              # C > 4096
])
def test_layernorm_wrapper_refuses(x, g, b, exc, monkeypatch):
    monkeypatch.setattr(cuda_kernels._build, "lib", _no_lib)
    with pytest.raises(exc):
        cuda_kernels.layernorm_fused(_FakeCuda(x), _FakeCuda(g),
                                     _FakeCuda(b))


def _no_lib():
    raise AssertionError("the kernel library must not be reached")


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
