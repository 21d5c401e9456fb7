"""Gluon BERT serving of the PyTorch port (``mxnet_tpu_torch.models
.bert_gluon`` through ``InferenceEngine``, ``Batcher`` and
``ModelRegistry`` on int32 token items) against the JAX package on the
CPU, with the reference's Pallas softmax and LayerNorm kernels in
interpret mode: parameter names and shapes, logits with and without
``mask`` and ``token_types``, ``.params`` files both ways, the engine per
bucket, padding and splitting of token items, the Gluon blocks the model
is built from, and the ``Constant`` / ``Normal`` initializers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.models import bert_gluon as jbert  # noqa: E402
from mxnet_tpu.ops import nn as jnn  # noqa: E402
from mxnet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mxnet_tpu.serve import InferenceEngine as JEngine  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import initializer as tinit  # noqa: E402
from mxnet_tpu_torch import telemetry as ttel  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tgnn  # noqa: E402
from mxnet_tpu_torch.models import bert_gluon as tbert  # noqa: E402
from mxnet_tpu_torch.ops import cuda_kernels  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402
from mxnet_tpu_torch.serve import (Batcher, InferenceEngine,  # noqa: E402
                                   ModelRegistry)

torch.set_num_threads(1)

T = 16                          # tokens an item
VOCAB = 1000                    # bert_small's
BUCKETS = (1, 2, 4)
TOL = 1e-5                      # of the largest logit


@pytest.fixture(autouse=True, scope="module")
def _pallas_interpret():
    """The reference's Pallas softmax and LayerNorm run in interpret
    mode (they would fall back to jnp on a host without a TPU)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpk, "_FORCE_INTERPRET", True)
    yield
    mp.undo()


def bert_weights(names_shapes, seed):
    """Seeded numpy weights by name: embeddings of unit scale, dense
    weights ``N(0, 1/fan_in)`` (attention scores of unit scale, so the
    softmax is far from uniform), LayerNorm γ near 1, small β and
    biases."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in names_shapes:
        leaf = name.rsplit(".", 1)[-1]
        if "embed" in name:
            a = rs.randn(*shape)
        elif leaf == "weight":
            a = rs.randn(*shape) / np.sqrt(shape[1])
        elif leaf == "gamma":
            a = 1 + 0.1 * rs.randn(*shape)
        else:                           # beta, bias
            a = 0.1 * rs.randn(*shape)
        out[name] = a.astype(np.float32)
    return out


def _tokens(n, seed=0, t=T):
    return np.random.RandomState(seed).randint(0, VOCAB, (n, t)).astype(
        np.int32)


@pytest.fixture(scope="module")
def nets():
    """The reference's bert_small with seeded numpy weights, and the
    arrays."""
    jnet = jbert.bert_small()
    jnet.initialize()
    jnet(mx.np.array(_tokens(1)))
    params = jnet.collect_params()
    arrays = bert_weights([(k, p.shape) for k, p in params.items()], 31)
    for k, p in params.items():
        p.set_data(mx.np.array(arrays[k])._data)
    return jnet, arrays


def _port(arrays):
    net = tbert.bert_small()
    tgluon.load_numpy(net, arrays)
    return net


def _ref(jnet, tokens, token_types=None, mask=None):
    args = [mx.np.array(tokens)]
    kw = {}
    if token_types is not None:
        kw["token_types"] = mx.np.array(token_types)
    if mask is not None:
        kw["mask"] = mx.np.array(mask)
    return np.asarray(jnet(*args, **kw)._data)


def _close(out, ref):
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    assert np.abs(out - ref).max() <= TOL * np.abs(ref).max()


def _counters():
    return dict(ttel.raw_snapshot()["counters"])


# ------------------------------------------------------------------ model
def _declared(net):
    """{dotted name: declared shape} of the port's net (0 = deferred)."""
    return {f"{mod_name}.{leaf}" if mod_name else leaf: spec.shape
            for mod_name, mod in net.named_modules()
            for leaf, spec in getattr(mod, "_specs", {}).items()}


def test_bert_small_params_match_reference_names_and_shapes(nets):
    jnet, arrays = nets
    net = _port(arrays)
    got = {k: tuple(t.shape) for k, t in net.collect_params().items()}
    want = {k: tuple(p.shape) for k, p in jnet.collect_params().items()}
    assert got == want and len(got) == 31
    assert list(net.collect_params()) == list(jnet.collect_params())


def test_bert_base_declares_the_reference_names_and_shapes():
    """Full width (vocab 30522, 768 x 12, FFN 3072, 512 positions):
    the same names and declared shapes (deferred input widths 0) as the
    reference, before any weight is made."""
    net = tbert.bert_12_768_12()
    want = {k: tuple(p.shape)
            for k, p in jbert.bert_12_768_12().collect_params().items()}
    assert _declared(net) == want and len(want) == 151
    assert want["encoder.word_embed.weight"] == (30522, 768)
    assert want["encoder.layer11.ffn_in.bias"] == (3072,)
    assert want["decoder.bias"] == (30522,)


@pytest.mark.parametrize("with_types,with_mask", [
    (False, False), (True, False), (False, True), (True, True)])
def test_logits_match_reference(nets, with_types, with_mask):
    jnet, arrays = nets
    net = _port(arrays)
    tokens = _tokens(3, seed=1)
    rs = np.random.RandomState(2)
    types = rs.randint(0, 2, tokens.shape).astype(np.int32) \
        if with_types else None
    mask = None
    if with_mask:
        mask = (rs.rand(*tokens.shape) > 0.3).astype(np.float32)
        mask[1] = 0.0                       # a sequence masked everywhere
    out = net(torch.from_numpy(tokens),
              None if types is None else torch.from_numpy(types),
              None if mask is None else torch.from_numpy(mask))
    assert out.dtype == torch.float32
    _close(out.detach().numpy(), _ref(jnet, tokens, types, mask))


def test_params_files_cross_both_ways(nets, tmp_path):
    jnet, arrays = nets
    tokens = _tokens(2, seed=3)
    ref = _ref(jnet, tokens)
    jpath = str(tmp_path / "ref.params")
    jnet.save_parameters(jpath)
    net = tbert.bert_small()
    net.load_parameters(jpath)
    _close(net(torch.from_numpy(tokens)).detach().numpy(), ref)
    tpath = str(tmp_path / "port.params")
    net.save_parameters(tpath)
    back = jbert.bert_small()
    back.load_parameters(tpath)
    _close(_ref(back, tokens), ref)


def test_fresh_net_initializes_and_resolves_deferred_shapes():
    net = tbert.bert_small()
    net.initialize(seed=4, ctx="cpu")
    out = net(torch.from_numpy(_tokens(2, seed=4)))
    assert out.shape == (2, T, VOCAB) and torch.isfinite(out).all()
    w = net.encoder.word_embed.weight
    assert abs(float(w.detach().std()) - 0.02) < 0.002   # Normal(0.02)
    assert net.encoder.layer0.attention.qkv.weight.shape == (192, 64)


def test_forward_runs_one_softmax_and_layernorm_per_site(nets):
    """bert_small: 2 attention softmaxes and 1 + 2*2 LayerNorms a
    forward, each through the kernel wrappers (plain versions on the
    CPU, so no launches are counted)."""
    net = _port(nets[1])
    calls = {"softmax": 0, "layernorm": 0}
    orig_sm, orig_ln = (cuda_kernels.softmax_plain,
                        cuda_kernels.layernorm_plain)

    def sm(x):
        calls["softmax"] += 1
        return orig_sm(x)

    def ln(*a, **k):
        calls["layernorm"] += 1
        return orig_ln(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(cuda_kernels, "softmax_plain", sm)
    mp.setattr(cuda_kernels, "layernorm_plain", ln)
    before = (cuda_kernels.softmax_fused.launches,
              cuda_kernels.layernorm_fused.launches)
    try:
        with torch.inference_mode():
            net(torch.from_numpy(_tokens(2)))
    finally:
        mp.undo()
    assert calls == {"softmax": 2, "layernorm": 5}
    assert (cuda_kernels.softmax_fused.launches,
            cuda_kernels.layernorm_fused.launches) == before


# ----------------------------------------------------------------- engine
def test_engine_matches_reference_engine_per_bucket(nets):
    jnet, arrays = nets
    jeng = JEngine(jnet, (T,), dtype="int32", buckets=BUCKETS,
                   name="jbert").warmup()
    teng = InferenceEngine(_port(arrays), (T,), dtype="int32",
                           buckets=BUCKETS, name="tbert",
                           device="cpu").warmup()
    assert teng.dtype == np.int32 and teng.stats()["dtype"] == "int32"
    for b in BUCKETS:
        x = _tokens(b, seed=10 + b)
        out = teng.run(x)
        assert len(out) == 1 and out[0].shape == (b, T, VOCAB)
        _close(out[0].numpy(), np.asarray(jeng.run(x)[0]))
    ts = teng.stats()
    assert ts["programs"] == len(BUCKETS) and ts["retraces"] == 0


def test_engine_casts_items_to_its_dtype_and_refuses_others(nets):
    net = _port(nets[1])
    seen = []
    net.register_forward_pre_hook(lambda m, a: seen.append(a[0].dtype))
    eng = InferenceEngine(net, (T,), dtype="int64", buckets=(1,),
                          device="cpu").warmup()
    eng.run(_tokens(1).astype(np.float64))
    assert seen == [torch.int64, torch.int64]       # warmup, run
    for bad in ("float16", "uint8", "bfloat16"):
        with pytest.raises(TypeError):
            InferenceEngine(_port(nets[1]), (T,), dtype=bad, device="cpu")


def test_engine_resolves_deferred_shapes_on_integer_zeros():
    net = tbert.bert_small()
    net.initialize(seed=5, ctx="cpu")
    eng = InferenceEngine(net, (T,), dtype="int32", buckets=(2,),
                          device="cpu").warmup()
    assert eng.run(_tokens(2))[0].shape == (2, T, VOCAB)


def test_no_card_and_no_device_raises(nets, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(_port(nets[1]), (T,), dtype="int32")
    path = str(tmp_path / "bert.params")
    _port(nets[1]).save_parameters(path)
    with ModelRegistry() as reg:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            reg.load("bert", path, net=tbert.bert_small(), item_shape=(T,),
                     dtype="int32")


# ---------------------------------------------------------------- batcher
def test_batcher_pads_and_splits_int32_items(nets):
    jnet, arrays = nets
    eng = InferenceEngine(_port(arrays), (T,), dtype="int32",
                          buckets=BUCKETS, device="cpu").warmup()
    batches = []
    orig = eng.run

    def run(x):
        batches.append(np.array(x))
        return orig(x)

    eng.run = run
    xs = _tokens(3, seed=6)
    before = _counters()
    with Batcher(eng, max_wait_ms=2000) as bat:
        reqs = [bat.submit_async(xs[0]), bat.submit_async(xs[1:])]
        for r in reqs:
            assert r.event.wait(60) and r.error is None
    assert _counters().get("serve.padded", 0) - \
        before.get("serve.padded", 0) == 1          # 3 items → bucket 4
    assert len(batches) == 1 and batches[0].dtype == np.int32
    np.testing.assert_array_equal(batches[0][:3], xs)
    np.testing.assert_array_equal(batches[0][3], np.zeros(T, np.int32))
    assert reqs[0].result[0].shape == (1, T, VOCAB)
    assert reqs[1].result[0].shape == (2, T, VOCAB)
    got = np.concatenate([reqs[0].result[0], reqs[1].result[0]])
    _close(got, _ref(jnet, xs))
    for i in range(3):      # each row against its unbatched forward
        _close(got[i:i + 1], orig(xs[i:i + 1])[0].numpy())


# --------------------------------------------------------------- registry
def test_registry_loads_a_reference_params_file(nets, tmp_path):
    jnet = nets[0]
    path = str(tmp_path / "bert.params")
    jnet.save_parameters(path)
    x = _tokens(1, seed=7)[0]
    with ModelRegistry(buckets=(1, 2), device="cpu") as reg:
        entry = reg.load("bert", path, net=tbert.bert_small(),
                         item_shape=(T,), dtype="int32")
        assert entry.engine.ready and entry.engine.dtype == np.int32
        assert reg.stats()["models"]["bert"]["dtype"] == "int32"
        out = reg.predict("bert", x, timeout=60)
    _close(out[0], _ref(jnet, x[None]))


# ------------------------------------------------------------ gluon blocks
def _jarr(a):
    return mx.np.array(a)


def _jout(y):
    return np.asarray(y._data)


@pytest.mark.parametrize("shape,axis", [((3, 5, 64), -1), ((4, 768), -1),
                                        ((2, 6, 6), 1)])
def test_layernorm_block_matches_reference(shape, axis):
    """Against the reference's block on the same numpy γ, β and input,
    within 1e-5; over a middle axis the reference normalizes along it and
    scales by γ along the last axis (the two lengths agree here)."""
    rs = np.random.RandomState(8)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    c = shape[axis]
    g = (1 + 0.1 * rs.randn(c)).astype(np.float32)
    b = (0.1 * rs.randn(c)).astype(np.float32)
    tl = tgnn.LayerNorm(axis=axis, epsilon=1e-5)
    tl.initialize(ctx="cpu")
    tgluon.load_numpy(tl, {"gamma": g, "beta": b})
    out = tl(torch.from_numpy(x)).detach().numpy()
    jl = jgnn.LayerNorm(axis=axis, epsilon=1e-5)
    jl.initialize()
    jl(_jarr(x))
    jl.gamma.set_data(_jarr(g)._data)
    jl.beta.set_data(_jarr(b)._data)
    ref = _jout(jl(_jarr(x)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    # deferred: gamma/beta took the input's length
    assert tuple(tl.gamma.shape) == (c,)


def test_layernorm_middle_axis_raises_where_the_reference_does():
    """γ of the normalized axis's length (6) against a last axis of 3:
    the reference's broadcast fails, and so does the port's."""
    x = np.random.RandomState(8).randn(2, 6, 3).astype(np.float32)
    g, b = np.ones(6, np.float32), np.zeros(6, np.float32)
    with pytest.raises(Exception):
        jnn.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                       axis=1)
    with pytest.raises(RuntimeError):
        tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                       torch.from_numpy(b), axis=1)


@pytest.mark.parametrize("shape,axis", [((4, 768), -1), ((4, 768), 0),
                                        ((2, 6, 768), 1)])
def test_layer_norm_bf16_matches_reference(shape, axis):
    """A bf16 input takes the reference's closed form on every axis:
    fp32 statistics, the normalized value cast back to bf16, then
    ``· γ + β``.  With bf16 γ and β (a bf16 model's) the output is bf16
    and equal to the reference bit for bit; with fp32 γ and β it is fp32
    and within 1e-6 (XLA contracts the scale and shift into one FMA,
    torch rounds twice)."""
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    g = (1 + 0.5 * rs.randn(shape[-1])).astype(np.float32)
    b = (0.5 * rs.randn(shape[-1])).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    for gdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        ref = jnn.layer_norm(jx, jnp.asarray(g, dtype=jdt),
                             jnp.asarray(b, dtype=jdt), axis=axis)
        out = tnn.layer_norm(tx, torch.from_numpy(g).to(gdt),
                             torch.from_numpy(b).to(gdt), axis=axis)
        assert out.dtype == gdt and str(ref.dtype) == str(gdt)[6:]
        ref = np.asarray(ref.astype(jnp.float32))
        if gdt == torch.bfloat16:
            np.testing.assert_array_equal(out.float().numpy(), ref)
        else:
            np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6,
                                       atol=1e-6)


SOFTMAX_HALF_CASES = [((4, 768), -1), ((4, 768), 0), ((2, 3, 512), -1),
                      ((2, 3, 512), 0), ((2, 3, 512), 1), ((8, 30522), -1),
                      ((8, 30522), 0)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape,axis", SOFTMAX_HALF_CASES, ids=str)
def test_softmax_half_matches_reference(shape, axis, dtype):
    """A bf16 or fp16 softmax takes the reference's closed form on every
    axis and equals the reference's public ``ops.nn.softmax`` (jitted by
    the dispatch cache; on the last axis its Pallas kernel in interpret
    mode) bit for bit: for bf16, ``exp`` kept in fp32, summed in fp32,
    the sum and the numerator rounded to bf16 before the divide."""
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 4).astype(np.float32)
    ref = jnn.softmax(jnp.asarray(x, dtype=getattr(jnp, dtype)), axis=axis)
    out = tnn.softmax(torch.from_numpy(x).to(getattr(torch, dtype)),
                      axis=axis)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_softmax_half_never_reaches_the_fp32_kernel(monkeypatch):
    """A bf16 softmax over the last axis reaches the kernel's wrapper
    with its bf16 tensor (the kernel's bf16 instance: never widened to
    the fp32 one), recording or not; over another axis it takes the
    closed form and does not reach it; an fp32 last-axis call reaches it
    as fp32."""
    calls = []

    def fused(x):
        calls.append(x.dtype)
        return cuda_kernels.softmax_plain(x)

    monkeypatch.setattr(tnn, "softmax_fused", fused)
    monkeypatch.setattr(cuda_kernels, "softmax_fused", fused)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 64)
                         .astype(np.float32))
    for axis in (-1, 0):
        tnn.softmax(x.bfloat16(), axis=axis)
        tnn.softmax(x.bfloat16().requires_grad_(), axis=axis).sum()\
            .backward()
    assert calls == [torch.bfloat16, torch.bfloat16]
    tnn.softmax(x)
    assert calls[2:] == [torch.float32]


def test_embedding_block_matches_reference():
    rs = np.random.RandomState(9)
    w = rs.randn(50, 12).astype(np.float32)
    ids = rs.randint(0, 50, (3, 7)).astype(np.int32)
    te = tgnn.Embedding(50, 12)
    te.initialize(ctx="cpu")
    tgluon.load_numpy(te, {"weight": w})
    je = jgnn.Embedding(50, 12)
    je.initialize()
    je.weight.set_data(_jarr(w)._data)
    ref = _jout(je(_jarr(ids)))
    for dt in (torch.int32, torch.int64):
        out = te(torch.from_numpy(ids).to(dt)).detach().numpy()
        np.testing.assert_array_equal(out, ref)
    assert dict(te.collect_params()).keys() == {"weight"}
    # sparse_grad marks the weight for the lazy update; the forward is
    # the same gather
    ts = tgnn.Embedding(50, 12, sparse_grad=True)
    ts.initialize(ctx="cpu")
    tgluon.load_numpy(ts, {"weight": w})
    assert ts.weight.grad_stype == "row_sparse"
    np.testing.assert_array_equal(ts(torch.from_numpy(ids)).detach().numpy(),
                                  ref)
    with pytest.raises(TypeError):
        tgnn.Embedding(50, 12, dtype="int32")
    # a float16 table, as the reference builds one
    th = tgnn.Embedding(50, 12, dtype="float16")
    th.initialize(ctx="cpu")
    tgluon.load_numpy(th, {"weight": w})
    jh = jgnn.Embedding(50, 12, dtype="float16")
    jh.initialize()
    jh.weight.set_data(_jarr(w.astype(np.float16))._data)
    out = th(torch.from_numpy(ids))
    assert out.dtype == torch.float16
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  _jout(jh(_jarr(ids))).astype(np.float32))


def test_embedding_out_of_range_ids_match_reference():
    """``jnp.take``'s fill mode: ids in [-n, 0) wrap to row n + id, ids
    outside [-n, n) give NaN rows; the port gives the same rows
    (NaN where the reference has NaN)."""
    rs = np.random.RandomState(10)
    w = rs.randn(3, 4).astype(np.float32)
    ids = np.array([[0, 3, -1], [-3, -4, 7]], np.int32)
    ref = np.asarray(jnn.embedding(jnp.asarray(ids), jnp.asarray(w)))
    for dt in (torch.int32, torch.int64):
        out = tnn.embedding(torch.from_numpy(ids).to(dt),
                            torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(out, ref)
    assert np.isnan(ref[0, 1]).all() and (ref[0, 2] == w[2]).all()


@pytest.mark.parametrize("approximation", ["erf", "tanh"])
def test_gelu_block_matches_reference(approximation):
    x = np.linspace(-5, 5, 101).astype(np.float32)
    ref = _jout(jgnn.GELU(approximation=approximation)(_jarr(x)))
    out = tgnn.GELU(approximation=approximation)(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


def test_gelu_erf_and_tanh_differ():
    x = torch.linspace(-3, 3, 61)
    d = (tgnn.GELU()(x) - tgnn.GELU(approximation="tanh")(x)).abs().max()
    assert 1e-4 < float(d) < 1e-3


def test_dropout_block_identity_in_inference_and_seeded_in_training():
    x = torch.ones(200, 50)
    d = tgnn.Dropout(0.25)
    assert d(x) is x                                # inference mode
    d.train()
    a = d(x)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    np.testing.assert_allclose(a[a != 0].numpy(), 1 / 0.75, rtol=1e-6)
    b = tgnn.Dropout(0.25, generator=torch.Generator().manual_seed(0))
    b.train()
    c = tgnn.Dropout(0.25).train()                  # mx.random's, seeded 0
    from mxnet_tpu_torch import random as trandom
    trandom.seed(0)
    assert torch.equal(b(x), c(x))                  # same seed, same mask
    assert not torch.equal(b(x), b(x))              # the stream advances
    assert tgnn.Dropout(0.0).train()(x) is x


# ------------------------------------------------------------ initializers
def test_constant_initializer_is_exact_and_registered():
    t = tinit.Constant(0.25)((3, 4), torch.Generator().manual_seed(0))
    assert t.dtype == torch.float32 and torch.equal(t, torch.full((3, 4),
                                                                  0.25))
    assert isinstance(tinit.create("constant", value=2.0), tinit.Constant)
    assert torch.equal(tinit.create("constant", value=2.0)((2,), None),
                       torch.full((2,), 2.0))


def test_normal_initializer_std_and_seed():
    n = tinit.Normal(0.02)
    t = n((100000,), torch.Generator().manual_seed(1))
    assert abs(float(t.std()) - 0.02) <= 0.05 * 0.02
    assert abs(float(t.mean())) < 0.02 * 0.02
    again = n((100000,), torch.Generator().manual_seed(1))
    other = n((100000,), torch.Generator().manual_seed(2))
    assert torch.equal(t, again) and not torch.equal(t, other)
    assert tinit.create("normal").sigma == 0.01     # the reference default


def test_card_bf16_gate_holds_a_quotient_to_its_own_devices_sum():
    """``chip_smoke``'s bf16 softmax gate: a column whose fp32 sum rounds
    to 1.0 on one device and one step above on the other moves its
    largest value from 1.0 to 0.9921875, two bf16 steps.  The gate holds
    each value to one step of the quotient over either device's rounded
    sum, so that column passes, and a value two steps off both quotients
    still fails."""
    import chip_smoke
    x = torch.tensor([[0.0], [-10.0], [-10.0], [-12.0]]).bfloat16()
    ref = tnn.softmax(x, axis=0)
    num, s = chip_smoke._softmax_bf16_parts(x, 0)
    assert torch.equal(num / s, ref) and s.item() == 1.0
    other = torch.tensor([[1.0078125]]).bfloat16()      # s one step up
    got = num / other
    assert chip_smoke._bf16_steps(got, ref).max().item() == 2
    assert chip_smoke._softmax_bf16_steps(got, x, 0, other).max() == 0
    bad = got.clone()
    bad.view(torch.int16)[0] -= 2
    assert chip_smoke._softmax_bf16_steps(bad, x, 0, other).max() == 2
