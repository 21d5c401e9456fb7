"""bf16 serving of the PyTorch port against the JAX package's on the CPU:
the bf16 instances' plain versions (``conv_affine_plain`` against the
reference's fused Pallas block in interpret mode; the half softmax with
the attention's prologue against the reference's bf16 attention
softmax), whole bf16 forwards of ResNet-18 v1 at 32x32 and ``bert_small``
at T = 16 against the reference's ``amp.convert_model`` forwards, bf16
serving through ``ModelRegistry`` → ``Batcher`` → ``InferenceEngine``, the
launch routes of a bf16 forward, and what stays refused below fp32.

Tolerances.  One bf16 step of a value v is 2^(floor(log2 |v|) - 7): 0.39%
to 0.78% of it.  A kernel's plain version and the reference's kernel sum
the same exact products in fp32 in another order, so each value may
round to a neighbouring bf16 value: one step.  A whole ResNet forward
compounds such flips (each conv rounds ~0.01-0.06% of its outputs to
the neighbouring value, the next layers carry them), so its logits are
held to three steps of the largest logit, and to less than the
reference's own bf16-against-fp32 distance on the same weights and
image, with top-1 equal; the reference's rounding of each fused segment
is its kernel's (forced Pallas route), or, on its layer route, a rounding
after each of conv, BatchNorm, add.  bert_small rounds where the
reference rounds at every step: within 0.5% of the largest logit."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import amp as jamp  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.models import bert_gluon as jbert  # noqa: E402
from mxnet_tpu.ops import nn as jnn  # noqa: E402
from mxnet_tpu.ops import pallas_block as jpb  # noqa: E402
from mxnet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import models as tmodels  # noqa: E402
from mxnet_tpu_torch import telemetry as ttel  # noqa: E402
from mxnet_tpu_torch.models import bert_gluon as tbert  # noqa: E402
from mxnet_tpu_torch.ops import conv_block, cuda_kernels  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402
from mxnet_tpu_torch.serve import InferenceEngine, ModelRegistry  # noqa
from test_torch_bert_gluon import bert_weights  # noqa: E402
from test_torch_image_serve import _tiny  # noqa: E402
from test_torch_kernels import CONV_CASES, _FakeCuda, _conv_data  # noqa
from test_torch_resnet import port_net, reference_net, weights_for  # noqa
from mxnet_tpu.models.resnet import BasicBlockV1 as JBasic  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tgnn  # noqa: E402
from mxnet_tpu_torch.models.resnet import BasicBlockV1 as TBasic  # noqa

torch.set_num_threads(1)

T = 16
VOCAB = 1000
LOGIT_STEPS = 3         # ResNet logits: bf16 steps of the largest
BERT_TOL = 5e-3         # bert_small logits: of the largest
FORCED = "8x8x64=pallas,4x4x128=pallas,2x2x256=pallas,1x1x512=pallas"


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    """The reference's Pallas softmax and LayerNorm run in interpret
    mode (they would fall back to jnp on a host without a TPU)."""
    monkeypatch.setattr(jpk, "_FORCE_INTERPRET", True)


def _step(v):
    """One bf16 step at each |v| (v != 0)."""
    return 2.0 ** (np.floor(np.log2(np.abs(v))) - 7)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


def _j16(a):
    return None if a is None else jnp.asarray(a, jnp.bfloat16)


def _np(t):
    return np.asarray(t._data.astype(jnp.float32)) if hasattr(t, "_data") \
        else np.asarray(t.astype(jnp.float32))


# ---------------------------------------------------- the kernels' plain
@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv_affine_plain_bf16_matches_reference_kernel(case, monkeypatch):
    """bf16 ``conv_affine_plain`` (widened to fp32, conv in fp32, the
    fold in fp32, one rounding) against the reference's
    ``residual_block_fused(frozen=True)`` on bf16 operands, its Pallas
    kernel in interpret mode: each value within one bf16 step."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
    N, H, W, C, Cout, res, relu = case
    monkeypatch.setenv("MXNET_TPU_PALLAS_STAGES", f"{H}x{W}x{C}=pallas")
    data = _conv_data(np.random.RandomState(7), N, H, W, C, Cout, res)
    ref = jpb.residual_block_fused(*(_j16(a) for a in data), eps=1e-5,
                                   frozen=True, relu=relu)[0]
    assert ref.dtype == jnp.bfloat16
    out = conv_block.conv_affine(*(None if a is None else _bf16(a)
                                   for a in data), eps=1e-5, relu=relu)
    assert out.dtype == torch.bfloat16 and out.shape == (N, H, W, Cout)
    ref, got = _np(ref), out.float().numpy()
    nz = ref != 0
    assert (np.abs(got - ref)[nz] <= _step(ref[nz])).all()
    assert (got[~nz] == 0).all() or not relu


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("hd,masked", [(16, True), (64, False), (48, True)])
def test_half_softmax_with_prologue_matches_reference(dtype, hd, masked):
    """The kernel's function on half-precision scores (its plain version
    on the CPU): ``where(mask, scores / sqrt(hd), -1e9)`` and the
    softmax, rounded where the reference's bf16 attention rounds, its
    Pallas softmax in interpret mode: equal bit for bit."""
    B, H = 2, 4
    rs = np.random.RandomState(hd)
    x = (rs.randn(B, H, T, T) * 3 * np.sqrt(hd)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    if masked:
        mask[1, 10:] = 0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    scores = jnp.asarray(x, jdt) / math.sqrt(hd)     # a weak constant
    if masked:
        scores = jnp.where(jnp.asarray(mask).reshape(B, 1, 1, T), scores,
                           -1e9)
    ref = jnn.softmax(scores, axis=-1)
    keep = torch.from_numpy(mask) != 0 if masked else None
    out = cuda_kernels.softmax_fused(torch.from_numpy(x).to(tdt),
                                     div=math.sqrt(hd), keep=keep)
    assert out.dtype == tdt and ref.dtype == jdt
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


# ----------------------------------------------------------- whole models
@pytest.mark.parametrize("route", ["layer", "forced_pallas"])
def test_resnet18_bf16_forward_matches_reference(route, monkeypatch):
    """ResNet-18 v1 at 32x32, the port cast by ``Block.cast`` against the
    reference after ``amp.convert_model``, on the same seeded weights and
    image (see the module's note on the tolerance)."""
    if route == "forced_pallas":
        monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
        monkeypatch.setenv("MXNET_TPU_PALLAS_STAGES", FORCED)
    img = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    jnet, arrays = reference_net("resnet18_v1", seed=1, classes=10)
    ref32 = np.asarray(jnet(mx.np.array(img))._data)
    jamp.convert_model(jnet, "bfloat16")
    ref = _np(jnet(mx.np.array(jnp.asarray(img, jnp.bfloat16))))
    tnet = port_net("resnet18_v1", arrays, classes=10)
    tnet.cast("bfloat16")
    with torch.inference_mode():
        out = tnet(_bf16(img))
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    top = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert np.isfinite(got).all()
    assert err <= LOGIT_STEPS * _step(top), (err, _step(top))
    assert err < np.abs(ref - ref32).max()
    assert (got.argmax(-1) == ref.argmax(-1)).all()


def _bert_pair(seed=31):
    jnet = jbert.bert_small()
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1, T), np.int32)))
    params = jnet.collect_params()
    arrays = bert_weights([(k, p.shape) for k, p in params.items()], seed)
    for k, p in params.items():
        p.set_data(mx.np.array(arrays[k])._data)
    tnet = tbert.bert_small()
    tgluon.load_numpy(tnet, arrays)
    return jnet, tnet, arrays


def _tokens(n, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (n, T)).astype(
        np.int32)


def test_bert_small_bf16_forward_matches_reference():
    """bert_small at T = 16 with a key mask, cast to bf16 on both sides:
    logits within 0.5% of the largest, the same top-1 everywhere, and
    the port's bf16 no farther from the reference's than the reference's
    bf16 is from its fp32."""
    jnet, tnet, _ = _bert_pair()
    tok = _tokens(2, seed=4)
    mask = np.ones((2, T), np.int32)
    mask[1, 11:] = 0
    ref32 = np.asarray(jnet(mx.np.array(tok), None,
                            mx.np.array(mask))._data)
    jamp.convert_model(jnet, "bfloat16")
    ref = _np(jnet(mx.np.array(tok), None, mx.np.array(mask)))
    tnet.cast("bfloat16")
    with torch.inference_mode():
        out = tnet(torch.from_numpy(tok), None, torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    err = np.abs(got - ref).max()
    assert err <= BERT_TOL * np.abs(ref).max()
    assert err <= np.abs(ref - ref32).max()
    assert (got.argmax(-1) == ref.argmax(-1)).all()


# -------------------------------------------------------------- serving
def _counters():
    return dict(ttel.raw_snapshot()["counters"])


def _tiny_reference(seed):
    """The image serving tests' tiny ResNet in the reference, with seeded
    numpy weights (``test_torch_resnet.weights_for``)."""
    jnet = _tiny(jgnn, JBasic)
    jnet.initialize()
    jnet(mx.np.array(np.zeros((1, 8, 8, 3), np.float32)))
    params = jnet.collect_params()
    arrays = weights_for([(k, p.shape) for k, p in params.items()], seed)
    for k, p in params.items():
        p.set_data(mx.np.array(arrays[k])._data)
    return jnet


def test_bf16_serving_through_the_registry_matches_reference(tmp_path):
    """A tiny ResNet on float images and bert_small on int32 tokens,
    loaded from fp32 ``.params`` files by ``ModelRegistry(precision=
    "bf16")`` and served through the Batcher, against the reference's
    eager forward after ``amp.convert_model`` on the same weights:
    images within three bf16 steps of the largest logit (the module's
    note), tokens within 0.5%; float items reach the net as bf16, integer
    items stay int32; the bf16 counters move.  (The reference's own
    ``InferenceEngine(precision="bf16")`` jits the forward, and XLA's
    fusions there skip some of the per-op roundings of its eager
    forward, which the port follows: on bert_small its engine and its
    eager forward are 1.1% of the largest logit apart.)"""
    jimg = _tiny_reference(40)
    img_path = str(tmp_path / "img.params")
    jimg.save_parameters(img_path)
    jtxt, _, _ = _bert_pair(7)
    txt_path = str(tmp_path / "txt.params")
    jtxt.save_parameters(txt_path)
    images = np.random.RandomState(1).randn(2, 8, 8, 3).astype(np.float32)
    tokens = _tokens(1, seed=2)
    before = _counters()
    with ModelRegistry(buckets=(1, 2), device="cpu",
                       precision="bf16") as reg:
        ie = reg.load("img", img_path, net=_tiny(tgnn, TBasic),
                      item_shape=(8, 8, 3))
        te = reg.load("txt", txt_path, net=tbert.bert_small(),
                      item_shape=(T,), dtype="int32")
        st = reg.stats()["models"]
        assert st["img"]["dtype"] == "bfloat16"
        assert st["txt"]["dtype"] == "int32"
        assert st["img"]["precision"] == st["txt"]["precision"] == "bf16"
        seen = []
        ie.net.register_forward_pre_hook(
            lambda m, a: seen.append(a[0].dtype))
        img_out = reg.predict("img", images, timeout=60)[0]
        txt_out = reg.predict("txt", tokens[0], timeout=60)[0]
        assert seen == [torch.bfloat16]
        assert te.engine.net.encoder.word_embed.weight.dtype == \
            torch.bfloat16
    after = _counters()
    assert after.get("serve.precision.builds.bf16", 0) - \
        before.get("serve.precision.builds.bf16", 0) == 2
    assert after.get("serve.precision.batches.bf16", 0) > \
        before.get("serve.precision.batches.bf16", 0)
    assert img_out.dtype == np.float32 and txt_out.dtype == np.float32
    for jnet in (jimg, jtxt):
        jamp.convert_model(jnet, "bfloat16")
    ref = _np(jimg(mx.np.array(jnp.asarray(images, jnp.bfloat16))))
    top = np.abs(ref).max()
    assert np.abs(img_out - ref).max() <= LOGIT_STEPS * _step(top)
    ref = _np(jtxt(mx.np.array(tokens)))[0]
    assert np.abs(txt_out - ref).max() <= BERT_TOL * np.abs(ref).max()


def test_bf16_engine_batches_match_unbatched():
    """Each row of a bf16 bucket equals the forward of its item alone
    (the CPU's plain versions take each row the same way)."""
    jimg = _tiny_reference(41)
    net = _tiny(tgnn, TBasic)
    tgluon.load_numpy(net, {k: np.asarray(p.data()._data)
                            for k, p in jimg.collect_params().items()})
    eng = InferenceEngine(net, (8, 8, 3), buckets=(1, 4), device="cpu",
                          precision="bf16").warmup()
    x = np.random.RandomState(2).randn(4, 8, 8, 3).astype(np.float32)
    batched = eng.run(x)[0]
    for i in range(4):
        assert torch.equal(batched[i:i + 1], eng.run(x[i:i + 1])[0])


# ---------------------------------------------------------- routes, refusals
def _counting(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(x, *a, **k):
        calls.append((x.dtype, k.get("div"), k.get("keep") is not None))
        return real(x, *a, **k)

    monkeypatch.setattr(module, name, counted)


def test_bf16_forwards_take_the_half_kernels(monkeypatch):
    """A bf16 ResNet-50 v1 forward reaches ``conv_affine`` 16 times, each
    with bf16 operands; a bf16 bert_small forward with a key mask reaches
    ``softmax_fused`` once a layer with bf16 scores, the scale and the
    mask as its prologue (on the card: the kernels' bf16 instances)."""
    calls = []
    _counting(monkeypatch, conv_block, "conv_affine", calls)
    net = tmodels.get_model("resnet50_v1", classes=10)
    net.initialize(seed=0, ctx="cpu")
    net.cast("bfloat16")
    with torch.inference_mode():
        net(torch.zeros(1, 32, 32, 3, dtype=torch.bfloat16))
    assert [c[0] for c in calls] == [torch.bfloat16] * 16
    from mxnet_tpu_torch.models import bert_gluon
    soft = []
    _counting(monkeypatch, bert_gluon, "softmax_fused", soft)
    _, tnet, _ = _bert_pair()
    tnet.cast("bfloat16")
    with torch.inference_mode():
        tnet(torch.from_numpy(_tokens(2)), None, torch.ones(2, T))
    assert soft == [(torch.bfloat16, 4.0, True)] * 2


def test_what_stays_refused_below_fp32():
    """A float64 ``conv_affine`` on the card raises ``TypeError`` naming
    the dtypes its instances take (fp16, refused here until the fp16
    training slice, now has its instances: ``test_torch_fp16_kernels``);
    the softmax kernel takes no integer scores; float64 still trains on
    the CPU (the float64 floor of the card checks).  bf16 training
    BatchNorm and a bf16 fused segment under autograd, refused here until
    the bf16 training slice, now run (``test_torch_bf16_train_kernels``)."""
    x = torch.zeros(1, 4, 4, 8, dtype=torch.float64)
    w = torch.zeros(3, 3, 8, 8, dtype=torch.float64)
    v = torch.ones(8, dtype=torch.float64)
    with pytest.raises(TypeError, match="float16"):
        conv_block.conv_affine(_FakeCuda(x), _FakeCuda(w), *(_FakeCuda(v),)
                               * 4)
    with pytest.raises(TypeError):
        cuda_kernels.softmax_fused(_FakeCuda(torch.zeros(4, 8,
                                                         dtype=torch.int32)))
    xb = torch.randn(2, 4, 4, 8).bfloat16()
    # float64 still trains (the CPU's float64 floor in the card checks)
    v64 = torch.ones(8, dtype=torch.float64)
    out, _, _ = tnn.residual_block(
        xb.double(), torch.zeros(3, 3, 8, 8, dtype=torch.float64)
        .requires_grad_(), v64, v64, v64, v64, training=True)
    assert out.dtype == torch.float64
