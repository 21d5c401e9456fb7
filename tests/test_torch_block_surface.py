"""The Block surface of the PyTorch port (``gluon/block.py``,
``gluon/parameter.py``) against the JAX package's on the CPU:
``summary`` text, ``flops`` counts, ``cast`` (before and after the first
forward), ``.params`` round trips of cast nets in both directions,
``zero_grad``, ``reset_ctx``, ``params``, the reference's accepted
arguments, and the entry points that need the symbol graph."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import models as jmodels  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.models import bert_gluon as jbert  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import models as tmodels  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tgnn  # noqa: E402
from mxnet_tpu_torch.gluon.block import SymbolBlock  # noqa: E402
from mxnet_tpu_torch.models import bert_gluon as tbert  # noqa: E402
from mxnet_tpu_torch.ops import conv_block  # noqa: E402

torch.set_num_threads(1)


def _mlp(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
    return net


def _bn_net(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(8), nn.BatchNorm(), nn.Dense(3))
    return net


# (name, builder of (reference net, port net), example input)
CASES = {
    "mlp": (lambda: (_mlp(jgnn), _mlp(tgnn)),
            np.zeros((8, 6), np.float32)),
    "resnet18_v1": (lambda: (jmodels.get_model("resnet18_v1", classes=10),
                             tmodels.get_model("resnet18_v1", classes=10)),
                    np.zeros((2, 32, 32, 3), np.float32)),
    "bert_small": (lambda: (jbert.bert_small(), tbert.bert_small()),
                   np.zeros((2, 16), np.int32)),
}


def _pair(name):
    """The reference net and the port's, both after one forward on the
    case's input (deferred shapes resolved), with the same weights."""
    build, x = CASES[name]
    jnet, tnet = build()
    jnet.initialize()
    jnet(mx.np.array(x))
    tgluon.load_numpy(tnet, {k: np.asarray(p.data()._data)
                             for k, p in jnet.collect_params().items()})
    return jnet, tnet, x


@pytest.mark.parametrize("name", list(CASES))
def test_summary_text_matches_reference(name):
    jnet, tnet, x = _pair(name)
    assert tnet.summary(torch.from_numpy(x)) == jnet.summary(mx.np.array(x))


def test_summary_of_deferred_and_cast_nets_matches_reference():
    """Before the first forward (0 dims of deferred shapes) and after a
    cast, as the reference prints them."""
    jnet, tnet = _bn_net(jgnn), _bn_net(tgnn)
    jnet.initialize()
    tnet.initialize(ctx="cpu")
    assert tnet.summary() == jnet.summary()
    jnet.cast("bfloat16")
    tnet.cast("bfloat16")
    assert tnet.summary() == jnet.summary()


@pytest.mark.parametrize("name", list(CASES))
def test_flops_match_reference(name):
    jnet, tnet, x = _pair(name)
    assert tnet.flops(torch.from_numpy(x)) == jnet.flops(mx.np.array(x))


def test_flops_compute_nothing_and_leave_the_net_as_it_was():
    """flops() runs on fake tensors: the same count for bf16 weights and
    inputs, no kernel wrapper launch counted, the parameters the same
    objects with the same values afterwards, and no count without
    example inputs or before deferred shapes are known."""
    jnet, tnet, x = _pair("resnet18_v1")
    before = {k: (t, t.detach().clone())
              for k, t in tnet.collect_params().items()}
    launches = conv_block.conv_affine.launches
    n = tnet.flops(torch.from_numpy(x))
    assert conv_block.conv_affine.launches == launches
    for k, t in tnet.collect_params().items():
        assert t is before[k][0] and torch.equal(t, before[k][1])
    tnet.cast("bfloat16")
    assert tnet.flops(torch.from_numpy(x).bfloat16()) == n
    with pytest.raises(ValueError):
        tnet.flops()
    fresh = _mlp(tgnn)
    fresh.initialize(ctx="cpu")
    with pytest.raises(tgluon.DeferredInitializationError):
        fresh.flops(torch.zeros(2, 6))


def test_cast_keeps_objects_and_integer_tensors():
    net = _bn_net(tgnn)
    net.initialize(ctx="cpu")
    net(torch.zeros(2, 5))
    net[1].register_buffer("counts", torch.arange(8, dtype=torch.int32))
    objs = {k: t for k, t in net.collect_params().items()}
    w = net[0].weight.detach().clone()
    net.cast("bfloat16")
    for k, t in net.collect_params().items():
        assert t is objs[k]
        assert t.dtype == (torch.int32 if k.endswith("counts")
                           else torch.bfloat16)
    assert torch.equal(net[0].weight.float(), w.bfloat16().float())
    assert net[1].running_var.dtype == torch.bfloat16
    assert net(torch.zeros(2, 5, dtype=torch.bfloat16)).dtype == \
        torch.bfloat16


def test_cast_before_the_first_forward_holds():
    """Deferred parameters materialize in the cast dtype (the reference's
    ``Parameter.cast`` sets the dtype they are created in), and a forced
    re-initialize keeps it."""
    net = _bn_net(tgnn)
    net.initialize(ctx="cpu")
    net.cast("bfloat16")
    out = net(torch.randn(4, 5).bfloat16())
    assert out.dtype == torch.bfloat16
    assert {t.dtype for t in net.collect_params().values()} == \
        {torch.bfloat16}
    net.initialize(ctx="cpu", force_reinit=True)
    assert {t.dtype for t in net.collect_params().values()} == \
        {torch.bfloat16}


def test_cast_save_load_round_trips(tmp_path):
    """A bf16 net saves widened to fp32 (exact) and loads back into a bf16
    net bit for bit and into an fp32 net value for value; the reference
    reads the port's file, and the port reads the reference's bf16 file
    (ml_dtypes' two-byte records) by its bits."""
    jnet, tnet, x = _pair("mlp")
    tnet.cast("bfloat16")
    path = str(tmp_path / "bf16.params")
    tnet.save_parameters(path, deduplicate=True)
    with np.load(path) as z:
        assert {z[k].dtype for k in z.files} == {np.dtype(np.float32)}
    back = _mlp(tgnn)
    back.initialize(ctx="cpu")
    back.cast("bfloat16")
    back.load_parameters(path, cast_dtype=True)
    wide = _mlp(tgnn)
    wide.load_parameters(path)
    for k, t in tnet.collect_params().items():
        assert back.collect_params()[k].dtype == torch.bfloat16
        assert torch.equal(back.collect_params()[k], t)
        assert wide.collect_params()[k].dtype == torch.float32
        assert torch.equal(wide.collect_params()[k], t.float())
    jnet.load_parameters(path)
    for k, p in jnet.collect_params().items():
        np.testing.assert_array_equal(
            np.asarray(p.data()._data),
            tnet.collect_params()[k].detach().float().numpy())
    jnet.cast("bfloat16")
    jpath = str(tmp_path / "ref_bf16.params")
    jnet.save_parameters(jpath)
    again = _mlp(tgnn)
    again.initialize(ctx="cpu")
    again.cast("bfloat16")
    again.load_parameters(jpath)
    for k, p in jnet.collect_params().items():
        np.testing.assert_array_equal(
            again.collect_params()[k].detach().float().numpy(),
            np.asarray(p.data()._data.astype(jnp.float32)))


def test_zero_grad_reset_ctx_and_params():
    jnet, tnet, x = _pair("mlp")
    out = tnet(torch.randn(8, 6)).sum()
    out.backward()
    grads = {k: t.grad for k, t in tnet.collect_params().items()}
    tnet.zero_grad()
    for k, t in tnet.collect_params().items():
        assert t.grad is grads[k] and not t.grad.any()
    objs = list(tnet.collect_params().values())
    tnet.reset_ctx("cpu")
    assert list(tnet.collect_params().values()) == objs
    tnet.collect_params().zero_grad()
    assert list(tnet[0].params) == list(jnet[0].params)
    assert list(_bn_net(tgnn)[1].params) == list(_bn_net(jgnn)[1].params)


def test_reference_arguments_are_accepted():
    net = tgnn.HybridSequential(prefix="net_", params=None)
    net.add(tgnn.Dense(4, prefix="d_"))
    net.initialize(ctx="cpu", verbose=True)
    assert net(torch.zeros(2, 3)).shape == (2, 4)


@pytest.mark.parametrize("call", ["export", "optimize_for", "symbolblock",
                                  "imports"])
def test_symbol_entry_points_raise(call, tmp_path):
    net = _mlp(tgnn)
    net.initialize(ctx="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        if call == "export":
            net.export(str(tmp_path / "net"))
        elif call == "optimize_for":
            net.optimize_for(torch.zeros(2, 6), backend="int8")
        elif call == "symbolblock":
            SymbolBlock(tgluon.ParameterDict())
        else:
            SymbolBlock.imports("net-symbol.json")
