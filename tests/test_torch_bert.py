"""Slice-level parity of the PyTorch port's BERT masked-LM path
(``mxnet_tpu_torch.models.bert``, ``mxnet_tpu_torch.optimizer`` and
``mxnet_tpu_torch.examples.bert_pretrain``) against the JAX package on
the same weights.

One numpy params tree from a seed feeds both packages.  At head dim 128
with ``pallas_kernels._FORCE_INTERPRET`` on, the JAX side runs its
Pallas flash-attention forward and backward kernels and its Pallas
LayerNorm (interpret mode); at head dim 64 it takes its jnp reference.
The port runs the plain versions of its kernels on the CPU, through the
same autograd Functions that launch the kernels on the card.
Tolerances: logits 1e-4, loss 1e-5 relative, every gradient within 1e-4
of its largest magnitude (fp32 sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu.models import bert as jbert  # noqa: E402
from mxnet_tpu.ndarray import NDArray  # noqa: E402
from mxnet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mxnet_tpu_torch.examples import bert_pretrain  # noqa: E402
from mxnet_tpu_torch.models import bert as tbert  # noqa: E402
from mxnet_tpu_torch.ops import flash_attention as fa  # noqa: E402

torch.set_num_threads(1)

CFG128 = dict(vocab_size=64, hidden=256, layers=2, heads=2,
              intermediate=512, max_len=32)          # head dim 128
CFG64 = dict(CFG128, hidden=128)                      # head dim 64
B, T = 2, 16


def numpy_tree(cfg, seed):
    """A params tree with the reference's keys and layouts; every leaf
    random (biases and LayerNorm affines too, so they are exercised)."""
    rs = np.random.RandomState(seed)
    d = cfg["hidden"]

    def arr(*shape, scale=0.02, loc=0.0):
        return (loc + scale * rs.randn(*shape)).astype(np.float32)

    def dense(i, o):
        return {"kernel": arr(i, o, scale=1 / np.sqrt(i)), "bias": arr(o)}

    return {
        "embed": {"tok": arr(cfg["vocab_size"], d),
                  "pos": arr(cfg["max_len"], d), "typ": arr(2, d),
                  "ln_g": arr(d, scale=0.1, loc=1.0), "ln_b": arr(d)},
        "layers": [{
            "qkv": dense(d, 3 * d), "out": dense(d, d),
            "ffn_in": dense(d, cfg["intermediate"]),
            "ffn_out": dense(cfg["intermediate"], d),
            "ln1_g": arr(d, scale=0.1, loc=1.0), "ln1_b": arr(d),
            "ln2_g": arr(d, scale=0.1, loc=1.0), "ln2_b": arr(d),
        } for _ in range(cfg["layers"])],
        "mlm": dense(d, cfg["vocab_size"]),
    }


class Pair:
    def __init__(self, cfg, seed=0):
        tree = numpy_tree(cfg, seed)
        self.jcfg = jbert.BertConfig(**cfg)
        self.tcfg = tbert.BertConfig(**cfg)
        self.jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        self.tparams = tbert.params_from_numpy(tree, "cpu")
        rs = np.random.RandomState(seed + 1)
        self.tokens = rs.randint(0, cfg["vocab_size"], (B, T))
        self.labels = np.where(rs.rand(B, T) < 0.3, self.tokens, -1)
        self.labels[0, 0] = 3                       # at least one label
        self.mask = rs.rand(B, T) < 0.7
        self.mask[:, 0] = True                      # no empty row


@pytest.fixture(scope="module", params=["hd128", "hd64"])
def pair(request):
    """hd128: the JAX side runs its Pallas kernels (interpret mode)."""
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "hd128":
            mp.setattr(jpk, "_FORCE_INTERPRET", True)
            yield Pair(CFG128)
        else:
            yield Pair(CFG64)


def _close_to_max(got, ref, rel=1e-4, what=""):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-6), (what, err,
                                                       np.abs(ref).max())


def test_apply_and_loss_match(pair):
    tok = torch.from_numpy(pair.tokens)
    jl = jbert.apply(pair.jparams, pair.jcfg, jnp.asarray(pair.tokens))
    with torch.no_grad():
        tl = tbert.apply(pair.tparams, pair.tcfg, tok)
        tloss = tbert.loss_fn(pair.tparams, pair.tcfg, tok,
                              torch.from_numpy(pair.labels))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    jloss = jbert.loss_fn(pair.jparams, pair.jcfg, jnp.asarray(pair.tokens),
                          jnp.asarray(pair.labels))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_token_types_match(pair):
    types = np.random.RandomState(3).randint(0, 2, (B, T))
    jl = jbert.apply(pair.jparams, pair.jcfg, jnp.asarray(pair.tokens),
                     jnp.asarray(types))
    with torch.no_grad():
        tl = tbert.apply(pair.tparams, pair.tcfg,
                         torch.from_numpy(pair.tokens),
                         torch.from_numpy(types))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


def _grads(pair, mask=None):
    jm = None if mask is None else jnp.asarray(mask)
    jloss, jg = jax.value_and_grad(jbert.loss_fn)(
        pair.jparams, pair.jcfg, jnp.asarray(pair.tokens),
        jnp.asarray(pair.labels), jm)
    flat = tbert.leaves(pair.tparams)
    for t in flat:
        t.requires_grad_(True)
    try:
        tloss = tbert.loss_fn(pair.tparams, pair.tcfg,
                              torch.from_numpy(pair.tokens),
                              torch.from_numpy(pair.labels),
                              None if mask is None else
                              torch.from_numpy(mask))
        tg = torch.autograd.grad(tloss, flat, allow_unused=True)
        tloss = tloss.detach()
    finally:
        for t in flat:
            t.requires_grad_(False)
    return jloss, jax.tree_util.tree_leaves(jg), tloss, tg


def test_every_gradient_matches_value_and_grad(pair):
    before = (fa.attention_fwd.launches, fa.attention_dq.launches)
    jloss, jg, tloss, tg = _grads(pair)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert len(jg) == len(tg) == len(tbert.leaves(pair.tparams))
    for i, (r, g) in enumerate(zip(jg, tg)):
        if g is None:                  # embed.typ: no token types given
            assert not np.asarray(r).any()
            continue
        _close_to_max(g.numpy(), r, what=i)
    # the CPU takes the plain versions: no kernel launch is counted
    assert (fa.attention_fwd.launches, fa.attention_dq.launches) == before


def test_masked_branch_matches(pair):
    jl = jbert.apply(pair.jparams, pair.jcfg, jnp.asarray(pair.tokens),
                     mask=jnp.asarray(pair.mask))
    with torch.no_grad():
        tl = tbert.apply(pair.tparams, pair.tcfg,
                         torch.from_numpy(pair.tokens),
                         mask=torch.from_numpy(pair.mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    jloss, jg, tloss, tg = _grads(pair, pair.mask)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for i, (r, g) in enumerate(zip(jg, tg)):
        if g is not None:
            _close_to_max(g.numpy(), r, what=i)


def test_params_from_numpy_keeps_keys_and_layouts():
    tree = numpy_tree(CFG64, 5)
    t = tbert.params_from_numpy(tree, "cpu")
    flat = tbert.leaves(t)
    ref = jax.tree_util.tree_leaves(tree)
    assert len(flat) == len(ref)
    for a, b in zip(flat, ref):
        np.testing.assert_array_equal(a.numpy(), b)
    assert tuple(t["layers"][1]["qkv"]["kernel"].shape) == (128, 384)


def test_init_params_is_seeded_with_reference_scales():
    cfg = tbert.BertConfig(**CFG64)
    a = tbert.init_params(cfg, seed=7, device="cpu")
    b = tbert.init_params(cfg, seed=7, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tbert.leaves(a),
                                                 tbert.leaves(b)))
    assert abs(float(a["embed"]["tok"].std()) - 0.02) < 0.002
    k = a["layers"][0]["ffn_out"]["kernel"]
    assert abs(float(k.std()) * np.sqrt(k.shape[0]) - 1) < 0.05
    assert not a["mlm"]["bias"].any() and bool((a["embed"]["ln_g"] == 1)
                                               .all())


def test_init_params_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tbert.init_params(tbert.BertConfig(**CFG64))


def test_bert_model_module_holds_trainable_tree():
    tree = numpy_tree(CFG64, 2)
    m = tbert.BertModel(tbert.BertConfig(**CFG64),
                        params=tbert.params_from_numpy(tree, "cpu"),
                        device="cpu")
    names = dict(m.named_parameters())
    assert "tree.layers.1.qkv.kernel" in names and \
        all(p.requires_grad for p in names.values())
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (B, T)))
    out = m(tok)
    assert tuple(out.shape) == (B, T, 64)
    torch.testing.assert_close(
        out, tbert.apply(tbert.params_from_numpy(tree, "cpu"), m.cfg, tok))


def _jax_example_loop(tree, jcfg, batches, lr):
    """The loop of ``example/bert/pretrain.py`` on given weights and
    batches: value_and_grad of loss_fn, one AdamW update per key."""
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = jopt.create("adamw", learning_rate=lr, wd=0.01)
    flat, treedef = jax.tree_util.tree_flatten(params)
    states = [opt.create_state(i, p) for i, p in enumerate(flat)]
    grad_fn = jax.value_and_grad(
        lambda p, t, lab: jbert.loss_fn(p, jcfg, t, lab))
    losses = []
    for tokens, labels in batches:
        loss, grads = grad_fn(params, jnp.asarray(tokens),
                              jnp.asarray(labels))
        new_flat = []
        for i, (p, g) in enumerate(zip(flat,
                                       jax.tree_util.tree_leaves(grads))):
            w = NDArray(p)
            states[i] = opt.update(i, w, NDArray(g), states[i])
            new_flat.append(w._data)
        flat = new_flat
        params = jax.tree_util.tree_unflatten(treedef, flat)
        losses.append(float(loss))
    return losses


def test_pretrain_main_matches_jax_example_loop(capsys):
    argv = ["--device", "cpu", "--vocab", "128", "--hidden", "128",
            "--layers", "2", "--heads", "2", "--batch-size", "2",
            "--seq-len", "16", "--steps", "3", "--seed", "0"]
    out = bert_pretrain.main(argv)
    assert "step 0 mlm loss" in capsys.readouterr().out
    args = bert_pretrain.parse_args(argv)
    tcfg = bert_pretrain.config(args)
    tree = jax.tree_util.tree_map(
        lambda t: t.numpy(), tbert.init_params(tcfg, 0, "cpu"))
    rng = np.random.RandomState(0)
    batches = [bert_pretrain.synthetic_batch(rng, 2, 16, 128)
               for _ in range(3)]
    assert (batches[0][0] == 103).any() and (batches[0][1] >= 0).any()
    jcfg = jbert.BertConfig(vocab_size=128, hidden=128, layers=2, heads=2,
                            intermediate=512, max_len=512)
    ref = _jax_example_loop(tree, jcfg, batches, args.lr)
    np.testing.assert_allclose(out["losses"], ref, rtol=1e-5)
    assert len(out["step_s"]) == 3 and out["tokens_s"] > 0
