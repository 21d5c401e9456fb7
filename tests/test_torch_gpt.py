"""Slice-level parity of the PyTorch port's GPT decode path
(``mxnet_tpu_torch.models.gpt`` + ``mxnet_tpu_torch.generate``) against
the JAX package on the same weights.

One numpy params tree from a seed feeds both packages.  Head dim 128 and
prompt bucket 16 put the JAX prefill on its Pallas flash-attention route
(interpret mode, forced by a route table for the "16x128" stage), and
its LayerNorm on the Pallas kernel in interpret mode; the port runs the
plain versions of its kernels on the CPU.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu import generate as jgen  # noqa: E402
from mxnet_tpu import telemetry as jtel  # noqa: E402
from mxnet_tpu.models import gpt as jgpt  # noqa: E402
from mxnet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mxnet_tpu_torch import generate as tgen  # noqa: E402
from mxnet_tpu_torch.models import gpt as tgpt  # noqa: E402

torch.set_num_threads(1)

CFG = dict(vocab_size=97, hidden=256, layers=2, heads=2, intermediate=512,
           max_len=64)
ENGINE = dict(window=32, buckets=(1, 2), prompts=(16,))
TOL = dict(atol=1e-4, rtol=1e-4)


def numpy_tree(cfg, seed):
    """A params tree with the reference's keys and layouts; every leaf
    random (biases and LayerNorm affines too, so they are exercised)."""
    rs = np.random.RandomState(seed)
    d = cfg["hidden"]

    def arr(*shape, scale=0.02, loc=0.0):
        return (loc + scale * rs.randn(*shape)).astype(np.float32)

    def dense(i, o):
        return {"kernel": arr(i, o, scale=1 / np.sqrt(i)),
                "bias": arr(o)}

    return {
        "embed": {"tok": arr(cfg["vocab_size"], d),
                  "pos": arr(cfg["max_len"], d)},
        "layers": [{
            "qkv": dense(d, 3 * d), "out": dense(d, d),
            "ffn_in": dense(d, cfg["intermediate"]),
            "ffn_out": dense(cfg["intermediate"], d),
            "ln1_g": arr(d, scale=0.1, loc=1.0), "ln1_b": arr(d),
            "ln2_g": arr(d, scale=0.1, loc=1.0), "ln2_b": arr(d),
        } for _ in range(cfg["layers"])],
        "ln_f_g": arr(d, scale=0.1, loc=1.0), "ln_f_b": arr(d),
        "head": dense(d, cfg["vocab_size"]),
    }


@pytest.fixture(scope="module")
def pallas_route(tmp_path_factory):
    """Route the JAX prefill's attention and LayerNorm through their
    Pallas kernels (interpret mode on the CPU)."""
    table = tmp_path_factory.mktemp("attn") / "table.json"
    table.write_text(json.dumps({"decisions": {"16x128": {"fwd": "pallas"}}}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_TPU_PALLAS_ATTN", "1")
        mp.setenv("MXNET_TPU_PALLAS_ATTN_TABLE", str(table))
        mp.setattr(jpk, "_FORCE_INTERPRET", True)
        yield


class Pair:
    def __init__(self, cfg, seed=0):
        tree = numpy_tree(cfg, seed)
        self.jcfg = jgpt.GPTConfig(**cfg)
        self.tcfg = tgpt.GPTConfig(**cfg)
        self.jparams = jax.tree_util.tree_map(jnp.asarray, tree)
        self.tparams = tgpt.params_from_numpy(tree, "cpu")
        self.jeng = jgen.DecodeEngine(self.jparams, self.jcfg, **ENGINE)
        self.teng = tgen.DecodeEngine(self.tparams, self.tcfg, **ENGINE,
                                      device="cpu")


@pytest.fixture(scope="module")
def pair(pallas_route):
    return Pair(CFG)


def _tokens(b, t, seed, vocab=CFG["vocab_size"]):
    return np.random.RandomState(seed).randint(1, vocab, size=(b, t))


def test_params_from_numpy_keeps_keys_shapes_layouts(pair):
    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}[{i}]")
        else:
            yield prefix, tree

    j = dict(leaves(pair.jparams))
    t = dict(leaves(pair.tparams))
    assert j.keys() == t.keys()
    for k in j:
        assert tuple(t[k].shape) == j[k].shape, k
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_prefill_logits_and_kv_match(pair):
    toks = _tokens(2, 16, 1)
    jtel.reset()
    jl, jk, jv = jax.jit(lambda p, t: jgpt.prefill(p, pair.jcfg, t))(
        pair.jparams, jnp.asarray(toks, jnp.int32))
    # the reference really took its Pallas flash-attention route
    assert jtel.raw_snapshot()["counters"].get(
        "dispatch.attn.hits.16x128", 0) > 0
    tl, tk, tv = tgpt.prefill(pair.tparams, pair.tcfg, torch.from_numpy(toks))
    assert tk.shape == (2, 2, 16, 2, 128)
    for t, j in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_decode_steps_match(pair):
    """Several decode steps from a prefilled ring, teacher-forced with the
    reference's greedy tokens: logits and both caches agree each step."""
    cfg = pair.jcfg
    toks = _tokens(2, 16, 2)
    lens = np.array([16, 11])
    jl, jk, jv = jgpt.prefill(pair.jparams, cfg, jnp.asarray(toks, jnp.int32))
    shape = (cfg.layers, 2, ENGINE["window"], cfg.heads,
             cfg.hidden // cfg.heads)
    jkc = jnp.zeros(shape).at[:, :, :16].set(jk)
    jvc = jnp.zeros(shape).at[:, :, :16].set(jv)
    tkc = torch.from_numpy(np.array(jkc))
    tvc = torch.from_numpy(np.array(jvc))
    pos = lens - 1
    tok = np.array(jnp.argmax(jl[np.arange(2), pos], -1))
    jstep = jax.jit(lambda p, t, q, k, v: jgpt.decode_step(p, cfg, t, q, k, v))
    for _ in range(4):
        pos = pos + 1
        jlog, jkc, jvc = jstep(pair.jparams, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(pos, jnp.int32), jkc, jvc)
        with torch.no_grad():
            tlog, tkc2, _ = tgpt.decode_step(
                pair.tparams, pair.tcfg, torch.from_numpy(tok),
                torch.from_numpy(pos), tkc, tvc)
        assert tkc2 is tkc                  # caches updated in place
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), **TOL)
        np.testing.assert_allclose(tvc.numpy(), np.asarray(jvc), **TOL)
        tok = np.array(jnp.argmax(jlog, -1))


@pytest.mark.parametrize("prompts", [
    [[5, 17, 3, 88, 41]],
    [[5, 17, 3, 88, 41], [9, 2, 60, 33, 70, 12, 1, 96, 4]],
], ids=["batch1", "batch2"])
def test_generate_greedy_tokens_equal(pair, prompts):
    assert pair.teng.generate(prompts, max_new=8) == \
        pair.jeng.generate(prompts, max_new=8)


def test_ring_wraparound_matches(pair):
    prompt = [[int(t) for t in _tokens(1, 10, 3)[0]]]
    # 10 + 30 = 40 tokens > window 32: the ring overwrites its oldest slots
    out = pair.teng.generate(prompt, max_new=30)
    assert out == pair.jeng.generate(prompt, max_new=30)


def test_snapshot_restore_replays_identically(pair):
    eng = pair.teng
    prompt = [5, 17, 3, 88, 41]
    ctl = eng.prefill([prompt])
    for _ in range(3):
        eng.step(ctl)
    snap = tgen.snapshot(ctl)
    cont = [int(eng.step(ctl)["tok"][0]) for _ in range(3)]
    end_a = tgen.snapshot(ctl)
    ctl = tgen.restore(snap, "cpu")
    replay = [int(eng.step(ctl)["tok"][0]) for _ in range(3)]
    end_b = tgen.snapshot(ctl)
    assert cont == replay
    for key in ("k", "v", "pos", "tok", "t"):
        np.testing.assert_array_equal(end_a[key], end_b[key])
    # and the continuation is the reference's greedy stream
    assert cont == pair.jeng.generate([prompt], max_new=7)[0][4:7]


def test_refuses_past_max_len(pair):
    with pytest.raises(ValueError):
        pair.teng.generate([[1] * 10], max_new=CFG["max_len"] - 9)


def test_engine_without_device_raises_when_no_card(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tgen.DecodeEngine(pair.tparams, pair.tcfg, **ENGINE)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tgpt.init_params(pair.tcfg)


def test_gpt_model_module_holds_the_tree(pair):
    model = tgpt.GPTModel(pair.tcfg, params=pair.tparams, device="cpu")
    assert sorted(model.params) == sorted(pair.tparams)
    toks = torch.from_numpy(_tokens(1, 12, 4))
    with torch.no_grad():
        np.testing.assert_array_equal(
            model(toks).numpy(),
            tgpt.apply(pair.tparams, pair.tcfg, toks).numpy())
    assert all(not p.requires_grad for p in model.parameters())


def test_init_params_is_seeded():
    cfg = tgpt.GPTConfig(vocab_size=11, hidden=8, layers=1, heads=2,
                         intermediate=16, max_len=8)
    a, b = (tgpt.init_params(cfg, seed=3, device="cpu") for _ in range(2))
    assert torch.equal(a["layers"][0]["qkv"]["kernel"],
                       b["layers"][0]["qkv"]["kernel"])


def test_head_dim_64_matches_reference_composition():
    """heads=4 → head dim 64: the JAX prefill takes its XLA composition
    (the Pallas route needs D % 128); the port's path is the same."""
    cfg = dict(CFG, heads=4)
    p = Pair(cfg, seed=5)
    toks = _tokens(2, 16, 6)
    jl = jgpt.apply(p.jparams, p.jcfg, jnp.asarray(toks, jnp.int32))
    tl = tgpt.apply(p.tparams, p.tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    prompts = [[5, 17, 3, 88, 41], [9, 2, 60]]
    assert p.teng.generate(prompts, max_new=6) == \
        p.jeng.generate(prompts, max_new=6)
