"""Token-level continuous batching of the PyTorch port
(``mxnet_tpu_torch.serve.batcher.DecodeBatcher``) against the JAX
package's ``DecodeBatcher`` on the same weights and prompts: streamed
tokens, max_len eviction, admission control and thread shutdown."""
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu import generate as jgen  # noqa: E402
from mxnet_tpu.models import gpt as jgpt  # noqa: E402
from mxnet_tpu.serve.batcher import DecodeBatcher as JBatcher  # noqa: E402
from mxnet_tpu_torch import generate as tgen  # noqa: E402
from mxnet_tpu_torch import telemetry as ttel  # noqa: E402
from mxnet_tpu_torch.models import gpt as tgpt  # noqa: E402
from mxnet_tpu_torch.serve import batcher as tbat  # noqa: E402
from test_torch_gpt import CFG, ENGINE, numpy_tree  # noqa: E402

torch.set_num_threads(1)

PROMPTS = [[5, 17, 3, 88, 41], [9, 2, 60], [44, 44, 7, 1, 2, 3, 90],
           [70, 12]]


@pytest.fixture(scope="module")
def engines():
    tree = numpy_tree(CFG, 11)
    jeng = jgen.DecodeEngine(jax.tree_util.tree_map(jnp.asarray, tree),
                             jgpt.GPTConfig(**CFG), **ENGINE)
    teng = tgen.DecodeEngine(tgpt.params_from_numpy(tree, "cpu"),
                             tgpt.GPTConfig(**CFG), **ENGINE, device="cpu")
    return jeng, teng


def _serve(batcher, prompts, max_new):
    got, errs = {}, []

    def one(i, p):
        try:
            got[i] = batcher.submit(p, max_new=max_new, timeout=120)
        except Exception as e:      # surfaced by the assert below
            errs.append(e)

    ts = [threading.Thread(target=one, args=(i, p))
          for i, p in enumerate(prompts)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=180)
    assert not errs and not any(t.is_alive() for t in ts)
    return [got[i] for i in range(len(prompts))]


def test_streams_match_reference_batcher(engines):
    jeng, teng = engines
    with JBatcher(jeng, slots=2) as jb:
        ref = _serve(jb, PROMPTS, max_new=8)
    with tbat.DecodeBatcher(teng, slots=2, name="parity") as tb:
        out = _serve(tb, PROMPTS, max_new=8)
        st = tb.stats()
    assert out == ref
    # four requests through two rows: they joined and left mid-batch
    assert st["joins"] == 4 and st["leaves"] == 4
    assert st["max_concurrent"] == 2
    # and each stream is the request's own greedy generation
    assert out == [teng.generate([p], max_new=8)[0] for p in PROMPTS]


def test_eviction_at_max_len_matches_reference(engines):
    jeng, teng = engines
    prompt = list(range(1, 13))
    # 12 + 60 tokens would pass max_len 64: the row is evicted first
    with JBatcher(jeng, slots=2) as jb:
        ref = jb.submit(prompt, max_new=60, timeout=120)
    with tbat.DecodeBatcher(teng, slots=2, name="evict") as tb:
        out = tb.submit(prompt, max_new=60, timeout=120)
        st = tb.stats()
    assert out == ref
    assert len(out) == CFG["max_len"] - len(prompt) + 1
    assert st["evictions"] == 1


def test_queue_full_at_queue_depth(engines):
    _, teng = engines
    ttel.reset()
    with tbat.DecodeBatcher(teng, slots=2, queue_depth=0,
                            name="full") as tb:
        with pytest.raises(tbat.QueueFull):
            tb.submit([1, 2, 3], max_new=2)
    assert ttel.raw_snapshot()["counters"]["decode.rejected"] == 1


def test_close_leaves_no_decode_thread(engines):
    _, teng = engines
    tb = tbat.DecodeBatcher(teng, slots=2, name="closing")
    assert tb.submit([3, 4], max_new=3) == \
        teng.generate([[3, 4]], max_new=3)[0]
    tb.close()
    assert not [t for t in threading.enumerate()
                if t.name == "serve-decode-closing"]
    with pytest.raises(RuntimeError):
        tb.submit([1], max_new=1)


def test_slots_must_be_a_bucket(engines):
    _, teng = engines
    with pytest.raises(ValueError):
        tbat.DecodeBatcher(teng, slots=3)
