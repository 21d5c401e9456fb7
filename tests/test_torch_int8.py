"""int8 post-training quantization of the PyTorch port
(``mxnet_tpu_torch.quantization``, ``ops/cuda_int8.py``, the int8 ops of
``ops/nn.py``) against the JAX package on the CPU: the kernel module's
plain version against the reference's Pallas kernel (interpret mode) and
its XLA oracle, the quantized ops, calibration, BatchNorm folding and
quantized ResNet-18 / ResNet-50 forwards on shared numpy weights, on the
reference's layer route and on its forced fused (Pallas int8) route.

Tolerances: int32 sums are exact, so the plain int8 products equal the
reference's; every epilogue is the same two rounded f32 operations
(``acc · scale + shift``), held within 1e-6 of the output's largest
magnitude (XLA may contract them into an FMA); thresholds within 1e-5
relative (the calibration forwards sum in another order); quantized
forwards with the reference's own int8 weights and thresholds carried
across (``state_from_numpy``) within 1e-5 of the largest logit, argmax
equal."""
import contextlib
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import quantization as jq  # noqa: E402
from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from mxnet_tpu.models.resnet import BasicBlockV1 as JBasic  # noqa: E402
from mxnet_tpu.ops import nn as jnn  # noqa: E402
from mxnet_tpu.ops import pallas_int8 as jpi8  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch import quantization as tq  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tgnn  # noqa: E402
from mxnet_tpu_torch.models.resnet import BasicBlockV1 as TBasic  # noqa: E402
from mxnet_tpu_torch.ops import conv_block  # noqa: E402
from mxnet_tpu_torch.ops import cuda_int8 as ci  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402
from test_torch_kernels import _FakeCuda, _no_lib  # noqa: E402
from test_torch_kernels import _conv3x3_reduced  # noqa: E402
from test_torch_kernels import _conv3x3_segments  # noqa: E402
from test_torch_resnet import port_net, reference_net  # noqa: E402
from test_torch_resnet import weights_for  # noqa: E402

torch.set_num_threads(1)

EPI_TOL = 1e-6          # epilogue: of the output's largest magnitude
THR_RTOL = 1e-5         # calibrated thresholds
LOGIT_TOL = 1e-5        # quantized forwards on carried state


def _close(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err,
                                                        np.abs(ref).max())


def _qdata(rs, N, H, W, C, Cout, residual):
    qx = rs.randint(-127, 128, (N, H, W, C)).astype(np.int8)
    qw = rs.randint(-127, 128, (3, 3, C, Cout)).astype(np.int8)
    scale = (rs.rand(Cout) * 1e-3 + 1e-4).astype(np.float32)
    shift = (rs.randn(Cout) * 0.1).astype(np.float32)
    res = rs.randn(N, H, W, Cout).astype(np.float32) if residual else None
    return qx, qw, scale, shift, res


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# ------------------------------------------------------------ kernel module
@pytest.mark.parametrize("shape,residual,relu", [
    ((2, 8, 8, 8, 16), False, False),
    ((2, 8, 8, 8, 16), False, True),
    ((2, 8, 8, 8, 16), True, True),
    ((1, 5, 7, 20, 12), True, False),         # ragged C, odd H and W
])
def test_qconv3x3_plain_matches_pallas_kernel_and_xla(shape, residual,
                                                      relu):
    """``qconv3x3_plain`` against the reference's Pallas kernel
    (interpret mode) and ``qconv3x3_xla`` on the same int8 data: the
    epilogue within 1e-6 of the largest output."""
    rs = np.random.RandomState(8)
    qx, qw, scale, shift, res = _qdata(rs, *shape, residual)
    out = ci.qconv3x3_plain(_t(qx), _t(qw), _t(scale), _t(shift), _t(res),
                            relu=relu).numpy()
    kw = dict(res=_j(res), relu=relu)
    jargs = (_j(qx), _j(qw), _j(scale), _j(shift))
    _close(out, np.asarray(jpi8.qconv3x3_xla(*jargs, **kw)), EPI_TOL)
    _close(out, np.asarray(jpi8.qconv3x3_affine(*jargs, **kw)), EPI_TOL)


def test_qconv3x3_int32_sum_is_exact():
    """scale 1, shift 0, no ReLU: the output is the int32 sum, equal to
    the reference's ``preferred_element_type=int32`` conv."""
    rs = np.random.RandomState(9)
    qx, qw, _, _, _ = _qdata(rs, 2, 6, 9, 16, 8, False)
    ones, zeros = np.ones(8, np.float32), np.zeros(8, np.float32)
    out = ci.qconv3x3_plain(_t(qx), _t(qw), _t(ones), _t(zeros),
                            relu=False).numpy()
    ref = np.asarray(jpi8.qconv3x3_xla(_j(qx), _j(qw), _j(ones),
                                       _j(zeros), relu=False))
    np.testing.assert_array_equal(out, ref)
    acc = np.zeros((2, 6, 9, 8), np.int64)
    xp = np.pad(qx.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    for i in range(3):
        for j in range(3):
            acc += np.einsum("nhwc,cd->nhwd", xp[:, i:i + 6, j:j + 9],
                             qw[i, j].astype(np.int64))
    np.testing.assert_array_equal(out, acc.astype(np.float32))


def test_qconv3x3_affine_takes_its_plain_version_on_the_cpu():
    rs = np.random.RandomState(10)
    qx, qw, scale, shift, res = _qdata(rs, 1, 4, 4, 16, 8, True)
    before = ci.qconv3x3_affine.launches
    args = (_t(qx), _t(qw), _t(scale), _t(shift), _t(res))
    out = ci.qconv3x3_affine(*args, qw_packed=ci.pack_weight(_t(qw)))
    assert torch.equal(out, ci.qconv3x3_plain(*args))
    assert ci.qconv3x3_affine.launches == before   # not a kernel launch


def _fake_args(N=1, H=4, W=4, C=16, Cout=8, **over):
    a = dict(qx=torch.zeros(N, H, W, C, dtype=torch.int8),
             qw=torch.zeros(3, 3, C, Cout, dtype=torch.int8),
             scale=torch.zeros(Cout), shift=torch.zeros(Cout),
             res=torch.zeros(N, H, W, Cout),
             qw_packed=torch.zeros(Cout, 9 * C, dtype=torch.int8))
    a.update(over)
    return a


@pytest.mark.parametrize("over,exc", [
    (dict(qx=torch.zeros(1, 4, 4, 16)), TypeError),             # f32 input
    (dict(qw=torch.zeros(3, 3, 8, 8, dtype=torch.int8)), ValueError),
    (dict(scale=torch.zeros(7)), ValueError),
    (dict(shift=torch.zeros(8, dtype=torch.float64)), TypeError),
    (dict(res=torch.zeros(1, 4, 4, 7)), ValueError),
    (dict(qw_packed=torch.zeros(8, 9 * 16, dtype=torch.int8).t()),
     ValueError),                                                # layout
    (dict(qx=torch.zeros(4, 4, 16, dtype=torch.int8)), ValueError),
])
def test_qconv3x3_wrapper_refuses(over, exc, monkeypatch):
    monkeypatch.setattr(ci._build, "lib", _no_lib)
    a = {k: _FakeCuda(v) for k, v in _fake_args(**over).items()}
    with pytest.raises(exc):
        ci.qconv3x3_affine(a["qx"], a["qw"], a["scale"], a["shift"],
                           a["res"], qw_packed=a["qw_packed"])


def test_qconv3x3_wrapper_raises_on_a_cuda_tensor_without_a_card(
        monkeypatch):
    """Arguments the kernel takes, on a (stand-in) CUDA device: the
    wrapper goes for the card and raises; it never computes the plain
    version instead."""
    def plain(*a, **k):
        raise AssertionError("the plain version must not be reached")
    monkeypatch.setattr(ci, "qconv3x3_plain", plain)
    a = {k: _FakeCuda(v) for k, v in _fake_args().items()}
    before = ci.qconv3x3_affine.launches
    with pytest.raises((RuntimeError, AssertionError, TypeError)) as e:
        ci.qconv3x3_affine(a["qx"], a["qw"], a["scale"], a["shift"],
                           a["res"], qw_packed=a["qw_packed"])
    assert "plain version" not in str(e.value)
    assert ci.qconv3x3_affine.launches == before
    meta = torch.empty(1, 4, 4, 16, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        ci.qconv3x3_affine(meta, meta, meta, meta)


@pytest.mark.parametrize("bad", ["qw_packed", "scale", "shift", "res"])
def test_qconv3x3_wrapper_refuses_a_tensor_on_another_device(
        bad, monkeypatch):
    """qx on the card and one argument on the CPU: refused before the
    kernel library is touched."""
    monkeypatch.setattr(ci._build, "lib", _no_lib)
    a = {k: (v if k == bad else _FakeCuda(v))
         for k, v in _fake_args().items()}
    with pytest.raises(ValueError, match="is on cpu"):
        ci.qconv3x3_affine(a["qx"], a["qw"], a["scale"], a["shift"],
                           a["res"], qw_packed=a["qw_packed"])


@pytest.mark.parametrize("shape,vec", [((64, 56, 56, 64, 64), 1),
                                       ((1, 7, 7, 512, 512), 1),
                                       ((2, 13, 17, 20, 40), 0)])
def test_qconv3x3_wrapper_passes_its_plan_to_the_kernel(shape, vec,
                                                        monkeypatch):
    """On a (stand-in) card the wrapper asks the occupancy entry for its
    blocks an SM, cuts the work by ``qconv_splits`` and hands the kernel
    that plan (bn, ranges, grain), an int32 slot buffer of 2·ranges
    tiles where the plan cuts tiles (none for whole-tile ranges), and the
    16-byte path only where C % 16 == 0 and Cout % 4 ==
    0; one call counts one launch.  The library is a recorder here and
    the CUDA calls around it are stubbed."""
    N, H, W, C, Cout = shape
    calls, asked, made = [], [], []

    class _Lib:
        def mxt_qconv_affine_s8(self, *args):
            calls.append(args)
            return 0

    def empty(size, device=None, dtype=None):
        made.append((tuple(size), dtype))
        return _FakeCuda(torch.zeros(1, dtype=dtype).expand(size))

    monkeypatch.setattr(ci._build, "lib", _Lib)
    monkeypatch.setattr(ci, "_sm_count", lambda i: 132)
    monkeypatch.setattr(ci, "_per_sm",
                        lambda *a: asked.append(a) or 2)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=7))
    a = {k: _FakeCuda(v) for k, v in _fake_args(N, H, W, C, Cout).items()}
    before = ci.qconv3x3_affine.launches
    ci.qconv3x3_affine(a["qx"], a["qw"], a["scale"], a["shift"], a["res"],
                       qw_packed=a["qw_packed"])
    plan = ci.qconv_splits(N * H * W, 9 * C, Cout, 132, 2)
    assert asked == [("mxt_qconv_affine_blocks_per_sm", 0, plan.bn, vec)]
    slots = 2 * plan.ranges if plan.grain == 1 else 0
    assert made == [((N, H, W, Cout), torch.float32),
                    ((slots, 128, plan.bn), torch.int32)]
    assert len(calls) == 1
    assert len(calls[0]) == len(ci._build._SIGNATURES[
        "mxt_qconv_affine_s8"])
    assert calls[0][7:12] == (N, H, W, C, Cout)
    assert calls[0][13:17] == (plan.bn, plan.ranges, plan.grain, vec)
    assert ci.qconv3x3_affine.launches == before + 1


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
@pytest.mark.parametrize("N", [1, 8, 64])
@pytest.mark.parametrize("H,C", [(56, 64), (28, 128), (14, 256), (7, 512)])
def test_qconv_splits_fill_the_card_and_cover_every_tile(H, C, N, per_sm):
    """``qconv_splits`` at ResNet-50's four 3×3 stages at the int8 paths'
    batches (64 scoring, 8 and 1 serving) on 132 SMs that hold ``per_sm``
    blocks each: one wave of ranges (of whole tiles where the tiles give
    every SM one, else each tile split into the same few), whose segments
    cover every 64-byte chunk of every 128-pixel tile exactly once; each
    tile is either written whole by one segment or cut, and
    ``tile_writers`` lists exactly one writer for it:
    the main kernel's range, or the ``qconv_reduce_kernel`` block that
    sums exactly its segments' slots, in chunk order, no slot written
    twice.  Where the ranges hold whole tiles they cut none."""
    M = N * H * H
    plan = ci.qconv_splits(M, 9 * C, C, 132, per_sm)
    # 128 channels a tile where Cout > 64, but 64 where that turns
    # 28×28×128 at batch 8 from 49 tiles into 98 whole ones
    narrow = C == 64 or (N, H) in ((8, 28), (64, 7))
    assert plan.bn == ci.qconv_tile_cols(M, C, 132) == (64 if narrow
                                                        else 128)
    assert plan.tiles == -(-M // 128) * (C // plan.bn)
    assert plan.chunks == 9 * C // 64
    assert plan.ranges <= 132 * per_sm               # one wave
    # whole-tile ranges where the tiles give every SM one; below that
    # every tile split into the same few ranges
    split = min(132 // plan.tiles, 16, plan.chunks)
    if plan.tiles >= 132:
        assert plan.grain == plan.chunks
        assert plan.ranges == min(132 * per_sm, plan.tiles)
    else:
        assert plan.ranges == plan.tiles * split
        assert plan.grain == (plan.chunks if split == 1 else 1)
    covered, whole, cut, slots = {}, set(), {}, set()
    segments = list(_conv3x3_segments(plan))
    for b, tile, c0, nk, slot in segments:
        for c in range(c0, c0 + nk):
            assert (tile, c) not in covered
            covered[tile, c] = b
        if slot is None:
            whole.add((tile, b))
        else:
            assert slot not in slots and slot // 2 == b
            slots.add(slot)
            cut.setdefault(tile, []).append((c0, slot))
    assert len(covered) == plan.tiles * plan.chunks
    if plan.tiles < 132:                # no range spans two tiles
        assert len(segments) == plan.ranges
    assert {t for t, _ in whole} | set(cut) == set(range(plan.tiles))
    assert not {t for t, _ in whole} & set(cut)
    assert _conv3x3_reduced(plan) == \
        {t: [sl for _, sl in sorted(segs)] for t, segs in cut.items()}
    writers = conv_block.tile_writers(plan)
    assert sorted(t for t, _, _ in writers) == list(range(plan.tiles))
    assert {(t, b) for t, k, b in writers if k == "main"} == whole
    assert {t for t, k, _ in writers if k == "cut"} == set(cut)
    if plan.grain > 1:
        assert not cut
    else:
        assert all(len(cut[t]) == split for t in cut)
    if N == 64 and H >= 14 or N == 8 and H == 56:
        assert plan.grain == plan.chunks    # 196-1568 tiles
    if N == 1 and H == 7:                   # 4 tiles, 16 ranges each
        assert plan.ranges == 64 and len(cut) == 4


@pytest.mark.parametrize("shape,residual,relu,sms", [
    ((2, 9, 7, 32, 24), True, True, 3),
    ((1, 7, 7, 64, 128), False, False, 13),
    ((1, 5, 6, 20, 12), True, True, 4),       # ragged C: the gathered path
    ((2, 16, 16, 16, 8), True, False, 2),     # whole-tile ranges
])
def test_qconv_stream_k_partials_match_the_plain_version(shape, residual,
                                                         relu, sms):
    """The kernel's arithmetic under its plan, in plain torch: each
    segment's int32 partial product over its chunks of K, whole tiles
    finished from their one segment, cut tiles from their slots summed in
    range order, then ``f32(acc)·scale + shift (+ res)`` and ReLU; bitwise
    equal to ``qconv3x3_plain`` (int32 sums are exact in any order).  Few
    SMs, so tiles are cut where there are fewer tiles than SMs."""
    N, H, W, C, Cout = shape
    rs = np.random.RandomState(sum(shape))
    qx, qw, scale, shift, res = (_t(a) for a in
                                 _qdata(rs, N, H, W, C, Cout, residual))
    M, K = N * H * W, 9 * C
    plan = ci.qconv_splits(M, K, Cout, sms, 2)
    patches = ci.im2col(qx, (3, 3), pad=(1, 1)).reshape(M, K).long()
    wt = ci.pack_weight(qw).long()
    tiles_n = -(-Cout // plan.bn)
    rows = ci.QCONV_ROWS
    part = {}
    acc = torch.zeros(M, Cout, dtype=torch.int64)

    def block(tile):
        m0, n0 = tile // tiles_n * rows, tile % tiles_n * plan.bn
        return slice(m0, min(m0 + rows, M)), slice(n0, min(n0 + plan.bn,
                                                           Cout))

    for b, tile, c0, nk, slot in _conv3x3_segments(plan):
        ms, ns = block(tile)
        ks = slice(c0 * ci.QCONV_CHUNK, min((c0 + nk) * ci.QCONV_CHUNK, K))
        p = patches[ms, ks] @ wt[ns, ks].t()
        if slot is None:
            acc[ms, ns] = p
        else:
            part[slot] = p
    reduced = _conv3x3_reduced(plan)
    # the plan cuts tiles unless its ranges hold whole tiles
    assert bool(reduced) == (plan.grain == 1)
    for tile, slots in reduced.items():
        ms, ns = block(tile)
        acc[ms, ns] = sum(part[sl] for sl in slots)
    assert acc.abs().max() < 2 ** 31
    y = acc.int().float().reshape(N, H, W, Cout) * scale + shift
    if res is not None:
        y = y + res
    y = torch.relu(y) if relu else y
    assert torch.equal(y, ci.qconv3x3_plain(qx, qw, scale, shift, res,
                                            relu))


@pytest.mark.parametrize("m,k,n", [(1, 147, 1000), (5, 9, 3),
                                   (40, 576, 64)])
def test_int8_matmul_is_exact(m, k, n):
    rs = np.random.RandomState(11)
    a = rs.randint(-127, 128, (m, k)).astype(np.int8)
    wt = rs.randint(-127, 128, (n, k)).astype(np.int8)
    out = ci.int8_matmul(_t(a), _t(wt)).numpy()
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, a.astype(np.int64) @
                                  wt.astype(np.int64).T)


# ---------------------------------------------------------------- the ops
def test_quantize_sym_matches_reference():
    """Equal int8 on the same f32 input, ties (x·s = k + 0.5) and values
    beyond the threshold included."""
    rs = np.random.RandomState(12)
    t = 2.5
    ties = (np.arange(-130, 130) + 0.5) * (t / 127.0)
    x = np.concatenate([rs.randn(2000) * 1.5, ties,
                        [0.0, -0.0, 9.0, -9.0]]).astype(np.float32)
    qx, s = tnn._quantize_sym(torch.from_numpy(x), t)
    jx, js = jnn._quantize_sym(jnp.asarray(x), t)
    assert s == js and qx.dtype == torch.int8
    np.testing.assert_array_equal(qx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("geom", [
    dict(kernel=3, stride=1, pad=1, C=16, Cout=24, residual=True),
    dict(kernel=3, stride=1, pad=1, C=8, Cout=8, act="relu"),
    dict(kernel=1, stride=2, pad=0, C=16, Cout=32, residual=True),
    dict(kernel=1, stride=1, pad=0, C=24, Cout=8),
    dict(kernel=7, stride=2, pad=3, C=3, Cout=16, relu=True),   # the stem
    dict(kernel=3, stride=2, pad=1, C=8, Cout=16, act="sigmoid"),
])
def test_quantized_conv_matches_reference(geom):
    rs = np.random.RandomState(13)
    k, C, Cout = geom["kernel"], geom["C"], geom["Cout"]
    s = geom["stride"]
    x = rs.randn(2, 11, 9, C).astype(np.float32)
    qw = rs.randint(-127, 128, (k, k, C, Cout)).astype(np.int8)
    w_scale = (rs.rand(Cout) * 100 + 20).astype(np.float32)
    bias = (rs.randn(Cout) * 0.1).astype(np.float32)
    Ho = (11 + 2 * geom["pad"] - k) // s + 1
    Wo = (9 + 2 * geom["pad"] - k) // s + 1
    res = rs.randn(2, Ho, Wo, Cout).astype(np.float32) \
        if geom.get("residual") else None
    kw = dict(in_t=2.7, stride=(s, s), pad=(geom["pad"],) * 2,
              relu=geom.get("relu", False), act=geom.get("act"))
    out = tnn.quantized_conv(_t(x), _t(qw), _t(w_scale), _t(bias), _t(res),
                             **kw).numpy()
    ref = np.asarray(jnn.quantized_conv(_j(x), _j(qw), _j(w_scale),
                                        _j(bias), _j(res), **kw))
    _close(out, ref, EPI_TOL)


@pytest.mark.parametrize("shape,flatten,act,bias", [
    ((3, 2, 2, 4), True, None, True),
    ((3, 5, 8), False, "relu", True),
    ((1, 16), True, None, False),
])
def test_quantized_dense_matches_reference(shape, flatten, act, bias):
    rs = np.random.RandomState(14)
    x = rs.randn(*shape).astype(np.float32)
    n_in = int(np.prod(shape[1:])) if flatten else shape[-1]
    qw = rs.randint(-127, 128, (n_in, 10)).astype(np.int8)
    w_scale = (rs.rand(10) * 100 + 20).astype(np.float32)
    b = (rs.randn(10) * 0.1).astype(np.float32) if bias else None
    kw = dict(in_t=3.1, flatten=flatten, act=act)
    out = tnn.quantized_dense(_t(x), _t(qw), _t(w_scale), _t(b),
                              **kw).numpy()
    ref = np.asarray(jnn.quantized_dense(_j(x), _j(qw), _j(w_scale), _j(b),
                                         **kw))
    _close(out, ref, EPI_TOL)


def test_quantize_and_dequantize_match_reference():
    rs = np.random.RandomState(15)
    x = rs.randn(4, 7).astype(np.float32)
    for rng in ((None, None), (-1.5, 2.0)):
        q, lo, hi = tq.quantize_v2(torch.from_numpy(x), *rng)
        jqx, jlo, jhi = jq.quantize_v2(mx.np.array(x), *rng)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqx._data))
        assert float(hi) == float(np.asarray(jhi._data))
        d = tq.dequantize(q, lo, hi).numpy()
        jd = np.asarray(jq.dequantize(jqx, jlo, jhi)._data)
        np.testing.assert_allclose(d, jd, rtol=1e-6, atol=0)


# ------------------------------------------------------------ calibration
@pytest.mark.parametrize("dist", ["normal", "laplace", "uniform"])
def test_optimal_threshold_matches_reference(dist):
    rs = np.random.RandomState(16)
    arr = getattr(rs, dist)(size=20000).astype(np.float32)
    assert tq._get_optimal_threshold(arr) == \
        jq._get_optimal_threshold(arr)


def _small(nn, basic):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, use_bias=False), nn.BatchNorm(),
            nn.Activation("relu"), basic(8, 1), nn.GlobalAvgPool2D(),
            nn.Flatten(), nn.Dense(4))
    return net


def _small_pair(seed=21):
    item = (1, 8, 8, 3)
    jnet = _small(jgnn, JBasic)
    jnet.initialize()
    jnet(mx.np.array(np.zeros(item, np.float32)))
    params = jnet.collect_params()
    arrays = weights_for([(k, p.shape) for k, p in params.items()], seed)
    for k, p in params.items():
        p.set_data(jnp.asarray(arrays[k]))
    tnet = _small(tgnn, TBasic)
    tgluon.load_numpy(tnet, arrays)
    return jnet, tnet


def _twins_j(net):
    return {p: b for _, b, p in jq._walk(net)
            if isinstance(b, (jq.QuantizedDense, jq.QuantizedConv2D))}


def _twins_t(net):
    return {p: b for _, b, p in tq._walk(net) if isinstance(b, tq._Twin)}


def _state(jnet):
    """The reference twins' int8 weights, scales, biases, thresholds."""
    return {p: {"qw": np.asarray(b._qw._data),
                "w_scale": np.asarray(b._w_scale._data),
                "bias": None if b._bias is None else
                np.asarray(b._bias._data), "in_t": b._in_t}
            for p, b in _twins_j(jnet).items()}


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantize_net_calibration_matches_reference(mode):
    """The same layer paths quantized, their thresholds within 1e-5
    relative, and (folded in numpy f32 as the reference folds) the same
    int8 weights, scales and biases bit for bit."""
    jnet, tnet = _small_pair()
    rs = np.random.RandomState(22)
    calib = [rs.rand(2, 8, 8, 3).astype(np.float32) for _ in range(2)]
    jq.quantize_net(jnet, calib_data=[mx.np.array(c) for c in calib],
                    calib_mode=mode)
    tq.quantize_net(tnet, calib_data=calib, calib_mode=mode)
    jt, tt = _twins_j(jnet), _twins_t(tnet)
    assert list(jt) == list(tt) == ["0", "3.body.0", "3.body.3", "6"]
    for p in jt:
        assert type(tt[p]).__name__ == type(jt[p]).__name__
        assert abs(tt[p]._in_t - jt[p]._in_t) <= THR_RTOL * jt[p]._in_t, p
        np.testing.assert_array_equal(tt[p]._qw.numpy(),
                                      np.asarray(jt[p]._qw._data))
        np.testing.assert_array_equal(tt[p]._w_scale.numpy(),
                                      np.asarray(jt[p]._w_scale._data))
        np.testing.assert_array_equal(tt[p]._bias.numpy(),
                                      np.asarray(jt[p]._bias._data))
    # the folded BNs are gone from the parameters, as in the reference
    assert list(tnet.collect_params()) == list(jnet.collect_params())


def test_quantize_net_thresholds_exclude_and_errors():
    jnet, tnet = _small_pair()
    paths = list(_twins_t(tq.quantize_net(_small_pair()[1],
                                          calib_mode="none")))
    thr = {p: 1.0 + i for i, p in enumerate(paths)}
    tq.quantize_net(tnet, thresholds=thr, exclude_layers=[paths[-1]])
    tt = _twins_t(tnet)
    assert list(tt) == paths[:-1]
    assert all(tt[p]._in_t == thr[p] for p in tt)
    assert isinstance(tnet[6], tgnn.Dense)          # excluded: still fp32
    with pytest.raises(ValueError):
        tq.quantize_net(_small_pair()[1])           # nothing to calibrate
    with pytest.raises(ValueError):
        tq.quantize_net(_small_pair()[1], thresholds={"0": 1.0})


def test_quantized_twins_are_buffers_that_move_and_are_not_params():
    _, tnet = _small_pair()
    tq.quantize_net(tnet, calib_mode="none")
    tw = _twins_t(tnet)["3.body.3"]
    assert tw._qw.dtype == torch.int8 and tw._qw_packed.shape == (8, 72)
    assert {n for n, _ in tw.named_buffers()} == \
        {"_w_scale", "_qw", "_qw_packed", "_bias"}
    assert not list(tw.parameters()) and not tw.state_dict()
    tnet.to(torch.float32)              # buffers keep int8 through .to()
    assert tw._qw.dtype == torch.int8


# -------------------------------------------------- the slice as a whole
@pytest.fixture(scope="module")
def quantized():
    """ResNet-18 v1 and ResNet-50 v1 (10 classes, 32×32) with seeded
    weights, quantized by the JAX package on its default (layer) route,
    shared by the tests below (~20 s for ResNet-50 on the CPU)."""
    out = {}
    rs = np.random.RandomState(23)
    calib = [rs.rand(2, 32, 32, 3).astype(np.float32) for _ in range(2)]
    for arch in ("resnet18_v1", "resnet50_v1"):
        jnet, arrays = reference_net(arch, seed=1, classes=10)
        jq.quantize_net(jnet, calib_data=[mx.np.array(c) for c in calib],
                        calib_mode="naive")
        out[arch] = (jnet, arrays, calib)
    return out


def _port_quantized(arch, arrays, calib, state=None):
    tnet = port_net(arch, arrays, classes=10)
    tq.quantize_net(tnet, calib_data=calib, calib_mode="naive")
    if state is not None:
        tq.state_from_numpy(tnet, state)
    return tnet


def _stage_table(tmp_path, monkeypatch):
    """The reference's fused route: every 3×3/s1 stage of the net at
    32×32 routed to the int8 Pallas kernel (interpret mode)."""
    keys = [f"{h}x{h}x{c}" for h, c in ((8, 64), (4, 128), (2, 256),
                                         (1, 512))]
    table = tmp_path / "int8_ab.json"
    table.write_text(json.dumps({"decisions": {k: {"fwd": "pallas"}
                                               for k in keys}}))
    monkeypatch.setenv("MXNET_TPU_PALLAS_INT8_TABLE", str(table))
    monkeypatch.setenv("MXNET_TPU_PALLAS_INT8", "1")
    monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")


@pytest.mark.parametrize("arch,route", [("resnet18_v1", "layer"),
                                        ("resnet18_v1", "fused"),
                                        ("resnet50_v1", "layer"),
                                        ("resnet50_v1", "fused")])
def test_quantized_resnet_matches_reference(quantized, arch, route,
                                            tmp_path, monkeypatch):
    """The reference's quantized net and the port's carrying its int8
    weights and thresholds: logits within 1e-5 of the largest, argmax
    equal; on the fused route the reference's 3×3/s1 segments run its
    int8 Pallas kernel (counted by ``quant.int8.hits``)."""
    from mxnet_tpu import telemetry
    jnet, arrays, calib = quantized[arch]
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    hits0 = sum(v for k, v in telemetry.raw_snapshot()["counters"].items()
                if k.startswith("quant.int8.hits."))
    if route == "fused":
        _stage_table(tmp_path, monkeypatch)
    ref = np.asarray(jnet(mx.np.array(x))._data)
    hits1 = sum(v for k, v in telemetry.raw_snapshot()["counters"].items()
                if k.startswith("quant.int8.hits."))
    assert (hits1 > hits0) == (route == "fused")
    tnet = _port_quantized(arch, arrays, calib, _state(jnet))
    with torch.inference_mode():
        out = tnet(torch.from_numpy(x)).numpy()
    _close(out, ref, LOGIT_TOL)
    assert (out.argmax(-1) == ref.argmax(-1)).all()


def test_resnet50_calibration_sees_every_layer(quantized, monkeypatch):
    """Every one of ResNet-50 v1's 53 convs (16 of them 3×3/s1, which the
    port's v1 blocks run fused outside calibration) and its dense head
    gets its threshold from the calibration data, within 1e-5 of the
    reference's."""
    jnet, arrays, calib = quantized["resnet50_v1"]
    seen = []
    add = tq._Collector.add
    monkeypatch.setattr(tq._Collector, "add",
                        lambda self, k, x: (seen.append(k), add(self, k, x)))
    tnet = _port_quantized("resnet50_v1", arrays, calib)
    jt, tt = _twins_j(jnet), _twins_t(tnet)
    assert list(tt) == list(jt) and len(tt) == 54 and "output" in tt
    assert set(seen) == set(tt) and len(seen) == 2 * 54
    mid = [p for p, b in tt.items() if isinstance(b, tq.QuantizedConv2D)
           and tuple(b._qw.shape[:2]) == (3, 3) and b._stride == (1, 1)]
    assert len(mid) == 16 and "features.4.0.body.3" in mid
    for p in jt:
        assert abs(tt[p]._in_t - jt[p]._in_t) <= THR_RTOL * jt[p]._in_t, p


def test_state_from_numpy_refuses_a_different_structure(quantized):
    jnet, arrays, calib = quantized["resnet18_v1"]
    state = _state(jnet)
    tnet = port_net("resnet18_v1", arrays, classes=10)
    with pytest.raises(KeyError):
        tq.state_from_numpy(tnet, state)            # not quantized
    tq.quantize_net(tnet, calib_data=calib)
    state.pop("output")
    with pytest.raises(KeyError):
        tq.state_from_numpy(tnet, state)
