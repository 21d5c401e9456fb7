"""bf16 training through ``parallel.FusedTrainStep(dtype="bfloat16")`` in
the PyTorch port against the JAX package's on the CPU: two SGD steps of
ResNet-18 v1 at 48x48 (the damped-residual init of
``test_torch_resnet``; the reference's fused blocks on their Pallas route
in interpret mode) and of ``bert_small``, from the same numpy weights
and batches; the loss scaling of ``grad_scale``; and the master weights'
dtypes (``bert_small`` and ``grad_scale`` in
``test_torch_bf16_train_bert.py``, which shares these helpers).  On the
card the same step is one captured CUDA graph, which ``chip_smoke.py
bf16_train`` drives at full width.

The oracle.  The port rounds each bf16 op where the reference's eager
ops round.  The reference's step is one jitted XLA program, which keeps
some intermediates in fp32 (as its jitted bf16 forward does: 1.1% of
the largest logit from its eager forward on ``bert_small``); run op by
op (``jax.disable_jit()``), the same step rounds every op.  So the
oracle is the reference's ``FusedTrainStep(dtype="bfloat16")`` run op by
op, each of its Pallas kernels one compiled program (bit for bit the
kernel interpreted op by op: a kernel's body rounds where it says).  No
cap below one bf16 step can hold two bf16 steps together, so each test
computes the reference's own distance between that bf16 step and its
fp32 step on the same inputs, and holds the port's bf16 step to no more
than that distance from the reference's bf16 step: the losses of both
steps, and every master weight and running statistic after them
(largest absolute difference over the net).  On ResNet-18 the jitted
bf16 step is as far from the op-by-op one (0.0127 in the losses, 0.0073
in the weights) as from the fp32 step (0.0101, 0.0072); the port lies
0.0016 and 0.0034 from the op-by-op step, 0.0112 and 0.0063 from the
jitted one."""
import contextlib
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import optimizer as jopt  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.gluon import loss as jloss  # noqa: E402
from mxnet_tpu_torch import optimizer as topt  # noqa: E402
from mxnet_tpu_torch.gluon import load_numpy  # noqa: E402
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss  # noqa
from mxnet_tpu_torch.parallel import FusedTrainStep  # noqa: E402
from test_torch_resnet import TRAIN_ITEM, TRAIN_LR, reference_net  # noqa

torch.set_num_threads(1)

FORCED = "12x12x64=pallas,6x6x128=pallas,3x3x256=pallas,2x2x512=pallas"
SGD = {"learning_rate": TRAIN_LR, "momentum": 0.9, "wd": 1e-4}


def _resnet_arrays():
    """ResNet-18 v1 (10 classes) seeded weights, each residual branch's
    last BatchNorm γ damped by 0.1 (``test_torch_resnet``'s init)."""
    jnet, arrays = reference_net("resnet18_v1", seed=5, classes=10)
    for k in arrays:
        if k.endswith(".body.4.gamma"):
            arrays[k] = (0.1 * arrays[k]).astype(np.float32)
    return arrays


def _resnet_batches():
    rs = np.random.RandomState(6)
    return [(rs.rand(2, *TRAIN_ITEM).astype(np.float32),
             rs.randint(0, 10, (2,))) for _ in range(2)]


@contextlib.contextmanager
def _compiled_pallas_kernels():
    """Run each of the reference's fused-block Pallas kernels
    (``pallas_block``'s ``pallas_call``s, interpret mode) as one compiled
    program, built once per kernel, grid, blocks and operand shapes,
    also inside ``jax.disable_jit()``.  A kernel's body rounds where it
    says, so its values are bit for bit those of interpreting it op by
    op; what goes is the Python interpretation of every kernel call."""
    from mxnet_tpu.ops import pallas_block as pb
    real = pb.pl
    cache = {}

    def blocks(specs):
        specs = specs if isinstance(specs, (list, tuple)) else [specs]
        return tuple(getattr(sp, "block_shape", None) for sp in specs)

    def pallas_call(kernel, **kw):
        call = real.pallas_call(kernel, **kw)
        if not isinstance(kernel, functools.partial):
            return call

        def run(*args):
            key = (kernel.func.__qualname__,
                   tuple(sorted(kernel.keywords.items())), kw.get("grid"),
                   blocks(kw.get("in_specs", ())),
                   blocks(kw.get("out_specs", ())),
                   repr(kw.get("out_shape")),
                   tuple((a.shape, str(a.dtype)) for a in args))
            fn = cache.get(key)
            if fn is None:
                fn = cache[key] = jax.jit(call)
            with jax.disable_jit(False):
                return fn(*args)
        return run

    pb.pl = types.SimpleNamespace(
        **{k: getattr(real, k) for k in dir(real) if not k.startswith("__")})
    pb.pl.pallas_call = pallas_call
    try:
        yield
    finally:
        pb.pl = real


def _reference_run(make, arrays, batches, opt, kw, dtype, grad_scale=None):
    """The reference's ``FusedTrainStep`` over ``batches`` from
    ``arrays``, run op by op when ``dtype`` is set (the module's note),
    its Pallas kernels each compiled once (``_compiled_pallas_kernels``):
    → (losses, {name: array after}).  The net is made (and its deferred
    shapes inferred) before, on the layer route: that forward's output
    and the weights it starts from are replaced by ``arrays``."""
    with _plain_route():
        jnet = make()
    if dtype is None:
        return _reference_steps(jnet, arrays, batches, opt, kw, dtype,
                                grad_scale)
    with jax.disable_jit(), _compiled_pallas_kernels():
        return _reference_steps(jnet, arrays, batches, opt, kw, dtype,
                                grad_scale)


@contextlib.contextmanager
def _plain_route():
    """The reference's layer route (no Pallas kernel) for a while."""
    import os
    was = os.environ.get("MXNET_TPU_PALLAS_BLOCK")
    os.environ["MXNET_TPU_PALLAS_BLOCK"] = "0"
    try:
        yield
    finally:
        if was is None:
            del os.environ["MXNET_TPU_PALLAS_BLOCK"]
        else:
            os.environ["MXNET_TPU_PALLAS_BLOCK"] = was


def _reference_steps(jnet, arrays, batches, opt, kw, dtype, grad_scale):
    for k, p in jnet.collect_params().items():
        p.set_data(jnp.asarray(arrays[k]))
    jnet.hybridize()
    step = jpar.FusedTrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                               jopt.create(opt, **kw), dtype=dtype,
                               grad_scale=grad_scale)
    losses = [float(np.asarray(step(mx.np.array(x), mx.np.array(y))._data))
              for x, y in batches]
    return losses, {k: np.asarray(p.data()._data).astype(np.float32)
                    for k, p in jnet.collect_params().items()}


def _port_run(make, arrays, batches, opt, kw, dtype, grad_scale=None):
    """The port's ``FusedTrainStep`` the same way (its CPU leg: the step
    function run directly)."""
    tnet = make()
    load_numpy(tnet, arrays)
    tnet.hybridize()
    step = FusedTrainStep(tnet, SoftmaxCrossEntropyLoss(),
                          topt.create(opt, **kw), dtype=dtype,
                          grad_scale=grad_scale)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in batches]
    after = {k: t.detach().numpy().copy()
             for k, t in tnet.collect_params().items()}
    return losses, after, tnet


def _dist(a, b):
    """(largest loss difference, largest weight difference) of two runs."""
    (la, wa), (lb, wb) = a, b
    assert list(wa) == list(wb)
    return (max(abs(x - y) for x, y in zip(la, lb)),
            max(np.abs(wa[k] - wb[k]).max() for k in wa))


def _assert_within_reference_spread(port, ref16, ref32, arrays):
    """The port's bf16 run no farther from the reference's bf16 run than
    that is from the reference's fp32 run; both runs moved every net."""
    for losses, after in (port, ref16, ref32):
        assert all(np.isfinite(v) for v in losses)
        assert all(np.isfinite(a).all() for a in after.values())
    moved = max(np.abs(port[1][k] - arrays[k]).max() for k in arrays)
    assert moved > 0
    d_port = _dist(port, ref16)
    d_ref = _dist(ref16, ref32)
    assert d_port[0] <= d_ref[0], ("losses", d_port, d_ref)
    assert d_port[1] <= d_ref[1], ("weights", d_port, d_ref)
    return d_port, d_ref


def test_resnet18_bf16_fused_step_matches_reference(monkeypatch):
    """Two SGD steps (momentum 0.9, wd 1e-4) of ResNet-18 v1 at 48x48,
    batch 2, through ``FusedTrainStep(dtype="bfloat16")`` on both sides:
    the port's losses and fp32 masters within the reference's own
    bf16-vs-fp32 distance of the reference's bf16 step (see the module's
    note); the masters stay fp32 and the running statistics fp32."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
    monkeypatch.setenv("MXNET_TPU_PALLAS_STAGES", FORCED)
    from mxnet_tpu import models as jmodels
    from mxnet_tpu_torch import models as tmodels
    arrays = _resnet_arrays()
    batches = _resnet_batches()

    def jmake():
        net = jmodels.get_model("resnet18_v1", classes=10)
        net.initialize()
        net(mx.np.array(np.zeros((1,) + TRAIN_ITEM, np.float32)))
        return net
    ref16 = _reference_run(jmake, arrays, batches, "sgd", SGD, "bfloat16")
    ref32 = _reference_run(jmake, arrays, batches, "sgd", SGD, None)
    *port, tnet = _port_run(lambda: tmodels.get_model("resnet18_v1",
                                                      classes=10),
                            arrays, batches, "sgd", SGD, "bfloat16")
    assert all(t.dtype == torch.float32
               for t in tnet.collect_params().values())
    _assert_within_reference_spread(tuple(port), ref16, ref32, arrays)
