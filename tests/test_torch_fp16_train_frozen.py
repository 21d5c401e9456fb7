"""A frozen (``use_global_stats``) fused segment inside a half-precision
training step, in the PyTorch port against the JAX package's on the CPU.

In a half step the parameters are cast to the step's dtype but the
running statistics stay fp32 (the reference's ``cast_frozen``), so a
frozen segment folds bf16 or fp16 γ and β with fp32 μ and σ².  The
reference folds them in f32 whatever their dtypes (``pallas_block._fold``)
and so does the port: on the CPU through ``conv_affine_plain``, on the
card through the half kernels, which read each vector in its own dtype
(``test_torch_bf16_wgmma_epilogues``, ``test_torch_fp16_kernels``;
``chip_smoke.py fp16_train``'s ``frozen_segment``).

Two SGD steps of ResNet-18 v1 at 48x48 with the first residual block's
second BatchNorm frozen, through ``FusedTrainStep(dtype=...)`` in bf16
and in fp16 (``grad_scale`` 1024), on both sides from the same weights
and batches (``test_torch_resnet``'s plausible running statistics), held
by ``test_torch_bf16_train``'s rule: the port's half run no farther from
the reference's half run, op by op, than that lies from the reference's
fp32 run; the frozen statistics unchanged by the steps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from test_torch_bf16_train import (FORCED, SGD,  # noqa: E402
                                   _assert_within_reference_spread,
                                   _port_run, _reference_run, _resnet_arrays,
                                   _resnet_batches)
from test_torch_fp16_train import SCALE  # noqa: E402
from test_torch_resnet import TRAIN_ITEM  # noqa: E402

torch.set_num_threads(1)

FROZEN = "features.4.0.body.4"      # the first block's second BatchNorm


def _freeze(net):
    """Set the BatchNorm at ``FROZEN`` of a reference or port net to
    ``use_global_stats``; → the net."""
    bn = net
    for part in FROZEN.split("."):
        bn = bn[int(part)] if part.isdigit() else getattr(bn, part)
    bn._use_global_stats = True
    return net


def _jmake():
    from mxnet_tpu import models as jmodels
    net = jmodels.get_model("resnet18_v1", classes=10)
    net.initialize()
    net(mx.np.array(np.zeros((1,) + TRAIN_ITEM, np.float32)))
    return _freeze(net)


@pytest.fixture(scope="module")
def frozen_fp32_reference():
    """The reference's fp32 run of the frozen net, which both cases
    hold their half runs against: computed once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
        mp.setenv("MXNET_TPU_PALLAS_STAGES", FORCED)
        return _reference_run(_jmake, _resnet_arrays(), _resnet_batches(),
                              "sgd", SGD, None)


@pytest.mark.parametrize("dtype,scale", [("bfloat16", None),
                                         ("float16", SCALE)])
def test_frozen_segment_in_half_step_matches_reference(
        monkeypatch, dtype, scale, frozen_fp32_reference):
    """The half fused step with one frozen segment (fp32 running
    statistics beside half γ and β) runs and lies within the reference's
    own half-vs-fp32 distance of the reference's half step; the frozen
    segment's running statistics are the initial ones after both steps,
    on both sides."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
    monkeypatch.setenv("MXNET_TPU_PALLAS_STAGES", FORCED)
    from mxnet_tpu_torch import models as tmodels
    arrays = _resnet_arrays()
    batches = _resnet_batches()
    ref16 = _reference_run(_jmake, arrays, batches, "sgd", SGD, dtype,
                           scale)
    ref32 = frozen_fp32_reference
    *port, _ = _port_run(lambda: _freeze(tmodels.get_model(
        "resnet18_v1", classes=10)), arrays, batches, "sgd", SGD, dtype,
        scale)
    for stat in ("running_mean", "running_var"):
        key = f"{FROZEN}.{stat}"
        for run in (port, ref16, ref32):
            np.testing.assert_array_equal(run[1][key], arrays[key])
    _assert_within_reference_spread(tuple(port), ref16, ref32, arrays)
