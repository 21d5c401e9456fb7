"""Two SGD steps of ResNet-18 v1 through the port against the JAX
package with every stage routed to the reference's fused Pallas
pipeline (interpret mode on the CPU): conv + batch statistics, the
affine pass, and the Pallas dgrad/wgrad backward, where the port runs
the plain versions of its training kernels.  The reference's net is
hybridized and its tape's backward compiled (``compiled_backward``): its
forward and backward compile as two programs rather than as one program
a primitive and shape.  Its own file so that it
runs beside the other slice tests, not after them."""
import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu.gluon import nn as jgnn  # noqa: E402
from test_torch_resnet import (assert_two_steps_match,  # noqa: E402
                               compiled_backward, two_sgd_steps)

torch.set_num_threads(1)


def test_two_sgd_steps_of_resnet18_match_forced_pallas_route(monkeypatch):
    compiled_backward(monkeypatch)
    monkeypatch.setenv("MXNET_TPU_PALLAS_BLOCK", "1")
    monkeypatch.setenv(
        "MXNET_TPU_PALLAS_STAGES",
        "12x12x64=pallas,6x6x128=pallas,3x3x256=pallas,2x2x512=pallas")
    assert jgnn.fused_block_active()
    assert_two_steps_match(*two_sgd_steps("resnet18_v1", hybridize=True))
