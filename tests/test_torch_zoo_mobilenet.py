"""MobileNet v1 and v2 of the port at the four width multipliers against
the JAX package on the CPU: parameter names, order and shapes after a
deferred-shape forward, and the logits of both at 0.25 on shared seeded
weights (depthwise convs: ``groups`` = channels; helpers and tolerance
in ``test_torch_zoo.py``)."""
import pytest

pytest.importorskip("torch")

from test_torch_zoo import check_logits, check_names  # noqa: E402

NAMES = ["mobilenet1.0", "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
         "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
         "mobilenetv2_0.25"]


@pytest.mark.parametrize("name", NAMES)
def test_param_names_and_shapes_match_reference(name):
    check_names(name)


@pytest.mark.parametrize("name", ["mobilenet0.25", "mobilenetv2_0.25"])
def test_logits_match_reference(name):
    check_logits(name)
