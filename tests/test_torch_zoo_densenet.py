"""DenseNet 121/161/169/201 of the port against the JAX package on the
CPU: parameter names, order and shapes after a deferred-shape forward,
and DenseNet-121's logits on shared seeded weights (helpers and
tolerance in ``test_torch_zoo.py``)."""
import pytest

pytest.importorskip("torch")

from test_torch_zoo import check_logits, check_names  # noqa: E402


@pytest.mark.parametrize("name", ["densenet121", "densenet161",
                                  "densenet169", "densenet201"])
def test_param_names_and_shapes_match_reference(name):
    check_names(name)


def test_densenet121_logits_match_reference():
    check_logits("densenet121")
