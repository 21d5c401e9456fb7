"""The ``nd`` namespace that extensions join — ≙ the part of
``mxnet_tpu/nd.py`` that ``tvmop.register`` and ``library.load``
``setattr`` their ops onto, plus ``Custom`` (``nd.py:480``).

The stock generated ops (``tvm_vadd``, ``tvm_vmul``, ``tvm_sigmoid``)
are here once the package is imported; a library's ops after
``library.load``.  The rest of the reference's legacy ``mx.nd`` op
surface is not ported.
"""
from __future__ import annotations


def Custom(*inputs, op_type=None, **kwargs):
    """≙ ``mx.nd.Custom``: invoke a registered custom op."""
    from .operator import Custom as _Custom
    return _Custom(*inputs, op_type=op_type, **kwargs)
