"""Row-sparse storage (≙ the ``RowSparseNDArray`` of
``mxnet_tpu/sparse.py``), the subset the lazy optimizer update needs.

A :class:`RowSparseNDArray` is a dense ``shape`` of which only the rows
at ``indices`` may be non-zero, held as those rows (``data``) and their
ids (``indices``: int64, sorted, on the device of ``data``).  It is what
``Trainer`` hands ``Optimizer.update`` for a ``grad_stype =
"row_sparse"`` parameter.  CSR storage, sparse products and the rest of
the reference's ``sparse`` module are not ported.
"""
from __future__ import annotations

import torch

__all__ = ["RowSparseNDArray"]


class RowSparseNDArray:
    """Rows ``values`` (``len(indices)`` × the trailing dims of ``shape``)
    at row ids ``indices`` of a dense ``shape``."""

    def __init__(self, values, indices, shape):
        self.data = torch.as_tensor(values)
        self.indices = torch.as_tensor(indices, device=self.data.device) \
            .long()
        self.shape = tuple(shape)
        if self.data.shape != (len(self.indices),) + self.shape[1:]:
            raise ValueError(f"RowSparseNDArray: values "
                             f"{tuple(self.data.shape)} are not "
                             f"{len(self.indices)} rows of {self.shape}")

    @property
    def stype(self) -> str:
        return "row_sparse"

    @staticmethod
    def from_dense(t: torch.Tensor) -> "RowSparseNDArray":
        """The rows of ``t`` that hold a non-zero entry (NaN counts as
        non-zero), on ``t``'s device.  On the card ``nonzero`` waits for
        the device once, to learn how many rows there are."""
        rows = t.ne(0).reshape(t.shape[0], -1).any(dim=1).nonzero()[:, 0]
        return RowSparseNDArray(t.index_select(0, rows), rows, t.shape)

    def tostype(self, stype):
        """``"default"``: the dense tensor; ``"row_sparse"``: itself."""
        if stype == "row_sparse":
            return self
        if stype != "default":
            raise ValueError(f"tostype({stype!r}): only 'default' and "
                             f"'row_sparse' are ported")
        dense = self.data.new_zeros(self.shape)
        return dense.index_copy_(0, self.indices, self.data)
