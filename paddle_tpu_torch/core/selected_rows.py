"""Row-sparse gradients: ``SelectedRows`` (port of
``paddle_tpu/core/selected_rows.py``).

A ``{rows, values}`` pair standing for the mostly-zero dense tensor
``zeros(dense_shape).index_add(0, rows, values)``: what the sparse
embedding backward gives and the sparse optimizer rules take. In the
port that gradient is torch's own coalesced-or-not ``torch.sparse_coo``
tensor of one sparse dimension (``nn/functional/common.py`` embedding,
``optimizer/optimizer.py``); ``SelectedRows`` is the reference's view of
it, with ``from_sparse`` / ``to_sparse`` between the two.

The reference's ``SelectedRowsGrad`` (a ``Tensor`` subclass that
densifies on first dense access) has no counterpart: a sparse torch
gradient already is one, and ``grad.to_dense()`` is that access.
"""
from __future__ import annotations

import torch

from . import enforce as E

__all__ = ["SelectedRows", "is_selected_rows"]


class SelectedRows:
    """``rows`` ``[N]`` integer (duplicates allowed until ``coalesce``),
    ``values`` ``[N, *tail]``, ``dense_shape`` ``(V, *tail)``."""

    __slots__ = ("rows", "values", "dense_shape")

    def __init__(self, rows, values, dense_shape):
        self.rows = rows
        self.values = values
        self.dense_shape = tuple(int(s) for s in dense_shape)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nbytes(self) -> int:
        return (self.rows.numel() * self.rows.element_size()
                + self.values.numel() * self.values.element_size())

    def to_dense(self):
        """The dense tensor; rows at or past ``dense_shape[0]`` (the
        sentinel of ``coalesce``) are dropped."""
        keep = self.rows < self.dense_shape[0]
        dense = self.values.new_zeros(self.dense_shape)
        return dense.index_add(0, self.rows[keep].long(), self.values[keep])

    def coalesce(self) -> "SelectedRows":
        """Merge duplicate rows by a segment sum on the device, with no
        host read: same-length arrays where slot ``j < n_unique`` holds
        the ``j``-th smallest row and its summed values, and the other
        slots the sentinel row ``dense_shape[0]`` with zero values (the
        reference's layout)."""
        n = int(self.rows.shape[0])
        if n <= 1:
            return self
        order = torch.argsort(self.rows, stable=True)
        r = self.rows[order]
        v = self.values[order]
        is_start = torch.cat([torch.ones(1, dtype=torch.bool,
                                         device=r.device), r[1:] != r[:-1]])
        seg = torch.cumsum(is_start, 0) - 1
        summed = torch.zeros_like(v).index_add(0, seg, v)
        rows_out = torch.full((n,), self.dense_shape[0], dtype=r.dtype,
                              device=r.device).scatter(0, seg, r)
        return SelectedRows(rows_out, summed, self.dense_shape)

    def with_values(self, values) -> "SelectedRows":
        return SelectedRows(self.rows, values, self.dense_shape)

    @classmethod
    def from_sparse(cls, g) -> "SelectedRows":
        """The rows and values of a ``torch.sparse_coo`` tensor with one
        sparse dimension (coalesced or not)."""
        E.enforce(g.is_sparse and g.sparse_dim() == 1,
                  "SelectedRows.from_sparse takes a sparse_coo tensor with "
                  "one sparse dimension", error=E.InvalidArgumentError)
        return cls(g._indices()[0], g._values(), g.shape)

    def to_sparse(self):
        """The coalesced ``torch.sparse_coo`` tensor (sentinel rows
        dropped), the gradient the port's optimizers take."""
        keep = self.rows < self.dense_shape[0]
        return torch.sparse_coo_tensor(
            self.rows[keep].long()[None], self.values[keep],
            self.dense_shape).coalesce()

    # SR + SR concatenates (the tape's accumulation); SR + dense densifies
    def __add__(self, other):
        if isinstance(other, SelectedRows):
            E.enforce(other.dense_shape == self.dense_shape,
                      f"SelectedRows shape mismatch: {self.dense_shape} vs "
                      f"{other.dense_shape}", error=E.InvalidArgumentError)
            return SelectedRows(torch.cat([self.rows, other.rows]),
                                torch.cat([self.values, other.values]),
                                self.dense_shape)
        return self.to_dense() + other

    __radd__ = __add__

    def __repr__(self):
        return (f"SelectedRows(n={self.rows.shape[0]}, "
                f"dense_shape={self.dense_shape}, dtype={self.dtype})")


def is_selected_rows(t) -> bool:
    """True for a ``SelectedRows`` and for a row-sparse torch gradient
    (a ``sparse_coo`` tensor of one sparse dimension)."""
    if isinstance(t, SelectedRows):
        return True
    return isinstance(t, torch.Tensor) and t.is_sparse and t.sparse_dim() == 1
