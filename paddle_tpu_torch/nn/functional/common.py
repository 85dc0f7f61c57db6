"""Layer functionals (port of ``linear`` and ``embedding``, dense and
row-sparse, of ``paddle_tpu/nn/functional/common.py``)."""
from __future__ import annotations

import torch

__all__ = ["linear", "embedding"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with Paddle's ``[in, out]`` weight; a plain
    product (cuBLAS on the card), as the reference leaves it to XLA."""
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def embedding(ids, weight, padding_idx=None, sparse: bool = False):
    """Rows of ``weight`` at ``ids``; rows at ``padding_idx`` are zero.
    With ``sparse`` the gradient of ``weight`` is row-sparse (the
    reference's SelectedRows): a ``torch.sparse_coo`` tensor of the rows
    ``ids`` names, duplicates included until the optimizer coalesces
    them, and zero values at ``padding_idx`` positions. As in the
    reference, that holds for a leaf weight under autograd; otherwise
    (and without ``sparse``) the gradient is dense."""
    if (sparse and weight.is_leaf and weight.requires_grad
            and torch.is_grad_enabled()):
        out = torch.nn.functional.embedding(ids, weight, sparse=True)
    else:
        out = weight[ids]
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None],
                          out.new_zeros(()), out)
    return out
