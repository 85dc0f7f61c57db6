"""Dense layer functionals (port of ``linear`` and the dense
``embedding`` of ``paddle_tpu/nn/functional/common.py``)."""
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
    The gradient of ``weight`` is dense. ``sparse=True`` (the reference's
    row-sparse gradient) is not ported yet and raises."""
    if sparse:
        raise NotImplementedError(
            "embedding: sparse=True (row-sparse weight gradients) is not "
            "ported yet (ROADMAP.md queue A item 1)")
    out = weight[ids]
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None],
                          out.new_zeros(()), out)
    return out
