"""``Linear`` and ``Embedding`` (port of
``paddle_tpu/nn/layer/common.py``)."""
from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .base import Layer

__all__ = ["Linear", "Embedding"]


class Linear(Layer):
    """``y = x W + b`` with Paddle's weight ``[in_features,
    out_features]``; ``bias_attr=False`` leaves out the bias."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=I.XavierUniform())
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                (out_features,), attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    """Weight ``[num_embeddings, embedding_dim]``, drawn from
    ``Normal(0, 1)``; the row at ``padding_idx`` is zero. With ``sparse``
    the weight's gradient is row-sparse (``F.embedding``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse: bool = False, weight_attr=None,
                 name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        if padding_idx is not None and padding_idx < 0:
            padding_idx = num_embeddings + padding_idx
        self.padding_idx = padding_idx
        self.sparse = sparse
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx,
                           sparse=self.sparse)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"
