"""``RMSNorm`` (port of the layer in ``paddle_tpu/nn/layer/norm.py``):
``F.rms_norm`` over the last axis, so through the fused RMSNorm
kernels."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .base import Layer

__all__ = ["RMSNorm"]


class RMSNorm(Layer):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 weight_attr=None, name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)

    def extra_repr(self):
        return f"hidden_size={self.hidden_size}, epsilon={self.epsilon}"
