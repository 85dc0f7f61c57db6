"""Activation functionals (port of the part of
``paddle_tpu/nn/functional/activation.py`` the eager Llama uses)."""
from __future__ import annotations

import torch

__all__ = ["silu"]


def silu(x):
    """``x * sigmoid(x)``, each product in ``x.dtype`` (the reference's
    two roundings in bfloat16, not one fused op)."""
    return x * torch.sigmoid(x)
