"""Normalisation functionals (port of the RMSNorm part of
``paddle_tpu/nn/functional/norm.py``).

``rms_norm`` calls the fused RMSNorm's dispatcher
(``kernels.dispatched_rms_norm``, the reference's ``_FUSED_RMS_IMPL``
seam filled by ``kernels.register``; the port has one implementation,
so it calls it directly): the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors. A missing weight is a weight of ones, which
leaves the kernel's float32 product unchanged; another axis than the
last is moved last for the kernel when there is no weight. Only a CPU
tensor takes the reference's plain math, for a weight with another axis
than the last; a CUDA tensor raises there.
"""
from __future__ import annotations

import torch

from ...core import enforce as E
from ...kernels import dispatched_rms_norm

__all__ = ["rms_norm"]


def rms_norm(x, weight=None, epsilon: float = 1e-6, axis: int = -1):
    """RMSNorm over ``axis`` (reference: incubate ``fused_rms_norm``),
    float32 statistics, in the result type of ``x`` and ``weight``."""
    axis = axis % x.ndim
    if weight is None:
        ones = torch.ones(x.shape[axis], dtype=x.dtype, device=x.device)
        y = dispatched_rms_norm(x.movedim(axis, -1).contiguous(), ones,
                                epsilon)
        return y.movedim(-1, axis)
    if axis == x.ndim - 1:
        return dispatched_rms_norm(x, weight, epsilon)
    # the weight broadcasts against x in x's own layout, so the axis
    # cannot be moved for the kernel
    E.enforce(x.device.type == "cpu",
              f"rms_norm: the CUDA kernel normalises the last axis; with a "
              f"weight, axis must be the last, got axis {axis} of x "
              f"{tuple(x.shape)}", error=E.InvalidArgumentError)
    xf = x.float()
    ms = (xf * xf).mean(dim=axis, keepdim=True)
    return (xf * torch.rsqrt(ms + epsilon)).to(x.dtype) * weight
