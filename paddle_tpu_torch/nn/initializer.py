"""Parameter initializers (port of ``Constant``, ``Normal`` and
``XavierUniform`` of ``paddle_tpu/nn/initializer.py``).

Each is called with a shape and a ``torch.dtype`` and returns a new
tensor on the current device, drawn in float32 from that device's seeded
generator (``framework.random``) and cast to the dtype.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..device import to_torch_device
from ..framework.random import default_generator

__all__ = ["Initializer", "Constant", "Normal", "XavierUniform"]


def _fans(shape: Sequence[int]):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]          # Paddle's linear weight [in, out]
    rf = math.prod(shape[2:])              # conv [out_c, in_c/groups, *k]
    return shape[1] * rf, shape[0] * rf


class Initializer:
    def __call__(self, shape, dtype=torch.float32):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=to_torch_device())


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32):
        dev = to_torch_device()
        t = torch.randn(tuple(shape), generator=default_generator(dev),
                        device=dev, dtype=torch.float32)
        return t.mul_(self.std).add_(self.mean).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        dev = to_torch_device()
        t = torch.empty(tuple(shape), device=dev, dtype=torch.float32)
        return t.uniform_(-limit, limit,
                          generator=default_generator(dev)).to(dtype)
