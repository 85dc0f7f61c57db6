"""Parameter initializers (port of ``paddle_tpu/nn/initializer.py``).

Each is called with a shape and a ``torch.dtype`` and returns a new
tensor on the current device; the random ones draw in float32 from that
device's seeded generator (``framework.random``) and cast to the dtype,
so their numbers differ from JAX's for the same seed (tests hold them to
their distributions). ``set_global_initializer`` sets the weight and bias
initializers that ``Layer.create_parameter`` takes before a caller's
default.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..core import enforce as E
from ..device import to_torch_device
from ..framework.random import default_generator

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "Bilinear", "calculate_gain",
    "set_global_initializer", "global_initializer",
]

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def global_initializer(is_bias=False):
    return _global_bias_init if is_bias else _global_weight_init


def calculate_gain(nonlinearity: str, param=None) -> float:
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "conv_transpose1d": 1.0, "conv_transpose2d": 1.0,
             "conv_transpose3d": 1.0, "tanh": 5.0 / 3.0,
             "relu": math.sqrt(2.0), "selu": 3.0 / 4.0}
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    return gains.get(nonlinearity, 1.0)


def _fans(shape: Sequence[int]):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]          # Paddle's linear weight [in, out]
    rf = math.prod(shape[2:])              # conv [out_c, in_c/groups, *k]
    return shape[1] * rf, shape[0] * rf


def _randn(shape):
    dev = to_torch_device()
    return torch.randn(tuple(shape), generator=default_generator(dev),
                       device=dev, dtype=torch.float32)


def _uniform(shape, low, high):
    dev = to_torch_device()
    t = torch.empty(tuple(shape), device=dev, dtype=torch.float32)
    return t.uniform_(low, high, generator=default_generator(dev))


def _from_numpy(a, dtype):
    return torch.as_tensor(a, device=to_torch_device()).to(dtype)


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
        return _randn(shape).mul_(self.std).add_(self.mean).to(dtype)


class TruncatedNormal(Initializer):
    """``mean + std * r``, ``r`` a standard normal truncated to ``[a,
    b]``."""

    def __init__(self, mean: float = 0.0, std: float = 1.0, a: float = -2.0,
                 b: float = 2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=torch.float32):
        dev = to_torch_device()
        r = torch.empty(tuple(shape), device=dev, dtype=torch.float32)
        torch.nn.init.trunc_normal_(r, 0.0, 1.0, self.a, self.b,
                                    generator=default_generator(dev))
        return r.mul_(self.std).add_(self.mean).to(dtype)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32):
        return _uniform(shape, self.low, self.high).to(dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _randn(shape).mul_(std).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit).to(dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=torch.float32):
        fi = self.fan_in or _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return _randn(shape).mul_(gain / math.sqrt(fi)).to(dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype=torch.float32):
        fi = self.fan_in or _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit).to(dtype)


class Assign(Initializer):
    """The given value (array-like or tensor), reshaped to ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=torch.float32):
        v = self.value
        a = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        return _from_numpy(a, dtype).reshape(tuple(shape))


class Orthogonal(Initializer):
    """``gain`` times the Q of a QR factorisation of a standard normal
    ``[max(rows, cols), min(rows, cols)]``, its columns signed by R's
    diagonal, over ``shape[0]`` rows and the rest flattened."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype=torch.float32):
        if len(shape) < 2:
            raise E.InvalidArgumentError("Orthogonal init needs >=2 dims")
        rows = shape[0]
        cols = math.prod(shape[1:])
        a = _randn((max(rows, cols), min(rows, cols)))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols].reshape(tuple(shape))).to(dtype)


class Dirac(Initializer):
    """The identity of a convolution ``[out, in, *k]``: a 1 at each
    kernel's centre on the diagonal of every group."""

    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, dtype=torch.float32):
        w = np.zeros(shape, dtype=np.float32)
        out_c, in_c = shape[0], shape[1]
        og = out_c // self.groups
        centers = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(og, in_c)):
                w[(g * og + i, i) + centers] = 1.0
        return _from_numpy(w, dtype)


class Bilinear(Initializer):
    """The bilinear-upsampling filter of a transposed convolution's
    weight ``[C_out, C_in, kH, kW]``: one separable triangle kernel in
    every (out, in) pair."""

    def __call__(self, shape, dtype=torch.float32):
        if len(shape) != 4:
            raise E.InvalidArgumentError(
                f"Bilinear expects a 4-D conv weight shape, got {shape}")
        kh, kw = shape[2], shape[3]

        def tri(k):
            f = (k + 1) // 2
            center = f - 1 if k % 2 == 1 else f - 0.5
            return 1 - np.abs(np.arange(k) - center) / f

        kernel = np.outer(tri(kh), tri(kw)).astype(np.float32)
        w = np.broadcast_to(kernel, tuple(shape)).copy()
        return _from_numpy(w, dtype)


# the fluid-era names the reference binds to the same classes
ConstantInitializer = Constant
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
UniformInitializer = Uniform
XavierInitializer = XavierUniform
MSRAInitializer = KaimingUniform
NumpyArrayInitializer = Assign
__all__ += ["ConstantInitializer", "NormalInitializer",
            "TruncatedNormalInitializer", "UniformInitializer",
            "XavierInitializer", "MSRAInitializer", "NumpyArrayInitializer"]
