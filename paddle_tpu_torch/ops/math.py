"""Elementwise and scalar math ops (port of ``paddle_tpu/ops/math.py``).

Each op computes what the reference's ``jnp`` / ``lax`` function does:
``floor_divide`` and ``mod`` follow Python's floor convention on negative
integers, integer ``divide`` gives a float, ``round`` is half-to-even.
A Python scalar beside a tensor becomes a 0-d tensor, which torch
promotes as JAX promotes a weakly typed scalar (an integer or bfloat16
tensor keeps its type against a scalar of its own kind). Rounding ops
(``floor``, ``ceil``, ``round``, ``trunc``, ``sign``), ``floor_divide``
and ``lcm`` are not differentiable, as in the reference.
"""
from __future__ import annotations

import math as _pymath

import torch

from ._op import op_fn

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "mod", "pow",
    "scale", "abs", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "square", "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "floor", "ceil",
    "round", "trunc", "frac", "sign", "reciprocal", "clip", "maximum",
    "minimum", "fmax", "fmin", "erf", "erfinv", "sigmoid", "logit", "lerp",
    "stanh", "softplus", "softsign", "cumsum", "cumprod", "cummax_values",
    "logsumexp", "logaddexp", "add_n", "isnan", "isinf", "isfinite",
    "angle", "conj", "real", "imag", "deg2rad", "rad2deg", "digamma",
    "lgamma", "polygamma", "gcd", "lcm", "heaviside", "hypot", "ldexp",
    "nan_to_num", "trapezoid", "increment",
]


def _t(v, like):
    """``v`` as a tensor on ``like``'s device (a Python scalar becomes a
    0-d tensor, promoted as JAX promotes a weak scalar)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, device=like.device)


def _float(x):
    """Integer and bool inputs of a float-valued function, as float32
    (``jnp`` promotes them so)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(torch.float32)


@op_fn
def add(x, y):
    return torch.add(x, y)


@op_fn
def subtract(x, y):
    return torch.sub(x, y)


@op_fn
def multiply(x, y):
    return torch.mul(x, y)


@op_fn
def divide(x, y):
    return torch.true_divide(x, y)


@op_fn(differentiable=False)
def floor_divide(x, y):
    return torch.floor_divide(x, y)


@op_fn
def mod(x, y):
    return torch.remainder(x, y)


remainder = mod


@op_fn
def pow(x, y):
    return torch.pow(x, y)


@op_fn
def scale(x, *, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@op_fn
def abs(x):
    return torch.abs(x)


@op_fn
def exp(x):
    return torch.exp(x)


@op_fn
def expm1(x):
    return torch.expm1(x)


@op_fn
def log(x):
    return torch.log(x)


@op_fn
def log2(x):
    return torch.log2(x)


@op_fn
def log10(x):
    return torch.log10(x)


@op_fn
def log1p(x):
    return torch.log1p(x)


@op_fn
def sqrt(x):
    return torch.sqrt(x)


@op_fn
def rsqrt(x):
    return torch.rsqrt(x)


@op_fn
def square(x):
    return torch.square(x)


@op_fn
def sin(x):
    return torch.sin(x)


@op_fn
def cos(x):
    return torch.cos(x)


@op_fn
def tan(x):
    return torch.tan(x)


@op_fn
def asin(x):
    return torch.asin(x)


@op_fn
def acos(x):
    return torch.acos(x)


@op_fn
def atan(x):
    return torch.atan(x)


@op_fn
def atan2(x, y):
    return torch.atan2(_float(x), _t(y, x))


@op_fn
def sinh(x):
    return torch.sinh(x)


@op_fn
def cosh(x):
    return torch.cosh(x)


@op_fn
def tanh(x):
    return torch.tanh(x)


@op_fn
def asinh(x):
    return torch.asinh(x)


@op_fn
def acosh(x):
    return torch.acosh(x)


@op_fn
def atanh(x):
    return torch.atanh(x)


def _rounded(f, x):
    """``f`` of a float tensor; an integer one is already whole."""
    return f(x) if x.is_floating_point() else x.clone()


@op_fn(differentiable=False)
def floor(x):
    return _rounded(torch.floor, x)


@op_fn(differentiable=False)
def ceil(x):
    return _rounded(torch.ceil, x)


@op_fn(differentiable=False)
def round(x):
    return _rounded(torch.round, x)


@op_fn(differentiable=False)
def trunc(x):
    return _rounded(torch.trunc, x)


@op_fn
def frac(x):
    return x - _rounded(torch.trunc, x)


@op_fn(differentiable=False)
def sign(x):
    if x.is_floating_point():
        # IEEE sign: NaN stays NaN (torch's CPU sign gives 0 there)
        return torch.where(torch.isnan(x), x, torch.sign(x))
    return torch.sign(x)


@op_fn
def reciprocal(x):
    return 1.0 / x


@op_fn
def clip(x, *, min=None, max=None):
    if min is not None:
        x = torch.maximum(x, _t(min, x))
    if max is not None:
        x = torch.minimum(x, _t(max, x))
    return x


@op_fn
def maximum(x, y):
    return torch.maximum(_t(x, y), _t(y, x))


@op_fn
def minimum(x, y):
    return torch.minimum(_t(x, y), _t(y, x))


@op_fn
def fmax(x, y):
    return torch.fmax(_t(x, y), _t(y, x))


@op_fn
def fmin(x, y):
    return torch.fmin(_t(x, y), _t(y, x))


@op_fn
def erf(x):
    return torch.erf(x)


@op_fn
def erfinv(x):
    return torch.erfinv(x)


@op_fn
def sigmoid(x):
    return torch.sigmoid(x)


@op_fn
def logit(x, *, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@op_fn
def lerp(x, y, weight):
    return x + weight * (y - x)


@op_fn
def stanh(x, *, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@op_fn
def softplus(x, *, beta=1.0, threshold=20.0):
    # the untaken branch is clamped, so exp cannot overflow into its grad
    safe = torch.clamp(x * beta, max=threshold)
    return torch.where(x * beta > threshold, x, torch.log1p(torch.exp(safe))
                       / beta)


@op_fn
def softsign(x):
    return x / (1.0 + torch.abs(x))


def _scan(f, x, axis):
    """A cumulative op as ``jnp``'s: small integers and bool widen to the
    default integer (int64 here); a half type accumulates in float32 and
    rounds once."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    if x.dtype in (torch.float16, torch.bfloat16):
        return f(x, axis, dtype=torch.float32).to(x.dtype)
    if not (x.is_floating_point() or x.is_complex()):
        return f(x, axis, dtype=torch.int64)
    return f(x, axis)


@op_fn
def cumsum(x, *, axis=None):
    return _scan(torch.cumsum, x, axis)


@op_fn
def cumprod(x, *, dim=None):
    return _scan(torch.cumprod, x, dim)


@op_fn
def cummax_values(x, *, axis=None):
    return torch.cummax(x, axis if axis is not None else 0).values


@op_fn
def logsumexp(x, *, axis=None, keepdim=False):
    if x.ndim == 0:
        return x.clone()
    dims = (tuple(range(x.ndim)) if axis is None else
            tuple(axis) if isinstance(axis, (list, tuple)) else (axis,))
    return torch.logsumexp(_float(x), dims, keepdim=keepdim)


@op_fn
def logaddexp(x, y):
    return torch.logaddexp(_float(_t(x, y)), _float(_t(y, x)))


def add_n(inputs):
    """``paddle.add_n``: the sum of a list of tensors, one ``add`` at a
    time."""
    if isinstance(inputs, torch.Tensor):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = add(out, t)
    return out


@op_fn(differentiable=False)
def isnan(x):
    return torch.isnan(x)


@op_fn(differentiable=False)
def isinf(x):
    return torch.isinf(x)


@op_fn(differentiable=False)
def isfinite(x):
    return torch.isfinite(x)


@op_fn
def angle(x):
    if x.is_complex():
        return torch.angle(x)
    x = _float(x)
    return torch.atan2(torch.zeros_like(x), x)


@op_fn
def conj(x):
    return torch.conj_physical(x) if x.is_complex() else x.clone()


@op_fn
def real(x):
    return torch.real(x).clone() if x.is_complex() else x.clone()


@op_fn
def imag(x):
    return torch.imag(x).clone() if x.is_complex() else torch.zeros_like(x)


@op_fn
def deg2rad(x):
    return _float(x) * (_pymath.pi / 180.0)


@op_fn
def rad2deg(x):
    return _float(x) * (180.0 / _pymath.pi)


@op_fn
def digamma(x):
    return torch.digamma(_float(x))


@op_fn
def lgamma(x):
    return torch.lgamma(_float(x))


@op_fn
def polygamma(x, *, n=0):
    return torch.polygamma(n, _float(x))


@op_fn
def gcd(x, y):
    return torch.gcd(x, _t(y, x))


@op_fn(differentiable=False)
def lcm(x, y):
    return torch.lcm(x, _t(y, x))


@op_fn
def heaviside(x, y):
    y = _t(y, x)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.heaviside(x.to(dt), y.to(dt))


@op_fn
def hypot(x, y):
    return torch.hypot(_float(x), _float(_t(y, x)))


@op_fn
def ldexp(x, y):
    return x * torch.pow(2.0, _t(y, x))


@op_fn
def nan_to_num(x, *, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@op_fn
def trapezoid(y, *, dx=1.0, axis=-1):
    return torch.trapezoid(_float(y), dx=dx, dim=axis)


def increment(x, value=1.0):
    """``paddle.increment``: adds ``value`` to ``x`` in place, outside
    autograd (step counters and other bookkeeping tensors)."""
    with torch.no_grad():
        x.add_(value)
    return x
