"""Comparison, logical and bitwise ops (port of
``paddle_tpu/ops/logic.py``). None of them is differentiable."""
from __future__ import annotations

import torch

from ._op import op_fn, wrap

__all__ = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal", "logical_and", "logical_or", "logical_xor",
           "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
           "bitwise_not", "isclose", "allclose", "equal_all", "is_tensor",
           "isin"]


def _t(v, like):
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, device=like.device)


def _common(x, y):
    """``x`` and ``y`` in their promoted type (``jnp`` compares so)."""
    x, y = _t(x, y), _t(y, x)
    dt = torch.result_type(x, y)
    return x.to(dt), y.to(dt)


@op_fn(differentiable=False)
def equal(x, y):
    return torch.eq(x, y)


@op_fn(differentiable=False)
def not_equal(x, y):
    return torch.ne(x, y)


@op_fn(differentiable=False)
def less_than(x, y):
    return torch.lt(x, y)


@op_fn(differentiable=False)
def less_equal(x, y):
    return torch.le(x, y)


@op_fn(differentiable=False)
def greater_than(x, y):
    return torch.gt(x, y)


@op_fn(differentiable=False)
def greater_equal(x, y):
    return torch.ge(x, y)


@op_fn(differentiable=False)
def logical_and(x, y):
    return torch.logical_and(x, _t(y, x))


@op_fn(differentiable=False)
def logical_or(x, y):
    return torch.logical_or(x, _t(y, x))


@op_fn(differentiable=False)
def logical_xor(x, y):
    return torch.logical_xor(x, _t(y, x))


@op_fn(differentiable=False)
def logical_not(x):
    return torch.logical_not(x)


@op_fn(differentiable=False)
def bitwise_and(x, y):
    return torch.bitwise_and(x, y)


@op_fn(differentiable=False)
def bitwise_or(x, y):
    return torch.bitwise_or(x, y)


@op_fn(differentiable=False)
def bitwise_xor(x, y):
    return torch.bitwise_xor(x, y)


@op_fn(differentiable=False)
def bitwise_not(x):
    return torch.bitwise_not(x)


@op_fn(differentiable=False)
def isclose(x, y, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    x, y = _common(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    x, y = _common(x, y)
    return wrap(torch.tensor(torch.allclose(x, y, rtol=rtol, atol=atol,
                                            equal_nan=equal_nan),
                             device=x.device))


def equal_all(x, y):
    same = x.shape == y.shape and torch.equal(*_common(x, y))
    return wrap(torch.tensor(same, device=x.device))


def is_tensor(x):
    return isinstance(x, torch.Tensor)


@op_fn(differentiable=False)
def isin(x, test_x):
    return torch.isin(x, _t(test_x, x))
