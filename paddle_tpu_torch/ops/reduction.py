"""Reduction ops (port of ``paddle_tpu/ops/reduction.py``).

``axis`` is an int, a list / tuple of ints or None (every axis).
``median`` averages the two middle values of an even count (``jnp``'s,
not ``torch.median``'s lower one); ``std`` / ``var`` are unbiased by
default; ``argmax`` / ``argmin`` give ``int64`` (Paddle's ``dtype``
argument). Integer sums accumulate in ``int64``.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ._op import op_fn

__all__ = ["sum", "mean", "max", "min", "prod", "amax", "amin", "nansum",
           "nanmean", "all", "any", "argmax", "argmin", "std", "var",
           "median", "quantile", "count_nonzero", "kthvalue_values"]


def _dims(axis, ndim):
    """``axis`` as a tuple of dims (None: all of them)."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(a % ndim if ndim else a for a in axis)
    return (axis % ndim if ndim else axis,)


def _float(x):
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(torch.float32)


def _to_last(x, axis):
    """``x`` with the reduced axes moved last and merged into one; the
    result's kept shape for ``keepdim``."""
    dims = _dims(axis, x.ndim)
    keep = [1 if d in dims else s for d, s in enumerate(x.shape)]
    rest = [d for d in range(x.ndim) if d not in dims]
    y = x.permute(*rest, *dims).reshape(*[x.shape[d] for d in rest], -1)
    return y, keep


@op_fn(name="sum")
def sum(x, *, axis=None, keepdim=False, dtype=None):
    if x.ndim == 0:
        return x.to(dtypes.convert_dtype(dtype) or x.dtype).clone()
    return torch.sum(x, _dims(axis, x.ndim), keepdim=keepdim,
                     dtype=dtypes.convert_dtype(dtype))


@op_fn
def mean(x, *, axis=None, keepdim=False):
    x = _float(x)
    if x.ndim == 0:
        return x.clone()
    return torch.mean(x, _dims(axis, x.ndim), keepdim=keepdim)


@op_fn(name="max")
def max(x, *, axis=None, keepdim=False):
    return torch.amax(x, _dims(axis, x.ndim), keepdim=keepdim)


@op_fn(name="min")
def min(x, *, axis=None, keepdim=False):
    return torch.amin(x, _dims(axis, x.ndim), keepdim=keepdim)


@op_fn
def prod(x, *, axis=None, keepdim=False, dtype=None):
    dt = dtypes.convert_dtype(dtype)
    if x.ndim == 0:
        return x.to(dt or x.dtype).clone()
    y, keep = _to_last(x, axis)
    out = torch.prod(y, -1, dtype=dt)
    return out.reshape(keep) if keepdim else out


@op_fn
def amax(x, *, axis=None, keepdim=False):
    return torch.amax(x, _dims(axis, x.ndim), keepdim=keepdim)


@op_fn
def amin(x, *, axis=None, keepdim=False):
    return torch.amin(x, _dims(axis, x.ndim), keepdim=keepdim)


@op_fn
def nansum(x, *, axis=None, keepdim=False):
    if x.ndim == 0:
        return torch.nan_to_num(x, nan=0.0) if x.is_floating_point() \
            else x.clone()
    return torch.nansum(x, _dims(axis, x.ndim), keepdim=keepdim)


@op_fn
def nanmean(x, *, axis=None, keepdim=False):
    x = _float(x)
    if x.ndim == 0:
        return x.clone()
    return torch.nanmean(x, _dims(axis, x.ndim), keepdim=keepdim)


@op_fn(name="all", differentiable=False)
def all(x, *, axis=None, keepdim=False):
    b = x if x.dtype == torch.bool else x != 0
    if b.ndim == 0:
        return b.clone()
    return torch.all(b, _dims(axis, b.ndim), keepdim=keepdim)


@op_fn(name="any", differentiable=False)
def any(x, *, axis=None, keepdim=False):
    b = x if x.dtype == torch.bool else x != 0
    if b.ndim == 0:
        return b.clone()
    return torch.any(b, _dims(axis, b.ndim), keepdim=keepdim)


def _arg(f, x, axis, keepdim, dtype):
    dt = dtypes.convert_dtype(dtype)
    if axis is None:
        out = f(x.reshape(-1), 0)
        if keepdim:
            out = out.reshape([1] * x.ndim)
    else:
        out = f(x, axis, keepdim=keepdim)
    return out.to(dt)


@op_fn(differentiable=False)
def argmax(x, *, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


@op_fn(differentiable=False)
def argmin(x, *, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


@op_fn
def std(x, *, axis=None, unbiased=True, keepdim=False):
    x = _float(x)
    return torch.std(x, _dims(axis, x.ndim) if x.ndim else None,
                     correction=1 if unbiased else 0, keepdim=keepdim)


@op_fn
def var(x, *, axis=None, unbiased=True, keepdim=False):
    x = _float(x)
    return torch.var(x, _dims(axis, x.ndim) if x.ndim else None,
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _quantile(x, q, axis, keepdim):
    """``jnp.quantile``'s linear interpolation; a half type computes in
    float32 (``torch.quantile`` takes float32 / float64) and rounds
    once."""
    x = _float(x)
    dt = x.dtype
    if dt in (torch.float16, torch.bfloat16):
        x = x.float()
        if isinstance(q, torch.Tensor):
            q = q.float()
    if x.ndim == 0:
        x = x.reshape(1)
    y, keep = _to_last(x, axis)
    out = torch.quantile(y, q, dim=-1)
    if keepdim:
        out = out.reshape(*out.shape[:out.ndim - y.ndim + 1], *keep)
    return out.to(dt)


@op_fn
def median(x, *, axis=None, keepdim=False):
    return _quantile(x, 0.5, axis, keepdim)


@op_fn
def quantile(x, q, *, axis=None, keepdim=False):
    xf = _float(x)
    qt = torch.as_tensor(q, dtype=xf.dtype, device=xf.device)
    return _quantile(xf, qt, axis, keepdim)


@op_fn(differentiable=False)
def count_nonzero(x, *, axis=None, keepdim=False):
    b = (x != 0).to(torch.int64)
    if b.ndim == 0:
        return b
    return torch.sum(b, _dims(axis, b.ndim), keepdim=keepdim)


@op_fn
def kthvalue_values(x, *, k, axis=-1, keepdim=False):
    taken = torch.sort(x, dim=axis, stable=True).values.select(axis, k - 1)
    return taken.unsqueeze(axis) if keepdim else taken
