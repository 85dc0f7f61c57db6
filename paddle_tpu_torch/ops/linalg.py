"""Linear algebra ops (port of ``paddle_tpu/ops/linalg.py``).

Products are cuBLAS on the card and the decompositions and solves
cuSOLVER / MAGMA, through torch: the reference leaves them to XLA, so
they owe no hand-written kernel. A matrix ``cholesky`` that fails gives
a NaN lower triangle, as ``jnp.linalg.cholesky``; a singular ``inv`` /
``solve`` raises (torch's), where the reference returns inf / NaN.
"""
from __future__ import annotations

import torch

from ._op import op_fn

__all__ = ["matmul", "mm", "bmm", "dot", "inner", "outer", "cross", "einsum",
           "norm", "vector_norm", "matrix_norm", "cholesky", "inv", "pinv",
           "solve", "triangular_solve", "cholesky_solve", "matrix_rank",
           "det", "slogdet", "matrix_power", "multi_dot_op", "multi_dot",
           "matrix_exp"]


@op_fn
def matmul(x, y, *, transpose_x=False, transpose_y=False):
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y):
    return matmul(x, y)


def bmm(x, y):
    return matmul(x, y)


@op_fn
def dot(x, y):
    # 1-d or batched 1-d inner product
    return torch.sum(x * y, dim=-1)


@op_fn
def inner(x, y):
    return torch.inner(x, y)


@op_fn
def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op_fn
def cross(x, y, *, axis=-1):
    return torch.linalg.cross(x, y, dim=axis)


@op_fn(name="einsum")
def _einsum(*operands, equation):
    return torch.einsum(equation, *operands)


def einsum(equation, *operands):
    return _einsum(*operands, equation=equation)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


@op_fn
def norm(x, *, p=None, axis=None, keepdim=False):
    axis = _axes(axis)
    if p is None:
        p = 2 if axis is not None or x.ndim == 1 else "fro"
    kw = dict(dim=tuple(range(x.ndim)) if axis is None else axis,
              keepdim=keepdim)
    if p == "fro":
        return torch.sqrt(torch.sum(torch.square(x), **kw))
    if p == float("inf"):
        return torch.amax(torch.abs(x), **kw)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), **kw)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), **kw)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), **kw), 1.0 / p)


def vector_norm(x, p=2, axis=None, keepdim=False):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


@op_fn
def matrix_norm(x, *, p="fro", axis=(-2, -1), keepdim=False):
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                    keepdim=keepdim)


@op_fn
def cholesky(x, *, upper=False):
    L, info = torch.linalg.cholesky_ex(x)
    bad = (info != 0)[..., None, None]
    L = torch.where(bad, torch.full_like(L, float("nan")).tril(), L)
    return L.transpose(-1, -2) if upper else L


@op_fn
def inv(x):
    return torch.linalg.inv(x)


@op_fn
def pinv(x, *, rcond=1e-15):
    return torch.linalg.pinv(x, rtol=rcond)


@op_fn
def solve(x, y):
    if y.ndim == 1:
        return torch.linalg.solve(x, y)
    if y.ndim < x.ndim:
        # a matrix right side (jnp's reading of any y of 2 or more dims)
        y = y.expand(*x.shape[:-2], *y.shape[-2:])
    return torch.linalg.solve(x, y)


@op_fn
def triangular_solve(x, y, *, upper=True, transpose=False,
                     unitriangular=False):
    a, up = (x.transpose(-1, -2), not upper) if transpose else (x, upper)
    vec = y.ndim == 1
    b = y[:, None] if vec else y
    out = torch.linalg.solve_triangular(a, b, upper=up, left=True,
                                        unitriangular=unitriangular)
    return out[:, 0] if vec else out


@op_fn
def cholesky_solve(x, y, *, upper=False):
    # only the factor's own triangle is read, so only it gets a gradient
    # (jax.scipy's cho_solve)
    y = torch.triu(y) if upper else torch.tril(y)
    vec = x.ndim == 1
    out = torch.cholesky_solve(x[:, None] if vec else x, y, upper=upper)
    return out[:, 0] if vec else out


@op_fn(differentiable=False)
def matrix_rank(x, *, tol=None):
    return torch.linalg.matrix_rank(x, rtol=tol)


@op_fn
def det(x):
    return torch.linalg.det(x)


@op_fn
def slogdet(x):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


@op_fn
def matrix_power(x, *, n):
    return torch.linalg.matrix_power(x, n)


@op_fn
def multi_dot_op(*xs):
    return torch.linalg.multi_dot(list(xs))


def multi_dot(xs):
    return multi_dot_op(*xs)


@op_fn
def matrix_exp(x):
    return torch.linalg.matrix_exp(x)
