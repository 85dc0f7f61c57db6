"""Shape, layout, indexing and search ops (port of
``paddle_tpu/ops/manipulation.py``).

The reference's semantics where they are not torch's: ``gather`` is
``jnp.take`` along an axis (any index shape), not ``torch.gather``;
``scatter(overwrite=False)`` adds into ``x``; ``sort`` / ``argsort``
descending flip the stable ascending order (``argsort`` keeps the
original order of ties, ``jnp.argsort(descending=True)``'s); ``topk``
gives ``lax.top_k``'s order of ties (the lower index first);
``split`` takes one ``-1`` among its sections; ``masked_fill`` is
``where(mask, value, x)`` (a float value promotes an integer ``x``).
Index outputs are ``int64`` (the reference's ``int32`` without x64).
Indices must be in range: the reference clamps or fills out-of-range
gathers, torch raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core import enforce as E
from ._op import op_fn, wrap

__all__ = [
    "reshape", "transpose", "t", "moveaxis", "swapaxes", "flatten",
    "squeeze", "unsqueeze", "concat", "stack", "split_op", "split", "chunk",
    "unbind", "tile", "expand", "broadcast_to", "broadcast_tensors",
    "broadcast_shape", "flip", "roll", "rot90", "pad", "cast_f", "cast",
    "getitem", "gather", "gather_nd", "index_select", "take_along_axis",
    "put_along_axis", "scatter", "scatter_nd_add", "scatter_nd",
    "index_add", "index_put", "where", "nonzero", "masked_select_nondiff",
    "masked_select", "masked_fill", "sort", "argsort", "topk", "unique_op",
    "unique", "searchsorted", "bincount", "repeat_interleave", "as_real",
    "as_complex", "diagonal", "trace", "kron", "numel", "shape",
    "one_hot_nd", "one_hot", "tensordot",
]


@op_fn
def reshape(x, *, shape):
    return torch.reshape(x, tuple(int(s) for s in shape))


@op_fn
def transpose(x, *, perm):
    return x.permute(*perm)


def t(x):
    if x.ndim <= 1:
        return x
    return transpose(x, perm=list(range(x.ndim))[::-1])


@op_fn
def moveaxis(x, *, source, destination):
    return torch.movedim(x, source, destination)


@op_fn
def swapaxes(x, *, axis1, axis2):
    return torch.swapaxes(x, axis1, axis2)


@op_fn
def flatten(x, *, start_axis=0, stop_axis=-1):
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


@op_fn
def squeeze(x, *, axis=None):
    if axis is None:
        return torch.squeeze(x)
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    axes = tuple(a for a in axes if x.shape[a] == 1)
    return torch.squeeze(x, axes) if axes else x


@op_fn
def unsqueeze(x, *, axis):
    if isinstance(axis, (list, tuple)):
        for a in sorted(axis):
            x = torch.unsqueeze(x, a)
        return x
    return torch.unsqueeze(x, axis)


def concat(xs, axis=0):
    return _concat(*xs, axis=axis)


@op_fn(name="concat")
def _concat(*xs, axis=0):
    return torch.cat(xs, dim=axis)


def stack(xs, axis=0):
    return _stack(*xs, axis=axis)


@op_fn(name="stack")
def _stack(*xs, axis=0):
    return torch.stack(xs, dim=axis)


@op_fn
def split_op(x, *, num_or_sections, axis=0):
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        E.enforce(total % num_or_sections == 0,
                  f"split: axis {axis} of size {total} does not divide into "
                  f"{num_or_sections} equal sections",
                  error=E.InvalidArgumentError)
        return tuple(torch.split(x, total // num_or_sections, dim=axis))
    secs = [int(s) for s in num_or_sections]
    if -1 in secs:
        known = sum(s for s in secs if s != -1)
        secs[secs.index(-1)] = total - known
    return tuple(torch.split(x, secs, dim=axis))


def split(x, num_or_sections, axis=0):
    return list(split_op(x, num_or_sections=num_or_sections, axis=axis))


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis=axis)


def unbind(x, axis=0):
    parts = split(x, x.shape[axis], axis=axis)
    return [squeeze(p, axis=axis) for p in parts]


@op_fn
def tile(x, *, repeat_times):
    return torch.tile(x, tuple(int(r) for r in repeat_times))


@op_fn
def expand(x, *, shape):
    shape = tuple(x.shape[i - (len(shape) - x.ndim)] if s == -1 else int(s)
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


@op_fn
def broadcast_to(x, *, shape):
    return torch.broadcast_to(x, tuple(int(s) for s in shape))


def broadcast_tensors(inputs):
    return [wrap(a) for a in torch.broadcast_tensors(*inputs)]


def broadcast_shape(s1, s2):
    return list(np.broadcast_shapes(tuple(s1), tuple(s2)))


@op_fn
def flip(x, *, axis):
    dims = (tuple(range(x.ndim)) if axis is None else
            tuple(axis) if isinstance(axis, (list, tuple)) else (axis,))
    return torch.flip(x, dims)


@op_fn
def roll(x, *, shifts, axis=None):
    return torch.roll(x, shifts, axis)


@op_fn
def rot90(x, *, k=1, axes=(0, 1)):
    return torch.rot90(x, k, tuple(axes))


def _pad_index(n, lo, hi, mode, device):
    """Source positions of a dimension of size ``n`` padded by ``lo`` /
    ``hi`` in ``jnp.pad``'s ``edge`` / ``reflect`` / ``wrap`` modes."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i.abs(), period)
    return torch.where(j >= n, period - j, j)


def pad_nd(x, width, mode, value):
    """``jnp.pad(x, width, mode)`` for ``width`` a ``(lo, hi)`` pair per
    dimension; ``mode`` is the reference's name (``constant``,
    ``reflect``, ``replicate``, ``circular``)."""
    width = [(int(a), int(b)) for a, b in width]
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    jmode = {"reflect": "reflect", "replicate": "edge",
             "circular": "wrap"}[mode]
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            x = torch.index_select(
                x, d, _pad_index(x.shape[d], lo, hi, jmode, x.device))
    return x


@op_fn
def pad(x, *, pad, mode="constant", value=0.0, data_format="NCHW"):
    nd = x.ndim
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # Paddle's order: the first pair pads the last dimension
        k = len(pad) // 2
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(k)]
        width = [(0, 0)] * (nd - k) + pairs[::-1]
    return pad_nd(x, width, mode, value)


@op_fn
def cast_f(x, *, dtype):
    return x.to(dtypes.convert_dtype(dtype))


def cast(x, dtype):
    dt = dtypes.convert_dtype(dtype)
    if dt.is_floating_point or dt.is_complex:
        return cast_f(x, dtype=dt)
    # integer or bool target: outside the tape
    return wrap(x.detach().to(dt))


@op_fn(name="getitem")
def _getitem_pure(x, *, idx):
    return x[idx]


def getitem(x, idx):
    return _getitem_pure(x, idx=idx)


def _along(x, index, axis):
    """``jnp.take(x, index, axis)``: ``x`` with ``axis`` replaced by the
    index's shape."""
    axis = axis % x.ndim
    return x[(slice(None),) * axis + (index.long(),)]


@op_fn
def gather(x, index, *, axis=0):
    return _along(x, index, axis)


@op_fn
def gather_nd(x, index):
    return x[tuple(index.long().movedim(-1, 0))]


@op_fn
def index_select(x, index, *, axis=0):
    return _along(x, index, axis)


@op_fn
def take_along_axis(x, indices, *, axis):
    return torch.take_along_dim(x, indices.long(), dim=axis)


@op_fn
def put_along_axis(x, indices, values, *, axis, reduce="assign"):
    idx = indices.long()
    v = torch.as_tensor(values, dtype=x.dtype, device=x.device)
    v = torch.broadcast_to(v, idx.shape)
    if reduce == "assign":
        return x.scatter(axis, idx, v)
    if reduce == "add":
        return x.scatter_add(axis, idx, v)
    if reduce in ("mul", "multiply"):
        return x.scatter_reduce(axis, idx, v, "prod")
    raise E.InvalidArgumentError(f"unsupported reduce: {reduce}")


@op_fn
def scatter(x, index, updates, *, overwrite=True):
    """Rows of ``updates`` into ``x`` at ``index``; ``overwrite=False``
    adds them into ``x`` (the reference's). With duplicate indices and
    ``overwrite`` the row that wins is undefined, as in the reference."""
    return x.index_put((index.long(),), updates.to(x.dtype),
                       accumulate=not overwrite)


@op_fn
def scatter_nd_add(x, index, updates):
    return x.index_put(tuple(index.long().movedim(-1, 0)),
                       updates.to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape):
    zeros = wrap(torch.zeros(tuple(int(s) for s in shape),
                             dtype=updates.dtype, device=updates.device))
    return scatter_nd_add(zeros, index, updates)


@op_fn
def index_add(x, index, *, axis, value):
    return torch.index_add(x, axis, index.long(), value.to(x.dtype))


@op_fn
def index_put(x, indices, value, *, accumulate=False):
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in indices)
    return x.index_put(idx, torch.as_tensor(value, dtype=x.dtype,
                                            device=x.device),
                       accumulate=accumulate)


@op_fn
def where(condition, x, y):
    return torch.where(condition, x, y)


@op_fn(differentiable=False)
def nonzero(x, *, as_tuple=False):
    if as_tuple:
        return torch.nonzero(x, as_tuple=True)
    return torch.nonzero(x)


@op_fn(differentiable=False)
def masked_select_nondiff(x, mask):
    return x[mask]


def masked_select(x, mask):
    return masked_select_nondiff(x, mask)


@op_fn
def masked_fill(x, mask, *, value):
    return torch.where(mask, value, x)


@op_fn
def sort(x, *, axis=-1, descending=False):
    s = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(s, (axis,)) if descending else s


@op_fn(differentiable=False)
def argsort(x, *, axis=-1, descending=False, stable=True):
    return torch.argsort(x, dim=axis, descending=descending, stable=True)


def _top_k_indices(x, k, axis, largest):
    """``lax.top_k`` indices along ``axis``: the ``k`` largest (of ``-x``
    without ``largest``), ties in index order."""
    key = x if largest else -x
    return torch.sort(key, dim=axis, descending=True,
                      stable=True).indices.narrow(axis, 0, k)


def topk(x, k, axis=-1, largest=True, sorted=True):
    """``paddle.topk``: ``(values, indices)``; the values are a
    differentiable ``take_along_axis`` of ``x``."""
    idx = wrap(_top_k_indices(x.detach(), int(k), axis, largest))
    return take_along_axis(x, idx, axis=axis), idx


@op_fn(differentiable=False)
def unique_op(x):
    return torch.unique(x, sorted=True)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    """``jnp.unique``: the sorted unique values (of the flattened ``x``,
    or the unique slices along ``axis``), then as asked the index of each
    one's first occurrence, the inverse and the counts."""
    src = x.reshape(-1) if axis is None else x
    dim = None if axis is None else axis
    u, inv, cnt = torch.unique(src, sorted=True, return_inverse=True,
                               return_counts=True, dim=dim)
    outs = [u]
    if return_index:
        n = src.shape[0 if dim is None else dim]
        first = torch.full((u.shape[0 if dim is None else dim],), n,
                           dtype=torch.int64, device=x.device)
        outs.append(first.scatter_reduce(
            0, inv, torch.arange(n, device=x.device), "amin"))
    if return_inverse:
        outs.append(inv.reshape(x.shape) if axis is None else inv)
    if return_counts:
        outs.append(cnt)
    if len(outs) == 1:
        return wrap(u)
    return tuple(wrap(o) for o in outs)


@op_fn(differentiable=False)
def searchsorted(sorted_sequence, values, *, right=False):
    return torch.searchsorted(sorted_sequence, values, right=right)


@op_fn(differentiable=False)
def bincount(x, *, weights=None, minlength=0):
    out = torch.bincount(x.reshape(-1), weights, minlength=minlength)
    return out if weights is None else out.to(weights.dtype)


@op_fn
def repeat_interleave(x, *, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@op_fn
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


@op_fn
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


@op_fn
def diagonal(x, *, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


@op_fn
def trace(x, *, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@op_fn
def kron(x, y):
    return torch.kron(x, y)


def numel(x):
    return wrap(torch.tensor(x.numel(), device=x.device))


def shape(x):
    return wrap(torch.tensor(list(x.shape), dtype=torch.int32,
                             device=x.device))


@op_fn(differentiable=False)
def one_hot_nd(x, *, num_classes):
    # out-of-range ids (a -1 pad) give a zero row, as jax.nn.one_hot
    cls = torch.arange(num_classes, device=x.device)
    return (x[..., None] == cls).to(torch.float32)


def one_hot(x, num_classes):
    return one_hot_nd(x, num_classes=num_classes)


@op_fn
def tensordot(x, y, *, axes=2):
    return torch.tensordot(x, y, dims=axes)
