"""The manipulation op long tail (port of
``paddle_tpu/ops/manipulation_ext.py``).

Strided views (``as_strided``, ``view``) give the reference's values by
a gather over the flat tensor, not by aliasing its memory: the
reference's arrays have no strides, and a gather differentiates the
same way. ``unique_consecutive`` returns a data-dependent shape: on the
CPU it runs as the reference's does, on the card through torch's own
``unique_consecutive`` (which reads its output size to the host, as the
reference reads its input). ``masked_scatter`` fills the masked places in
mask order; ``top_p_sampling`` draws from the port's seeded generator.
"""
from __future__ import annotations

import builtins

import torch

from ._op import op_fn, wrap
from ..core import enforce as E
from ..framework.random import default_generator as _default_generator

# this module defines a public ``slice`` op (the Paddle name)
_py_slice = builtins.slice

__all__ = [
    "atleast_1d", "atleast_2d", "atleast_3d", "as_strided", "view",
    "view_as", "unflatten", "expand_as", "tensor_split", "hsplit",
    "vsplit", "dsplit", "select_scatter", "slice_scatter",
    "diagonal_scatter", "index_fill", "index_sample", "masked_scatter",
    "reverse", "slice", "strided_slice", "unique_consecutive", "unstack",
    "shard_index", "kthvalue", "mode", "diag_embed", "broadcast_tensors",
    "crop", "top_p_sampling", "is_empty", "tensor_unfold",
]


def is_empty(x, name=None):
    return wrap(torch.tensor(x.numel() == 0, device=x.device))


@op_fn(name="tensor_unfold_op")
def _tensor_unfold(x, *, axis, size, step):
    axis = axis % x.ndim
    # torch's unfold puts the window last and the window count at axis,
    # the reference's layout
    return x.unfold(axis, size, step)


def tensor_unfold(x, axis, size, step, name=None):
    """``paddle.unfold`` on a tensor: sliding windows along one axis (the
    ``nn.functional.unfold`` im2col keeps the plain name)."""
    return _tensor_unfold(x, axis=int(axis), size=int(size), step=int(step))


def _atleast(nd):
    def impl(*inputs, name=None):
        outs = []
        for a in inputs:
            a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
            while a.ndim < nd:
                # atleast_3d appends the last dim of a matrix; the others
                # add leading dims
                a = a[:, :, None] if nd == 3 and a.ndim == 2 else a[None]
            outs.append(wrap(a))
        return outs[0] if len(outs) == 1 else outs
    impl.__name__ = f"atleast_{nd}d"
    impl.__qualname__ = impl.__name__
    return impl


atleast_1d = _atleast(1)
atleast_2d = _atleast(2)
atleast_3d = _atleast(3)


@op_fn(name="as_strided_op")
def _as_strided(x, *, shape, stride, offset=0):
    flat = x.reshape(-1)
    idx = torch.tensor(offset, device=x.device)
    for dim, st in zip(shape, stride):
        idx = idx[..., None] + torch.arange(dim, device=x.device) * st
    return flat[idx.reshape(shape)]


def as_strided(x, shape, stride, offset=0, name=None):
    return _as_strided(x, shape=tuple(shape), stride=tuple(stride),
                       offset=offset)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        from .manipulation import reshape
        return reshape(x, shape=shape_or_dtype)
    from ..core.dtype import convert_dtype
    return wrap(x.view(convert_dtype(shape_or_dtype)))


def view_as(x, other, name=None):
    from .manipulation import reshape
    return reshape(x, shape=list(other.shape))


@op_fn(name="unflatten_op")
def _unflatten(x, *, axis, shape):
    axis = axis % x.ndim
    return x.reshape(x.shape[:axis] + tuple(shape) + x.shape[axis + 1:])


def unflatten(x, axis, shape, name=None):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return _unflatten(x, axis=int(axis), shape=tuple(int(s) for s in shape))


def expand_as(x, y, name=None):
    from .manipulation import broadcast_to
    return broadcast_to(x, shape=list(y.shape))


def tensor_split(x, num_or_indices, axis=0, name=None):
    if not isinstance(num_or_indices, int):
        num_or_indices = [int(i) for i in num_or_indices]
    return [wrap(p) for p in torch.tensor_split(x, num_or_indices, axis)]


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0 if x.ndim == 1 else 1)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


@op_fn(name="select_scatter_op")
def _select_scatter(x, values, *, axis, index):
    return torch.select_scatter(x, values.to(x.dtype), axis, index)


def select_scatter(x, values, axis, index, name=None):
    return _select_scatter(x, values, axis=int(axis), index=int(index))


@op_fn(name="slice_scatter_op")
def _slice_scatter(x, value, *, axes, starts, ends, strides):
    idx = [_py_slice(None)] * x.ndim
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = _py_slice(st, en, sd)
    out = x.clone()
    out[tuple(idx)] = value.to(x.dtype)
    return out


def slice_scatter(x, value, axes=None, starts=None, ends=None, strides=None,
                  name=None):
    axes = list(range(x.ndim)) if axes is None else [int(v) for v in axes]
    starts = [0] * len(axes) if starts is None else [int(v) for v in starts]
    ends = ([x.shape[ax] for ax in axes] if ends is None
            else [int(v) for v in ends])
    strides = [1] * len(axes) if strides is None else [int(v)
                                                       for v in strides]
    return _slice_scatter(x, value, axes=tuple(axes), starts=tuple(starts),
                          ends=tuple(ends), strides=tuple(strides))


@op_fn(name="diagonal_scatter_op")
def _diagonal_scatter(x, y, *, offset=0, axis1=0, axis2=1):
    return torch.diagonal_scatter(x, y.to(x.dtype), offset, axis1, axis2)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return _diagonal_scatter(x, y, offset=int(offset), axis1=int(axis1),
                             axis2=int(axis2))


@op_fn(name="index_fill_op")
def _index_fill(x, index, *, axis, value):
    moved = torch.movedim(x, axis, 0).clone()
    moved[index.long()] = torch.as_tensor(value, dtype=x.dtype,
                                          device=x.device)
    return torch.movedim(moved, 0, axis)


def index_fill(x, index, axis, value, name=None):
    return _index_fill(x, index, axis=int(axis), value=value)


@op_fn(name="index_sample_op")
def _index_sample(x, index):
    return torch.gather(x, 1, index.long())


def index_sample(x, index, name=None):
    return _index_sample(x, index)


@op_fn(name="masked_scatter_op")
def _masked_scatter(x, mask, value):
    flat_m = torch.broadcast_to(mask, x.shape).reshape(-1)
    # each masked place takes the next value, in mask order
    order = torch.cumsum(flat_m.to(torch.int64), 0) - 1
    src = value.reshape(-1)
    take = order.clamp(0, src.shape[0] - 1)
    return torch.where(flat_m, src[take].to(x.dtype),
                       x.reshape(-1)).reshape(x.shape)


def masked_scatter(x, mask, value, name=None):
    return _masked_scatter(x, mask, value)


def reverse(x, axis, name=None):
    from .manipulation import flip
    return flip(x, axis=axis)


@op_fn(name="slice_op")
def _slice(input, *, axes, starts, ends):
    idx = [_py_slice(None)] * input.ndim
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = _py_slice(st, en)
    return input[tuple(idx)]


def slice(input, axes, starts, ends):
    starts = [int(s) for s in starts]
    ends = [int(e) for e in ends]
    return _slice(input, axes=tuple(int(a) for a in axes),
                  starts=tuple(starts), ends=tuple(ends))


def _strided(n, st, en, sd):
    """The positions of Python's ``range(n)[st:en:sd]`` (any sign of
    ``sd``), as the reference's ``x[st:en:sd]`` takes them."""
    return list(range(n))[_py_slice(st, en, sd)]


@op_fn(name="strided_slice_op")
def _strided_slice(x, *, axes, starts, ends, strides):
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        if sd > 0:
            idx = [_py_slice(None)] * x.ndim
            idx[ax] = _py_slice(st, en, sd)
            x = x[tuple(idx)]
        else:   # torch slices take no negative step: gather the positions
            pos = torch.tensor(_strided(x.shape[ax], st, en, sd),
                               dtype=torch.long, device=x.device)
            x = torch.index_select(x, ax, pos)
    return x


def strided_slice(x, axes, starts, ends, strides, name=None):
    return _strided_slice(x, axes=tuple(int(a) for a in axes),
                          starts=tuple(int(s) for s in starts),
                          ends=tuple(int(e) for e in ends),
                          strides=tuple(int(s) for s in strides))


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Deduplicate consecutive runs. The result's size depends on the
    data, so a card tensor's result size is read to the host (torch's
    ``unique_consecutive``), as the reference reads its input."""
    from ..core.dtype import convert_dtype
    dt = convert_dtype(dtype)
    out, inv, counts = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True, dim=axis)
    results = [wrap(out)]
    if return_inverse:
        results.append(wrap(inv.reshape(-1).to(dt)))
    if return_counts:
        results.append(wrap(counts.to(dt)))
    return results[0] if len(results) == 1 else tuple(results)


def unstack(x, axis=0, num=None, name=None):
    from .manipulation import unbind
    return unbind(x, axis=axis)


@op_fn(differentiable=False, name="shard_index_op")
def _shard_index(input, *, index_num, nshards, shard_id, ignore_value):
    size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * size, (shard_id + 1) * size
    inside = (input >= lo) & (input < hi)
    return torch.where(inside, input - lo,
                       torch.full_like(input, ignore_value))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    if not 0 <= shard_id < nshards:
        raise E.InvalidArgumentError(
            f"shard_id ({shard_id}) must be in [0, {nshards})")
    return _shard_index(input, index_num=index_num, nshards=nshards,
                        shard_id=shard_id, ignore_value=ignore_value)


@op_fn(name="kthvalue_op")
def _kthvalue(x, *, k, axis=-1, keepdim=False):
    vals, idxs = torch.sort(x, dim=axis, stable=True)
    v = vals.select(axis, k - 1)
    i = idxs.select(axis, k - 1)
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i.long()


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return _kthvalue(x, k=int(k), axis=int(axis), keepdim=keepdim)


@op_fn(name="mode_op")
def _mode(x, *, axis=-1, keepdim=False):
    moved = torch.movedim(x, axis, -1)
    srt, arg = torch.sort(moved, dim=-1, stable=True)
    # how often each sorted value occurs; the first of the most frequent
    counts = (srt[..., :, None] == srt[..., None, :]).sum(-1)
    best = torch.argmax(counts, dim=-1, keepdim=True)
    v = torch.take_along_dim(srt, best, dim=-1)[..., 0]
    i = torch.take_along_dim(arg, best, dim=-1)[..., 0]
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i.long()


def mode(x, axis=-1, keepdim=False, name=None):
    return _mode(x, axis=int(axis), keepdim=keepdim)


@op_fn(name="diag_embed_op")
def _diag_embed(input, *, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(input, offset, dim1, dim2)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return _diag_embed(input, offset=int(offset), dim1=int(dim1),
                       dim2=int(dim2))


def broadcast_tensors(inputs, name=None):
    return [wrap(t) for t in torch.broadcast_tensors(*inputs)]


@op_fn(name="crop_op")
def _crop(x, *, shape, offsets):
    return x[tuple(_py_slice(o, o + s) for o, s in zip(offsets, shape))]


def crop(x, shape=None, offsets=None, name=None):
    shape = list(x.shape) if shape is None else [
        x.shape[i] if int(s) == -1 else int(s) for i, s in enumerate(shape)]
    offsets = [0] * x.ndim if offsets is None else [int(o) for o in offsets]
    return _crop(x, shape=tuple(shape), offsets=tuple(offsets))


def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling: ``(values, ids)`` of one draw a row among the
    most probable tokens whose mass before them is at most ``ps`` (the
    first always kept), from the port's seeded generator (``seed`` >= 0:
    a generator of that seed)."""
    sorted_idx = torch.argsort(-x, dim=-1, stable=True)
    sorted_logits = torch.take_along_dim(x, sorted_idx, dim=-1)
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs <= ps.float()[..., None]
    masked = torch.where(keep, probs, 0.0)
    masked = masked / masked.sum(-1, keepdim=True)
    if seed in (None, -1):
        gen = _default_generator(x.device)
    else:
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
    choice = torch.multinomial(masked.reshape(-1, masked.shape[-1]), 1,
                               generator=gen).reshape(masked.shape[:-1]
                                                      + (1,))
    ids = torch.take_along_dim(sorted_idx, choice, dim=-1)
    vals = torch.take_along_dim(x, ids, dim=-1)
    return wrap(vals), wrap(ids.long())
