"""Creation ops (port of ``paddle_tpu/ops/creation.py``).

New tensors go on the current device (``paddle_tpu_torch.set_device``)
or the ``device=`` given; with no card and no CPU asked for they raise,
as every entry point of the port does. Integer ``arange`` is ``int64``
(the reference's ``int32`` without x64).
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core.tensor import to_tensor  # noqa: F401  (re-exported)
from ..device import to_torch_device
from ._op import op_fn, wrap

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "arange", "linspace",
           "logspace", "eye", "clone", "assign", "diag", "diagflat", "tril",
           "triu", "meshgrid", "tril_indices", "triu_indices", "complex"]


def _dt(dtype):
    return (dtypes.convert_dtype(dtype) if dtype is not None
            else dtypes.get_default_dtype())


def _shape(shape):
    """A shape as a tuple of ints: an int, a sequence of ints or 0-d
    tensors, or a 1-d integer tensor."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, *, device=None):
    return wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                            device=to_torch_device(device)))


def ones(shape, dtype=None, *, device=None):
    return wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                           device=to_torch_device(device)))


def full(shape, fill_value, dtype=None, *, device=None):
    return wrap(torch.full(_shape(shape), _scalar(fill_value),
                           dtype=_dt(dtype), device=to_torch_device(device)))


def empty(shape, dtype=None, *, device=None):
    return zeros(shape, dtype, device=device)


@op_fn
def zeros_like(x, *, dtype=None):
    return torch.zeros_like(x, dtype=dtypes.convert_dtype(dtype))


@op_fn
def ones_like(x, *, dtype=None):
    return torch.ones_like(x, dtype=dtypes.convert_dtype(dtype))


@op_fn
def full_like(x, fill_value, *, dtype=None):
    dt = dtypes.convert_dtype(dtype) or x.dtype
    if isinstance(fill_value, torch.Tensor):
        return fill_value.to(dt).expand(x.shape).clone()
    return torch.full_like(x, fill_value, dtype=dt)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype=dtype)


def arange(start=0, end=None, step=1, dtype=None, *, device=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (torch.int64 if all(isinstance(v, int)
                                    for v in (start, end, step))
                 else dtypes.get_default_dtype())
    return wrap(torch.arange(start, end, step, dtype=_dt(dtype),
                             device=to_torch_device(device)))


def linspace(start, stop, num, dtype=None, *, device=None):
    return wrap(torch.linspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), dtype=_dt(dtype),
                               device=to_torch_device(device)))


def logspace(start, stop, num, base=10.0, dtype=None, *, device=None):
    return wrap(torch.logspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), base=base,
                               dtype=_dt(dtype),
                               device=to_torch_device(device)))


def eye(num_rows, num_columns=None, dtype=None, *, device=None):
    n, m = int(num_rows), int(num_columns if num_columns is not None
                               else num_rows)
    return wrap(torch.eye(n, m, dtype=_dt(dtype),
                          device=to_torch_device(device)))


@op_fn
def clone(x):
    return x.clone()


def assign(x, output=None):
    """``paddle.assign``: a copy of ``x``, or ``x`` copied into
    ``output`` (outside autograd, as the reference's ``set_value``)."""
    x = x if isinstance(x, torch.Tensor) else to_tensor(x)
    if output is None:
        return clone(x)
    with torch.no_grad():
        output.copy_(x)
    return output


@op_fn
def diag(x, *, offset=0):
    return torch.diag(x, offset)


@op_fn
def diagflat(x, *, offset=0):
    return torch.diagflat(x, offset)


@op_fn
def tril(x, *, diagonal=0):
    return torch.tril(x, diagonal)


@op_fn
def triu(x, *, diagonal=0):
    return torch.triu(x, diagonal)


def meshgrid(*args, indexing="ij"):
    """The grids, outside autograd as in the reference (its composite
    makes new stop_gradient tensors)."""
    arrays = (args[0] if len(args) == 1 and isinstance(args[0], (list, tuple))
              else args)
    return tuple(wrap(g.detach()) for g in torch.meshgrid(*arrays,
                                                          indexing=indexing))


def tril_indices(row, col, offset=0, *, device=None):
    return wrap(torch.tril_indices(row, col, offset,
                                   device=to_torch_device(device)))


def triu_indices(row, col, offset=0, *, device=None):
    return wrap(torch.triu_indices(row, col, offset,
                                   device=to_torch_device(device)))


def complex(real, imag):
    real = torch.as_tensor(real)
    imag = torch.as_tensor(imag, device=real.device)
    dt = torch.promote_types(torch.promote_types(real.dtype, imag.dtype),
                             torch.float32)
    return wrap(torch.complex(real.to(dt), imag.to(dt)))
