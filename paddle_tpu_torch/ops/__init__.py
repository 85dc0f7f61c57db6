"""The flat op namespace (port of ``paddle_tpu/ops/__init__.py``):
``paddle_tpu_torch.add``, ``concat``, ``matmul``, ``topk``, ``randn``, ...

Nothing is patched onto ``torch.Tensor``: where the reference installs
Paddle's methods on its own ``Tensor`` class, the port's surface is these
functions (``paddle_tpu_torch.sum(x, axis=1)``). Python operators on
torch tensors (``x + y``) stay torch's and count nothing in the monitor.

In-place ``<name>_`` functions write the reference's value into ``x``
and return ``x``. The value is computed from a copy of ``x`` when
autograd records (the reference's snapshot), then copied into ``x``
with ``copy_``, which autograd sees (``as_strided_`` first where the
shape changes: ``reshape_``, ``squeeze_``, ``t_``); where the dtype
changes (``equal_``, ``cast_``) ``x`` takes the value by a rebind and
leaves autograd, as the reference's result is ``stop_gradient``. On a
tensor that autograd must not see changed, torch's own errors stand in
for the reference's ``PreconditionNotMetError``: the in-place error at
once on a leaf that requires grad, the version-counter error at backward
where a value autograd saved was changed. The random fills (``uniform_``,
``normal_``, ``cauchy_``, ``geometric_``, ``exponential_``) draw from
the port's seeded generator.
"""
from __future__ import annotations

import builtins as _builtins
import functools
import math as _math
import sys

import torch

from ._op import get_op, op_fn, registered_ops, wrap  # noqa: F401
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .math_ext import *  # noqa: F401,F403
from .reduction import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .manipulation_ext import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .linalg_ext import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .misc_ext import *  # noqa: F401,F403
from . import fft_ops  # noqa: F401  (namespaced as paddle_tpu_torch.fft)
from ..core import dtype as _dtypes
from ..device import to_torch_device as _to_torch_device
from ..framework.random import default_generator as _default_generator


def _snapshot(x, args, kwargs):
    """``x`` or, while autograd records through the op, a copy of it, so
    that the op's saved tensors are not the ``x`` about to change."""
    if not torch.is_grad_enabled():
        return x
    if x.requires_grad or _builtins.any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in (*args, *kwargs.values())):
        return x.clone()
    return x


def _contiguous_strides(shape):
    strides, step = [], 1
    for s in reversed(shape):
        strides.append(step)
        step *= _builtins.max(int(s), 1)
    return tuple(reversed(strides))


def _adopt(x, out):
    """Write ``out`` into ``x`` and return ``x``: ``copy_`` (autograd
    sees it); a contiguous ``x`` takes a new shape by ``as_strided_``
    first. A new dtype (``equal_``, ``cast_``) or a new shape of a
    non-contiguous ``x`` rebinds ``x``'s data outside autograd, and a new
    dtype leaves ``x`` out of autograd, as the reference's result of such
    an op is ``stop_gradient``."""
    if out.dtype != x.dtype:
        if x.requires_grad:
            x.detach_()
        x.data = out.detach()
    elif out.shape == x.shape:
        x.copy_(out)
    elif x.is_contiguous():
        if out.untyped_storage().data_ptr() == \
                x.untyped_storage().data_ptr():
            out = out.clone()       # a view of x's memory, about to move
        x.as_strided_(out.shape, _contiguous_strides(out.shape),
                      x.storage_offset())
        x.copy_(out)
    else:
        x.data = out.detach()
    return x


_INPLACE_NAMES = [
    "abs", "acos", "acosh", "add", "addmm", "asin", "asinh", "atan",
    "atanh", "bitwise_and", "bitwise_left_shift", "bitwise_not",
    "bitwise_or", "bitwise_right_shift", "bitwise_xor", "ceil", "clip",
    "copysign", "cos", "cosh", "cumprod", "cumsum", "digamma", "divide",
    "equal", "erfinv", "exp", "expm1", "flatten", "floor", "floor_divide",
    "floor_mod", "frac", "gammainc", "gammaincc", "gammaln", "gcd",
    "greater_equal", "greater_than", "hypot", "i0", "index_fill",
    "index_put", "lcm",
    "ldexp", "lerp", "less_equal", "less_than", "lgamma", "log", "log10",
    "log1p", "log2", "logical_and", "logical_not", "logical_or",
    "logical_xor", "logit", "masked_fill", "masked_scatter", "mod",
    "multigammaln", "multiply", "nan_to_num", "neg", "not_equal",
    "polygamma", "pow", "put_along_axis", "reciprocal", "remainder",
    "renorm", "reshape", "round", "rsqrt", "scale", "scatter", "sigmoid",
    "sin", "sinc", "sinh", "sqrt", "squeeze", "subtract", "tan", "tanh",
    "tril", "triu", "trunc", "unsqueeze", "erf", "square", "index_add",
    # not "where": where_(cond, x, y) writes into x (arg 1), not cond
]


def _make_inplace(fn):
    @functools.wraps(fn)
    def inplace(x, *args, **kwargs):
        return _adopt(x, fn(_snapshot(x, args, kwargs), *args, **kwargs))
    inplace.__name__ = fn.__name__ + "_"
    return inplace


def where_(condition, x, y, name=None):
    """``paddle.where_``: writes the selection into ``x``."""
    return _adopt(x, where(condition, _snapshot(x, (y,), {}), y))  # noqa


def t_(x):
    return _adopt(x, t(_snapshot(x, (), {})))  # noqa: F405


def transpose_(x, perm):
    return _adopt(x, transpose(_snapshot(x, (), {}), perm=perm))  # noqa


def cast_(x, dtype):
    return _adopt(x, cast(_snapshot(x, (), {}), dtype))  # noqa: F405


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    with torch.no_grad():
        x.uniform_(min, max, generator=_default_generator(x.device))
    return x


def normal_(x, mean=0.0, std=1.0, seed=0, name=None):
    with torch.no_grad():
        x.normal_(mean, std, generator=_default_generator(x.device))
    return x


def cauchy_(x, loc=0, scale=1, name=None):
    with torch.no_grad():
        x.cauchy_(loc, scale, generator=_default_generator(x.device))
    return x


def geometric_(x, probs, name=None):
    """Trials to the first success, ``>= 1``: torch's sampler, whose
    draw (like the reference's ``ceil(log1p(-u) / log1p(-p))`` at ``u =
    0``) is 0 about once in 2^24; such a draw counts as 1."""
    with torch.no_grad():
        x.geometric_(probs, generator=_default_generator(x.device))
        x.clamp_(min=1)
    return x


def _register_inplace():
    ns = sys.modules[__name__].__dict__
    for name in _INPLACE_NAMES:
        base = ns.get(name)
        if base is not None:
            ns.setdefault(name + "_", _make_inplace(base))


_register_inplace()


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """``paddle.create_parameter``: a ``torch.nn.Parameter`` on the
    current device, from ``default_initializer``, zeros for a bias, else
    Xavier-uniform over ``shape[0]`` / ``shape[-1]``."""
    dt = _dtypes.convert_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    dev = _to_torch_device(None)
    if default_initializer is not None:
        data = default_initializer(shape, dt)
    elif is_bias:
        data = torch.zeros(shape, dtype=dt, device=dev)
    else:
        fan_in = shape[0] if shape else 1
        fan_out = shape[-1] if shape else 1
        bound = _math.sqrt(6.0 / (fan_in + fan_out))
        data = torch.empty(shape, dtype=dt, device=dev).uniform_(
            -bound, bound, generator=_default_generator(dev))
    return torch.nn.Parameter(data)


def create_tensor(dtype, name=None, persistable=False):
    return wrap(torch.zeros((), dtype=_dtypes.convert_dtype(dtype),
                            device=_to_torch_device(None)))


from .composite import register_composites as _register_composites  # noqa

_register_composites(sys.modules[__name__].__dict__)

# the functions only: the domain modules (ops.linalg, ...) stay out of a
# star import, so paddle_tpu_torch.linalg is never ops.linalg
__all__ = sorted(n for n, v in globals().items()
                 if not n.startswith("_") and callable(v)
                 and not isinstance(v, type(sys)) and n not in (
                     "annotations", "functools", "sys", "torch"))
