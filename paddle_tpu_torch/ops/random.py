"""Random sampling ops (port of ``paddle_tpu/ops/random.py``).

Every draw comes from the seeded generator of the tensor's device
(``framework.random.default_generator``), passed explicitly, so
``paddle_tpu_torch.seed(s)`` makes a run repeat. The numbers differ from
JAX's for the same seed; the distributions, ranges and dtypes are the
reference's. New tensors go on the current device or ``device=``.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..device import to_torch_device
from ..framework.random import default_generator
from ._op import wrap
from .creation import _shape

__all__ = ["uniform", "rand", "randn", "standard_normal", "normal",
           "randint", "randperm", "bernoulli", "multinomial", "poisson",
           "exponential_", "shuffle", "gumbel"]


def _dt(dtype):
    return (dtypes.convert_dtype(dtype) if dtype is not None
            else dtypes.get_default_dtype())


def uniform(shape, dtype=None, min=-1.0, max=1.0, *, device=None):
    dev = to_torch_device(device)
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return wrap(out.uniform_(min, max, generator=default_generator(dev)))


def rand(shape, dtype=None, *, device=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0, device=device)


def randn(shape, dtype=None, *, device=None):
    dev = to_torch_device(device)
    return wrap(torch.randn(_shape(shape), generator=default_generator(dev),
                            dtype=_dt(dtype), device=dev))


def standard_normal(shape, dtype=None, *, device=None):
    return randn(shape, dtype, device=device)


def normal(mean=0.0, std=1.0, shape=None, *, device=None):
    dev = (mean.device if isinstance(mean, torch.Tensor) else
           std.device if isinstance(std, torch.Tensor) else
           to_torch_device(device))
    mean_ = torch.as_tensor(mean, device=dev)
    std_ = torch.as_tensor(std, device=dev)
    if shape is None:
        shape = torch.broadcast_shapes(mean_.shape, std_.shape)
    z = torch.randn(_shape(shape), generator=default_generator(dev),
                    dtype=dtypes.get_default_dtype(), device=dev)
    return wrap(mean_ + std_ * z)


def randint(low=0, high=None, shape=(1,), dtype="int64", *, device=None):
    if high is None:
        low, high = 0, low
    dev = to_torch_device(device)
    return wrap(torch.randint(int(low), int(high), _shape(shape),
                              generator=default_generator(dev),
                              dtype=dtypes.convert_dtype(dtype), device=dev))


def randperm(n, dtype="int64", *, device=None):
    dev = to_torch_device(device)
    return wrap(torch.randperm(int(n), generator=default_generator(dev),
                               device=dev).to(dtypes.convert_dtype(dtype)))


def bernoulli(x):
    return wrap(torch.bernoulli(x.detach(),
                                generator=default_generator(x.device)))


def multinomial(x, num_samples=1, replacement=False):
    return wrap(torch.multinomial(x.detach(), num_samples,
                                  replacement=replacement,
                                  generator=default_generator(x.device)))


def poisson(x):
    return wrap(torch.poisson(x.detach(),
                              generator=default_generator(x.device)))


def exponential_(x, lam=1.0):
    """Fill ``x`` in place with draws of rate ``lam`` (outside
    autograd)."""
    with torch.no_grad():
        x.exponential_(lam, generator=default_generator(x.device))
    return x


def shuffle(x, axis=0):
    perm = torch.randperm(x.shape[axis],
                          generator=default_generator(x.device),
                          device=x.device)
    return wrap(torch.index_select(x, axis, perm))


def gumbel(shape, dtype=None, *, device=None):
    dev = to_torch_device(device)
    dt = _dt(dtype)
    u = torch.rand(_shape(shape), generator=default_generator(dev), dtype=dt,
                   device=dev)
    u = u.clamp_min(torch.finfo(dt).tiny)
    return wrap(-torch.log(-torch.log(u)))
