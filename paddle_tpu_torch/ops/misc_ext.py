"""The remaining top-level tensor functions (port of
``paddle_tpu/ops/misc_ext.py``): the stack variants, ``combinations``,
``pdist`` and the draws ``randint_like``, ``binomial`` and
``standard_gamma``, which take the port's seeded generator of the
tensor's device (their draws are the port's own, held to the reference
by range, dtype and moments). ``combinations`` enumerates its index
tuples on the host from the length alone, as the reference does.
"""
from __future__ import annotations

import itertools

import torch

from ._op import op_fn, wrap
from ..framework.random import default_generator as _default_generator

__all__ = [
    "hstack", "vstack", "dstack", "column_stack", "row_stack",
    "combinations", "pdist", "randint_like", "binomial", "standard_gamma",
]


def hstack(x, name=None):
    return wrap(torch.hstack(list(x)))


def vstack(x, name=None):
    return wrap(torch.vstack(list(x)))


row_stack = vstack


def dstack(x, name=None):
    return wrap(torch.dstack(list(x)))


def column_stack(x, name=None):
    return wrap(torch.column_stack(list(x)))


@op_fn(differentiable=False)
def _combinations(x, *, r=2, with_replacement=False):
    """All r-combinations of the elements of 1-D ``x``: ``[C, r]``."""
    gen = (itertools.combinations_with_replacement if with_replacement
           else itertools.combinations)
    tuples = list(gen(range(x.shape[0]), r))
    if not tuples:
        return x.new_zeros((0, r))
    return x[torch.tensor(tuples, dtype=torch.long, device=x.device)]


def combinations(x, r=2, with_replacement=False, name=None):
    return _combinations(x, r=int(r), with_replacement=bool(with_replacement))


@op_fn
def pdist(x, p=2.0):
    """Condensed pairwise distances of ``[N, D]`` rows:
    ``[N * (N - 1) / 2]``."""
    n = x.shape[0]
    iu, ju = torch.triu_indices(n, n, offset=1, device=x.device)
    diff = x[iu] - x[ju]
    if p == 2.0:
        # the sqrt of a clamped sum of squares: finite gradient at 0
        return torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1),
                                      min=1e-24))
    return torch.sum(diff.abs() ** p, dim=-1) ** (1.0 / p)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    from ..core.dtype import convert_dtype
    dt = convert_dtype(dtype) if dtype is not None else x.dtype
    out = torch.randint(int(low), int(high), tuple(x.shape),
                        generator=_default_generator(x.device),
                        device=x.device)
    return wrap(out.to(dt))


def binomial(count, prob, name=None):
    """Binomial(count, prob) draws elementwise, int64."""
    c, p = torch.broadcast_tensors(count.float(), prob.float())
    out = torch.binomial(c.contiguous(), p.contiguous(),
                         generator=_default_generator(count.device))
    return wrap(out.to(torch.int64))


def standard_gamma(x, name=None):
    """Gamma(alpha = x, scale = 1) draws elementwise."""
    return wrap(torch._standard_gamma(x, generator=_default_generator(
        x.device)))
