"""Anomaly guards of the train step, shared by every model family (port
of ``paddle_tpu/training/guards.py``).

``models/llama.py`` and ``models/moe.py`` compose these into their
``make_train_step(guard=...)``: :func:`step_health` is the one anomaly
definition (finite loss, finite global gradient norm, token ids in
range, norm under the caller's cap) and :func:`gated_update` the
all-or-nothing gate that leaves parameters and optimizer state
byte-identical on an anomalous step. Plain functions on tensors, every
statistic computed in float32 on the tensors' device.

The reference gates on the device (``lax.cond``). The port's AdamW keeps
its step count and bias corrections on the host (``models.llama.
_adamw_update``), so :func:`gated_update` reads ``ok`` on the host once,
after the gradients and before the update, then applies the update whole
or not at all: the guarded step's one host read (the reference's host
loop reads ``health`` every step as well).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from ..core import flags as _flags

__all__ = ["grad_global_norm", "resolve_guard", "step_health",
           "gated_update", "resolve_numerics", "tensor_stats",
           "grad_numerics", "NUMERIC_STATS"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in _leaves(tree[key])]
    return [tree]


def _whole(x):
    """A DTensor statistic as a plain tensor, its partial results reduced
    over the mesh (``full_tensor``: a collective, no host read), so every
    rank holds the same value; a plain tensor itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def grad_global_norm(grads):
    """Global L2 norm of a gradient tree, accumulated in float32: one
    reduction a leaf, which reads the leaf once in its own type
    (``vector_norm`` with a float32 ``dtype`` makes no float32 copy),
    then the norm of those norms. A sharded (DTensor) leaf's norm is
    reduced across the mesh."""
    return torch.linalg.vector_norm(torch.stack([
        _whole(torch.linalg.vector_norm(g, dtype=torch.float32))
        for g in _leaves(grads)]))


def resolve_guard(guard: Optional[bool]) -> bool:
    """``make_train_step``'s guard default: ``None`` reads
    ``FLAGS_enable_sentinel`` when the step is built."""
    return _flags.flag_value("enable_sentinel") if guard is None else guard


def resolve_numerics(numerics: Optional[bool]) -> bool:
    """``make_train_step``'s numerics default: ``None`` reads
    ``FLAGS_enable_numerics`` when the step is built. The numerics block
    exists on the guarded step only; callers gate the resolved value on
    the resolved guard."""
    return _flags.flag_value("enable_numerics") if numerics is None \
        else numerics


# The per-tensor statistic names every numerics consumer keys on.
NUMERIC_STATS = ("absmax", "rms", "mean", "zero_frac", "overflow_frac",
                 "underflow_frac", "gnorm_sq")


def _dtype_range(dtype):
    """``(overflow threshold, underflow threshold)`` of a float dtype: a
    value within 2x of ``finfo.max`` is one optimizer scale-up from
    saturating; a nonzero value below ``finfo.tiny`` is in the subnormal
    band. Integer tensors have no float range: both thresholds
    disable."""
    if not dtype.is_floating_point:
        return float("inf"), 0.0
    fi = torch.finfo(dtype)
    return float(fi.max) / 2.0, float(fi.tiny)


def tensor_stats(x, reduce_axes=None):
    """``{absmax, rms, mean, zero_frac, overflow_frac, underflow_frac,
    gnorm_sq}`` of ``x`` in float32, reduced over ``reduce_axes`` (None:
    every axis, scalars; a tuple keeps the other axes, e.g. axis 0 of a
    stacked ``[L, ...]`` weight gives per-layer ``[L]`` rows). Overflow
    and underflow fractions are measured against ``x``'s own dtype range
    (``_dtype_range``). A DTensor's statistics are reduced across its
    mesh."""
    over_t, under_t = _dtype_range(x.dtype)
    xf = x.float()
    ax = tuple(range(x.ndim)) if reduce_axes is None else tuple(reduce_axes)
    absx = xf.abs()
    n = 1
    for a in ax:
        n *= x.shape[a]
    n = float(n)
    sumsq = _whole(torch.sum(xf * xf, dim=ax))
    return {
        "absmax": _whole(torch.amax(absx, dim=ax)),
        "rms": torch.sqrt(sumsq / n),
        "mean": _whole(torch.sum(xf, dim=ax)) / n,
        "zero_frac": _whole(torch.sum((xf == 0.0).float(), dim=ax)) / n,
        "overflow_frac": _whole(torch.sum((absx > over_t).float(),
                                          dim=ax)) / n,
        "underflow_frac": _whole(torch.sum(
            ((absx < under_t) & (xf != 0.0)).float(), dim=ax)) / n,
        "gnorm_sq": sumsq,
    }


def grad_numerics(grads):
    """Per-tensor numerics of a gradient tree. Leaves under the top-level
    ``"layers"`` key are stacked ``[L, ...]`` weights: their statistics
    keep axis 0, one row a layer. Every other leaf reduces to scalars. The
    squared norms tile the global norm: ``sqrt(sum of every gnorm_sq
    entry) == grad_global_norm(grads)``.

    Returns ``{"layers": {name: {stat: [L]}}, "tensors": {name: {stat:
    scalar}}}``, float32 tensors on the gradients' device."""
    out = {"layers": {}, "tensors": {}}
    for name, g in grads.items():
        if name == "layers":
            for lname, lg in g.items():
                out["layers"][lname] = tensor_stats(
                    lg, reduce_axes=tuple(range(1, lg.ndim)))
        else:
            out["tensors"][name] = tensor_stats(g)
    return out


def step_health(loss, grads, inp, vocab_size: int, gnorm_cap):
    """``(ok, health)`` of one guarded train step. ``ok`` (a bool tensor)
    is true when the update may apply: finite loss, finite global
    gradient norm, every input token id in ``[0, vocab_size)`` and the
    norm at most ``gnorm_cap`` (a float or a tensor; +inf disables it).
    ``health`` is ``{"finite": ok, "grad_norm": norm}``. Nothing is read
    back to the host. On a mesh (DTensor loss, grads, ids) every
    reduction is taken over the mesh, so ``ok`` and the norm are the same
    on every rank."""
    gnorm = grad_global_norm(grads)
    if isinstance(inp, DTensor):
        loss = _whole(loss)
        ids_ok = _whole(((inp < 0) | (inp >= vocab_size)).sum()) == 0
    else:
        ids_ok = torch.all((inp >= 0) & (inp < vocab_size))
    ok = (torch.isfinite(loss) & torch.isfinite(gnorm) & ids_ok
          & (gnorm <= gnorm_cap))
    return ok, {"finite": ok, "grad_norm": gnorm}


def gated_update(ok, update_fn, params, opt_state, grads):
    """``update_fn(params, opt_state, grads)`` when ``ok``, else
    ``(params, opt_state)`` untouched: the all-or-nothing gate. ``ok`` is
    read on the host here, once; an anomalous step writes nothing, so
    parameters, moments and the step count stay byte-identical."""
    if bool(ok):
        return update_fn(params, opt_state, grads)
    return params, opt_state
