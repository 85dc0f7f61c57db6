"""The op dispatch seam (port of ``paddle_tpu/ops/_op.py``).

``@op_fn`` registers a function under the reference's op name and gives
back the function that users call. The function itself is plain
PyTorch: torch's autograd records its tape, so the reference's
``jax.vjp`` closures, deferred backward cache and ``eager_jit_ops`` have
no counterpart. What the seam keeps is the reference's per-op
instrumentation, all off by default:

- ``FLAGS_enable_monitor``: ``op.<name>.calls`` and the
  ``op.dispatch.wall_ns`` histogram (``monitor.record_op``), and each
  output's bytes into ``tensor.bytes.live`` / ``peak``;
- the profile hook (``set_profile_hook``): while a profiler window
  records, each call is one host span under the op's name, and the
  torch calls inside it are not spanned again;
- ``FLAGS_check_nan_inf``: a non-finite float output raises
  ``FloatingPointError`` naming the op (on the card a host read, made
  only while the flag is on).

With all three off a call costs two attribute reads and a branch on top
of the function. ``differentiable=False`` runs the function under
``torch.no_grad()``: its outputs never require grad, as the reference's
are ``stop_gradient``. ``nondiff_args`` positions are detached.

Not ported yet: the AMP auto-cast seam (waits for ``amp/``) and the
static-build and segmented-capture seams (wait for ``jit/`` and
``static/``).
"""
from __future__ import annotations

import functools
import time
from typing import Callable

import torch

from ..core.flags import flag_info
from ..core import tensor as _tensor

__all__ = ["op_fn", "get_op", "registered_ops", "set_profile_hook", "wrap"]

_MON_FLAG = flag_info("enable_monitor")
_NAN_FLAG = flag_info("check_nan_inf")
_MON_RECORD = None

_OP_REGISTRY = {}

# (begin(name), end()) while a profiler window records, else None
_PROFILE_HOOK = None


def set_profile_hook(begin, end):
    global _PROFILE_HOOK
    _PROFILE_HOOK = (begin, end) if begin is not None else None


def wrap(t):
    """A tensor made outside a registered op (the creation and random
    functions): counted into the tensor-byte gauges while the monitor is
    on, as the reference's constructor counts every handle."""
    if _MON_FLAG.value:
        _tensor._count(t)
    return t


def _outputs(out):
    if isinstance(out, torch.Tensor):
        return (out,)
    if isinstance(out, (tuple, list)):
        return tuple(o for o in out if isinstance(o, torch.Tensor))
    return ()


def _check_nan_inf(opname, out):
    for o in _outputs(out):
        if o.is_floating_point() or o.is_complex():
            if not bool(torch.isfinite(o).all()):
                raise FloatingPointError(
                    f"NaN/Inf detected in output of op '{opname}'")


def _instrumented(opname, run, args, kwargs):
    global _MON_RECORD
    ph = _PROFILE_HOOK
    mon = _MON_FLAG.value
    if ph is not None:
        ph[0](opname)
    t0 = time.perf_counter_ns() if mon else 0
    try:
        out = run(*args, **kwargs)
        if _NAN_FLAG.value:
            _check_nan_inf(opname, out)
        if mon:
            for o in _outputs(out):
                _tensor._count(o)
        return out
    finally:
        if t0:
            if _MON_RECORD is None:
                from ..monitor import record_op as _MON_RECORD  # noqa
            _MON_RECORD(opname, time.perf_counter_ns() - t0)
        if ph is not None:
            ph[1]()


def op_fn(fn: Callable = None, *, name: str = None,
          differentiable: bool = True, nondiff_args: tuple = ()):
    """Register ``fn`` as the op ``name`` (default: its own name) and
    return the dispatching function (``.op_name``, ``.pure_fn``)."""
    if fn is None:
        return functools.partial(op_fn, name=name,
                                 differentiable=differentiable,
                                 nondiff_args=nondiff_args)
    opname = name or fn.__name__
    run = fn
    if not differentiable:
        def run(*args, **kwargs):
            with torch.no_grad():
                return fn(*args, **kwargs)
    elif nondiff_args:
        def run(*args, **kwargs):
            args = tuple(a.detach() if i in nondiff_args
                         and isinstance(a, torch.Tensor) else a
                         for i, a in enumerate(args))
            return fn(*args, **kwargs)

    @functools.wraps(fn)
    def dispatch(*args, **kwargs):
        if (_PROFILE_HOOK is None and not _MON_FLAG.value
                and not _NAN_FLAG.value):
            return run(*args, **kwargs)
        return _instrumented(opname, run, args, kwargs)

    dispatch.pure_fn = fn
    dispatch.op_name = opname
    _OP_REGISTRY[opname] = dispatch
    return dispatch


def get_op(name: str):
    return _OP_REGISTRY.get(name)


def registered_ops():
    return dict(_OP_REGISTRY)
