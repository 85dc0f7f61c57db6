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

The AMP auto-cast seam (``amp.auto_cast``): while it is on, a white-list
op's positional floating inputs are cast to the AMP dtype and a
black-list op's to float32 before the function runs (keyword inputs
stay as they are, as the reference's). The cast is a torch op inside
autograd, so each gradient comes back in its input's own type: a float32
parameter of a bfloat16 product gets a float32 gradient. (The reference
differentiates with respect to the cast arrays, so a producer of a cast
input receives a cotangent of the cast type and its backward raises: its
eager models cannot train under ``auto_cast``.)

With all four off a call costs four attribute reads (the AMP state's a
thread-local one) and two branches on top of the function.
``differentiable=False`` runs the function under ``torch.no_grad()``:
its outputs never require grad, as the reference's are ``stop_gradient``.
``nondiff_args`` positions are detached.

Not ported yet: the static-build and segmented-capture seams (wait for
``jit/`` and ``static/``).
"""
from __future__ import annotations

import functools
import time
from typing import Callable

import torch

from ..amp.auto_cast import _amp as _AMP
from ..amp.auto_cast import current_cast_dtype_for as _cast_dtype_for
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


def _amp_cast(opname, args):
    """``args`` with each floating tensor cast to the op's AMP dtype
    (``amp.current_cast_dtype_for``), when it has one."""
    dt = _cast_dtype_for(opname)
    if dt is None:
        return args
    return tuple(a.to(dt) if isinstance(a, torch.Tensor)
                 and a.is_floating_point() and a.dtype != dt else a
                 for a in args)


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
        if _AMP.enabled:
            args = _amp_cast(opname, args)
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
