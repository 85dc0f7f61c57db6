"""``paddle.autograd`` (port of ``paddle_tpu/autograd``; reference:
python/paddle/autograd/): ``backward``, ``grad``, ``jacobian``,
``hessian``, ``PyLayer``, ``saved_tensors_hooks`` and the grad-mode
switches.

Torch's autograd graph is the tape: the reference's ``tape.py``
(``GradNode``, ``record_node``, ``run_backward``) has no counterpart,
and ``backward`` is ``torch.autograd.backward``. ``grad`` keeps the
reference's signature and its error for an unused input.
"""
from __future__ import annotations

import torch

from ..core import enforce as E
from ..core import state as _state
from ..core.state import enable_grad, no_grad, set_grad_enabled  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401

__all__ = ["backward", "grad", "jacobian", "hessian", "PyLayer",
           "PyLayerContext", "saved_tensors_hooks", "is_grad_enabled",
           "no_grad", "enable_grad", "set_grad_enabled"]

# pack_hook(tensor) -> handle at save time, unpack_hook(handle) -> tensor
# at backward time, over every tensor saved in the block (PyLayer's
# save_for_backward included)
saved_tensors_hooks = torch.autograd.graph.saved_tensors_hooks


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: accumulate the grads of ``tensors`` into
    the leaves' ``.grad``."""
    torch.autograd.backward(
        _as_list(tensors),
        None if grad_tensors is None else _as_list(grad_tensors),
        retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False):
    """paddle.grad: the grads of ``outputs`` with respect to ``inputs``
    as a list, without touching any ``.grad``. ``retain_graph`` defaults
    to ``create_graph``; with ``create_graph`` the grads carry their own
    graph and can be differentiated again. An input the outputs do not
    reach raises unless ``allow_unused``, and is then None."""
    inputs = _as_list(inputs)
    gs = torch.autograd.grad(
        _as_list(outputs), inputs,
        grad_outputs=None if grad_outputs is None
        else _as_list(grad_outputs),
        retain_graph=retain_graph, create_graph=create_graph,
        allow_unused=True)
    if not allow_unused and any(g is None for g in gs):
        raise E.PreconditionNotMetError(
            "One of the differentiated tensors appears to not have "
            "been used in the graph (set allow_unused=True to allow).")
    return list(gs)


def _dense_jacobian(y, xs):
    """``[d y / d x for x in xs]``, each ``y.shape + x.shape``: one
    backward a unit cotangent of ``y``."""
    n = y.numel()
    rows = []
    for i in range(n):
        cot = torch.zeros(n, dtype=y.dtype, device=y.device)
        cot[i] = 1.0
        rows.append(torch.autograd.grad(
            [y], xs, grad_outputs=[cot.reshape(y.shape)],
            retain_graph=True, allow_unused=True) if y.requires_grad
            else (None,) * len(xs))
    out = []
    for xi, x in enumerate(xs):
        flat = [torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
                if r[xi] is None else r[xi].reshape(-1) for r in rows]
        out.append(torch.stack(flat).reshape(tuple(y.shape)
                                             + tuple(x.shape)))
    return out


def _per_sample(jac, y_ndim):
    """The batch-diagonal blocks ``jac[b, ..., b, ...]`` of a dense
    Jacobian whose ``y`` and ``x`` share a leading batch axis."""
    lead = (slice(None),) * (y_ndim - 1)
    return torch.stack([jac[b][lead + (b,)] for b in range(jac.shape[0])])


def jacobian(ys, xs, batch_axis=None):
    """Dense Jacobian ``d ys / d xs`` (reference: autograd.py jacobian,
    materialized): ``ys.shape + xs.shape``, or nested lists when ``ys``
    or ``xs`` are sequences. With ``batch_axis=0`` the first axis of
    ``ys`` and ``xs`` is a batch of independent samples and each result
    is ``[B] + ys.shape[1:] + xs.shape[1:]``, the blocks of one sample
    (upstream Paddle's batched form; the reference ignores the
    argument)."""
    E.enforce(batch_axis in (None, 0),
              f"jacobian: batch_axis must be None or 0, got {batch_axis}",
              error=E.InvalidArgumentError)
    xs_l = _as_list(xs)
    out = []
    for y in _as_list(ys):
        per_x = _dense_jacobian(y, xs_l)
        if batch_axis == 0:
            per_x = [_per_sample(j, y.ndim) for j in per_x]
        out.append(per_x if isinstance(xs, (list, tuple)) else per_x[0])
    return out if isinstance(ys, (list, tuple)) else out[0]


def hessian(ys, xs, batch_axis=None):
    """Dense Hessian of a scalar ``ys`` (with ``batch_axis=0``: of each
    sample's entry of ``ys [B]``) with respect to ``xs``: the Jacobian of
    the ``create_graph`` gradient (reference: autograd.py hessian)."""
    xs_l = _as_list(xs)
    y = ys.sum() if batch_axis == 0 else ys
    g = grad([y], xs_l, create_graph=True, retain_graph=True)
    if not isinstance(xs, (list, tuple)):
        return jacobian(g[0], xs_l[0], batch_axis=batch_axis)
    return [[jacobian(gi, xj, batch_axis=batch_axis) for xj in xs_l]
            for gi in g]


def is_grad_enabled() -> bool:
    """Whether ops record grads now."""
    return _state.grad_enabled()
