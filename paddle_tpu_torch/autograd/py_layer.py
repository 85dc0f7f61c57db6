"""PyLayer: user-defined differentiable operations (port of
``paddle_tpu/autograd/py_layer.py``; reference:
python/paddle/autograd/py_layer.py, PyLayer and PyLayerContext).

A ``PyLayer`` subclass's static ``forward(ctx, *args, **kwargs)`` and
``backward(ctx, *grads)`` run inside one ``torch.autograd.Function``:
the forward with grad recording off, as the reference's, and the
backward returning one grad per positional Tensor input of ``forward``
(None for one that needs none); Tensors passed by keyword get no grad.
Under ``create_graph`` torch runs the backward with grad recording on, so
its ops record and the grads it returns can be differentiated again.
"""
from __future__ import annotations

import torch

from ..core import enforce as E

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    """The ``ctx`` of ``forward`` and ``backward`` (reference:
    PyLayerContext). Other values can be stored as its attributes."""

    def __init__(self, fn_ctx):
        self._fn_ctx = fn_ctx
        self._materialize_grads = True
        self._not_inplace = False

    def save_for_backward(self, *tensors):
        """Stash tensors for the backward; an open
        ``autograd.saved_tensors_hooks`` packs them now and unpacks them
        at backward time."""
        self._fn_ctx.save_for_backward(*tensors)

    def saved_tensor(self):
        return list(self._fn_ctx.saved_tensors)

    def set_materialize_grads(self, value: bool):
        """With False, the grads of outputs that got none reach
        ``backward`` as None instead of zeros."""
        self._materialize_grads = bool(value)
        self._fn_ctx.set_materialize_grads(bool(value))

    def mark_not_inplace(self, *args):
        """Recorded only: torch makes an input returned as an output a new
        view, so nothing is modified in place."""
        self._not_inplace = True


class _Function(torch.autograd.Function):
    """The torch Function behind every ``PyLayer.apply``: its first two
    arguments are the layer class and the keyword arguments."""

    @staticmethod
    def forward(fn_ctx, layer, kwargs, *args):
        ctx = PyLayerContext(fn_ctx)
        fn_ctx.pylayer = (layer, ctx, len(args),
                          [i for i, a in enumerate(args)
                           if isinstance(a, torch.Tensor)])
        return layer.forward(ctx, *args, **kwargs)

    @staticmethod
    def backward(fn_ctx, *grads):
        layer, ctx, nargs, tensor_pos = fn_ctx.pylayer
        got = layer.backward(ctx, *grads)
        got = list(got) if isinstance(got, (tuple, list)) else [got]
        if len(got) != len(tensor_pos):
            raise E.InvalidArgumentError(
                f"{layer.__name__}.backward returned {len(got)} grads "
                f"but forward received {len(tensor_pos)} Tensor "
                "inputs -- they must match one-to-one")
        full = [None] * (2 + nargs)
        for pos, g in zip(tensor_pos, got):
            if fn_ctx.needs_input_grad[2 + pos]:
                full[2 + pos] = g
        return tuple(full)


class PyLayer:
    """Define a custom differentiable op by subclassing with static
    ``forward(ctx, *args)`` and ``backward(ctx, *grads)`` methods, then
    call ``.apply(*args)`` (reference: python/paddle/autograd/py_layer.py).
    ``backward`` returns one grad per Tensor positional input of
    ``forward`` (None for unneeded ones)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError(
            "PyLayer subclasses must implement a forward staticmethod")

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError(
            "PyLayer subclasses must implement a backward staticmethod")

    @classmethod
    def apply(cls, *args, **kwargs):
        return _Function.apply(cls, kwargs, *args)
