"""Automatic mixed precision (port of ``paddle_tpu/amp/auto_cast.py``).

O1 casts op by op at the dispatch seam (``ops/_op.py`` asks
``current_cast_dtype_for`` for each registered op): a white-list op's
positional float inputs become the AMP dtype, a black-list op's float32.
O2 casts whole layers with ``decorate``: every float parameter but those
of the norm layers, in place on the same ``Parameter`` objects, and the
optimizers keep float32 master weights (``_multi_precision``).
bfloat16 needs no loss scaling; float16 pairs with ``GradScaler``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..core.dtype import convert_dtype
from . import amp_lists

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate",
           "is_auto_cast_enabled", "current_cast_dtype_for", "white_list",
           "black_list"]


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.white = frozenset()
        self.black = frozenset()


_amp = _AmpState()


def is_auto_cast_enabled() -> bool:
    return _amp.enabled


def white_list():
    return _amp.white


def black_list():
    return _amp.black


def current_cast_dtype_for(opname: str):
    """The dtype the dispatch seam casts the op's positional float inputs
    to, or None to leave them as they are."""
    if not _amp.enabled:
        return None
    if opname in _amp.white:
        return _amp.dtype
    if opname in _amp.black:
        return torch.float32
    return None


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16", use_promote: bool = True):
    """``paddle.amp.auto_cast``: the lists (the defaults plus the custom
    ones, a custom white name leaving the black list and the other way
    round; at O2 no white name stays black) and the dtype for this
    thread, restored on exit."""
    dt = convert_dtype(dtype)  # validated before any state changes
    white = set(amp_lists.WHITE_LIST)
    black = set(amp_lists.BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    if level == "O2":
        black -= white
    prev = (_amp.enabled, _amp.dtype, _amp.level, _amp.white, _amp.black)
    try:
        _amp.enabled = bool(enable)
        _amp.dtype = dt
        _amp.level = level
        _amp.white = frozenset(white)
        _amp.black = frozenset(black)
        yield
    finally:
        (_amp.enabled, _amp.dtype, _amp.level, _amp.white,
         _amp.black) = prev


amp_guard = auto_cast

_KEEP_FP32_LAYERS = ("BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm",
                     "RMSNorm", "SyncBatchNorm")


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight=None,
             save_dtype=None, master_grad=False, excluded_layers=None):
    """``paddle.amp.decorate``: at O2 every float parameter of the models
    but the norm layers' (and ``excluded_layers``') becomes ``dtype`` in
    place, and each optimizer keeps float32 master weights."""
    dt = convert_dtype(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        for model in model_list:
            for layer in model.sublayers(include_self=True):
                name = type(layer).__name__
                if any(name.startswith(k) for k in _KEEP_FP32_LAYERS):
                    continue
                if excluded_layers and isinstance(
                        layer, tuple(excluded_layers)):
                    continue
                for p in layer._parameters.values():
                    if p is not None and p.is_floating_point():
                        p.data = p.data.to(dt)
        if optimizers is not None:
            opt_list = optimizers if isinstance(
                optimizers, (list, tuple)) else [optimizers]
            for o in opt_list:
                if hasattr(o, "_multi_precision"):
                    o._multi_precision = True
    if optimizers is None:
        return models if isinstance(models, (list, tuple)) else model_list[0]
    return (models if isinstance(models, (list, tuple)) else model_list[0],
            optimizers)


amp_decorate = decorate
