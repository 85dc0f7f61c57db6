"""The tensor of the port (port of ``paddle_tpu/core/tensor.py``):
``Tensor``, ``Parameter``, ``is_tensor``, ``to_tensor`` and the
monitor's tensor-byte hooks.

The port has no Tensor class of its own: ``Tensor`` is
``torch.Tensor``, which already records the tape that the reference's
``Tensor`` builds, and ``Parameter`` is ``torch.nn.Parameter``, what
``nn.Layer.create_parameter`` makes. Paddle's ``stop_gradient`` is
``not requires_grad``. Nothing is patched onto ``torch.Tensor``: the
Paddle surface is the flat functions of ``paddle_tpu_torch.ops``.

While ``FLAGS_enable_monitor`` is on, ``to_tensor`` and every output of
a registered op count their bytes into ``tensor.bytes.live`` / ``peak``
(``monitor.tensor_bytes``) and return them when the tensor dies
(``monitor.tensor_free`` from a ``weakref.finalize``), as the
reference's constructor does. With the flag off the cost is one
attribute read.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from .dtype import convert_dtype  # noqa: F401  (its old home)
from .flags import flag_info

__all__ = ["Tensor", "Parameter", "is_tensor", "convert_dtype", "to_tensor",
           "from_numpy"]

Tensor = torch.Tensor
Parameter = torch.nn.Parameter

# cached flag record (set_flags mutates it in place); the monitor's
# helpers are bound on first use, since this module loads before it
_MON_FLAG = flag_info("enable_monitor")
_MON_TENSOR_BYTES = None
_MON_TENSOR_FREE = None


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _count(t):
    """Count ``t``'s bytes into the live / peak gauges and return them
    when it dies; callers check ``_MON_FLAG.value`` first. Every handle
    counts, as in the reference, where each op output is a new handle."""
    global _MON_TENSOR_BYTES, _MON_TENSOR_FREE
    if _MON_TENSOR_BYTES is None:
        # free before bytes: a thread that sees _MON_TENSOR_BYTES bound
        # registers _MON_TENSOR_FREE without checking it
        from ..monitor import tensor_free as _MON_TENSOR_FREE  # noqa
        from ..monitor import tensor_bytes as _MON_TENSOR_BYTES  # noqa
    nb = t.numel() * t.element_size()
    if nb:
        epoch = _MON_TENSOR_BYTES(nb)
        if epoch is not None:
            weakref.finalize(t, _MON_TENSOR_FREE, nb, epoch)
    return t


def from_numpy(a) -> torch.Tensor:
    """A CPU tensor from array-like ``a``; a bfloat16 numpy array (as JAX
    hands them out) goes through float32, which is lossless."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True):
    """``paddle.to_tensor``: a new tensor on ``place`` (default: the
    current device, which raises without a card unless the CPU was asked
    for) holding ``data``. Python and numpy float64 data become float32,
    Paddle's default type, unless ``dtype`` says otherwise.
    ``stop_gradient=False`` makes a leaf that requires grad."""
    from ..device import to_torch_device
    dev = to_torch_device(place)
    dtype = convert_dtype(dtype)
    if torch.is_tensor(data):
        t = data.detach()
    else:
        t = from_numpy(data)
    if dtype is None and t.dtype == torch.float64:
        dtype = torch.float32
    t = t.to(device=dev, dtype=dtype, copy=True)
    if not stop_gradient:
        t.requires_grad_()
    if _MON_FLAG.value:
        _count(t)
    return t
