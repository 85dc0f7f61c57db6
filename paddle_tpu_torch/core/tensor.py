"""``to_tensor`` and Paddle dtype names (port of ``to_tensor``,
``paddle_tpu/core/tensor.py:484``, and a copy of ``convert_dtype``,
``paddle_tpu/core/dtype.py:51``).

The port has no Tensor class of its own: ``torch.Tensor`` already
records the tape that the reference's ``Tensor`` builds, and Paddle's
``stop_gradient`` is ``not requires_grad``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import enforce as E

__all__ = ["convert_dtype", "to_tensor", "from_numpy"]

_NAME_TO_DTYPE = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16, "float32": torch.float32, "fp32": torch.float32,
    "float64": torch.float64, "fp64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


def convert_dtype(dtype):
    """A Paddle dtype name, numpy dtype or ``torch.dtype`` as a
    ``torch.dtype`` (``None`` stays ``None``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        E.enforce(key in _NAME_TO_DTYPE, f"Unknown dtype name: {dtype!r}",
                  error=E.InvalidArgumentError)
        return _NAME_TO_DTYPE[key]
    return _NAME_TO_DTYPE[np.dtype(dtype).name]


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
    return t
