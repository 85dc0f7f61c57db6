"""Paddle's dtype names over torch dtypes (port of
``paddle_tpu/core/dtype.py``).

The canonical dtype objects are torch's own (``float32`` is
``torch.float32``), so a dtype passes to a torch call unchanged. The
names, ``convert_dtype``, the default floating type and the predicates
are the reference's. One difference, by design: the reference turns
64-bit types into their 32-bit ones while JAX runs without x64; the port
keeps ``int64`` and ``float64`` (torch's index type is ``int64``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import enforce as E

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "is_floating_point", "is_integer", "is_complex",
           "get_default_dtype", "set_default_dtype"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "bf16": bfloat16, "float32": float32,
    "fp32": float32, "float64": float64, "fp64": float64,
    "complex64": complex64, "complex128": complex128,
}

_INTEGER = (uint8, int8, int16, int32, int64)


def convert_dtype(dtype):
    """A Paddle dtype name, numpy dtype, Python type or ``torch.dtype`` as
    a ``torch.dtype`` (``None`` stays ``None``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        E.enforce(key in _NAME_TO_DTYPE, f"Unknown dtype name: {dtype!r}",
                  error=E.InvalidArgumentError)
        return _NAME_TO_DTYPE[key]
    name = np.dtype(dtype).name
    E.enforce(name in _NAME_TO_DTYPE, f"Unknown dtype: {dtype!r}",
              error=E.InvalidArgumentError)
    return _NAME_TO_DTYPE[name]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in _INTEGER


def is_complex(dtype) -> bool:
    return convert_dtype(dtype).is_complex


_DEFAULT_DTYPE = [float32]


def get_default_dtype():
    """The floating type that creation and random ops make by default
    (``paddle.get_default_dtype``); float32 unless set."""
    return _DEFAULT_DTYPE[0]


def set_default_dtype(dtype):
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError(f"set_default_dtype only accepts floating dtypes, "
                        f"got {dtype}")
    _DEFAULT_DTYPE[0] = d
