"""The current device of the eager surface (port of ``get_device`` /
``set_device``, ``paddle_tpu/device/__init__.py:120-134``).

Parameters, ``to_tensor`` and the seeded generator are made on the
current device. It defaults to the card and raises where there is none,
as ``core.device.resolve_device`` does; ``set_device("cpu")`` asks for
the CPU (where every kernel wrapper takes its plain version).
"""
from __future__ import annotations

import torch

from ..core import enforce as E
from ..core.device import resolve_device

__all__ = ["get_device", "set_device", "to_torch_device"]

_current_device = None      # a Paddle device string, or None: the card


def to_torch_device(device=None) -> torch.device:
    """A Paddle device string (``"cpu"``, ``"gpu"``, ``"gpu:1"``; also
    ``"cuda[:i]"`` or a ``torch.device``) as a ``torch.device``; ``None``
    is the current device."""
    if device is None:
        device = _current_device
    if device is None:
        return resolve_device(None)
    if isinstance(device, torch.device):
        return resolve_device(device)
    name = str(device).lower()
    kind, _, index = name.partition(":")
    E.enforce(kind in ("cpu", "gpu", "cuda"),
              f"unknown device {device!r}: expected 'cpu', 'gpu' or "
              f"'gpu:<index>'", error=E.InvalidArgumentError)
    if kind == "cpu":
        return torch.device("cpu")
    E.enforce(torch.cuda.is_available(), f"device {device!r}: no CUDA "
              f"device is available", error=E.UnavailableError,
              hint="set_device('cpu') runs the plain PyTorch versions on "
                   "the CPU")
    return resolve_device(f"cuda:{index}" if index else "cuda")


def get_device() -> str:
    """The current device as Paddle names it: ``"cpu"`` or ``"gpu:<i>"``.
    Raises without a card unless the CPU was asked for."""
    dev = to_torch_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def set_device(device):
    """Make ``device`` (see ``to_torch_device``) the current device and
    return its Paddle name."""
    global _current_device
    dev = to_torch_device(device)
    _current_device = "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"
    return _current_device
