"""Global eager-mode state (port of ``paddle_tpu/core/state.py``): grad
recording and functional mode.

Grad recording is torch's own grad mode: ``no_grad`` / ``enable_grad``
are ``torch.no_grad`` / ``torch.enable_grad`` (context managers and
decorators), and ``set_grad_enabled`` switches it for the calling thread
and returns the previous mode, as the reference's does. Functional mode
is a recorded state only: the reference sets it while ``jax.jit`` /
``jax.grad`` trace a step, to bypass its eager tape; the port has one
graph, torch's, so nothing reads it but ``grad_enabled``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "grad_enabled",
           "functional_mode", "in_functional_mode"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad


class _State(threading.local):
    def __init__(self):
        self.functional_depth = 0


_state = _State()


def grad_enabled() -> bool:
    """Whether ops record grads: torch's grad mode, outside functional
    mode."""
    return torch.is_grad_enabled() and _state.functional_depth == 0


def in_functional_mode() -> bool:
    return _state.functional_depth > 0


@contextlib.contextmanager
def functional_mode():
    _state.functional_depth += 1
    try:
        yield
    finally:
        _state.functional_depth -= 1


def set_grad_enabled(mode: bool) -> bool:
    """Switch grad recording on this thread; returns the previous mode."""
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(bool(mode))
    return prev
