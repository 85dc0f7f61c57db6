"""Typed errors of the port: a local copy of the part of the reference's
enforce system (``paddle_tpu/core/enforce.py``) that the port
raises. Each error is also the natural builtin, so callers that catch
``ValueError`` / ``MemoryError`` / ``RuntimeError`` keep working."""
from __future__ import annotations

from typing import Any, Optional

__all__ = ["EnforceError", "InvalidArgumentError", "ResourceExhaustedError",
           "PreconditionNotMetError", "UnimplementedError",
           "UnavailableError", "enforce"]


class EnforceError(Exception):
    """Base of all typed errors; ``code`` mirrors the reference's codes."""

    code = 0
    type_name = "Error"

    def __init__(self, message: str, hint: Optional[str] = None):
        self.message = message
        self.hint = hint
        text = f"{self.type_name}: {message}"
        if hint:
            text += f" [Hint: {hint}]"
        self._text = text
        super().__init__(text)

    def __str__(self):
        return self._text


def _make(name, code, *bases):
    return type(name, (EnforceError, *bases),
                {"code": code, "type_name": name.removesuffix("Error")})


InvalidArgumentError = _make("InvalidArgumentError", 1, ValueError)
ResourceExhaustedError = _make("ResourceExhaustedError", 5, MemoryError)
PreconditionNotMetError = _make("PreconditionNotMetError", 6, RuntimeError)
UnimplementedError = _make("UnimplementedError", 9, NotImplementedError)
UnavailableError = _make("UnavailableError", 10, RuntimeError)


def enforce(cond: Any, message: str,
            error: type = PreconditionNotMetError,
            hint: Optional[str] = None):
    """Raise ``error`` when ``cond`` is falsy."""
    if not cond:
        raise error(message, hint)
