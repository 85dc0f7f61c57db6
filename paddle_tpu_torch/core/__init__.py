from . import enforce  # noqa: F401
from .device import resolve_device  # noqa: F401
