"""Data pipeline pieces of the port (``paddle_tpu/io``): sequence
packing."""
from . import packing  # noqa: F401
