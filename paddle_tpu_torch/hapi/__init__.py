"""hapi: the high-level train / eval / predict API (port of
``paddle_tpu/hapi``)."""
from . import callbacks  # noqa: F401
from .model import Model, summary  # noqa: F401
