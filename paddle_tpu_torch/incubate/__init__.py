"""``paddle.incubate`` (port of the fused-op part of
``paddle_tpu/incubate``)."""
from . import nn  # noqa: F401
