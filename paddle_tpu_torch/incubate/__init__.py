"""``paddle.incubate`` (port of the fused-op part of
``paddle_tpu/incubate``, and ``incubate.autotune``)."""
from . import autotune, nn  # noqa: F401
