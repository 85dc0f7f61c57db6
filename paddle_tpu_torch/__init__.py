"""paddle_tpu_torch — the PyTorch + CUDA port of ``paddle_tpu``.

The JAX package beside it stays the reference. This package mirrors its
layout module by module (``models/llama.py``, ``inference/paged.py``,
``inference/engine.py``, ``io/packing.py``, ``kernels/...``, the eager
``nn`` / ``optimizer`` surface) and runs on an NVIDIA Hopper card: every
Pallas kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the eager surface: ``set_device("cpu")``); on the CPU every kernel
wrapper takes its plain PyTorch version. Nothing here imports ``jax`` or
``paddle_tpu``.
"""
__version__ = "0.1.0"

from . import incubate, nn, optimizer  # noqa: F401
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.tensor import to_tensor  # noqa: F401
from .device import get_device, set_device  # noqa: F401
from .framework.random import seed  # noqa: F401
