"""paddle_tpu_torch — the PyTorch + CUDA port of ``paddle_tpu``.

The JAX package beside it stays the reference. This package mirrors its
layout module by module (``models/llama.py``, ``inference/paged.py``,
``inference/engine.py``, ``io/``, ``kernels/...``, the eager ``nn`` /
``optimizer`` surface, ``paddle.save`` / ``load``, ``metric``, the
hapi ``Model``, ``profiler``, ``autograd`` and the kernel autotuner) and
runs on an NVIDIA Hopper card: every
Pallas kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the eager surface: ``set_device("cpu")``); on the CPU every kernel
wrapper takes its plain PyTorch version. Nothing here imports ``jax`` or
``paddle_tpu``.
"""
__version__ = "0.1.0"

from . import autograd, incubate, nn, optimizer, profiler  # noqa: F401
from .autograd import grad  # noqa: F401
from .core.state import enable_grad, no_grad, set_grad_enabled  # noqa
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.tensor import to_tensor  # noqa: F401
from .device import get_device, set_device  # noqa: F401
from .framework.random import seed  # noqa: F401
from .framework.io import (async_save, clear_async_save_task_queue,  # noqa
                           load, save)
from . import io, metric  # noqa: F401
from . import hapi  # noqa: F401
from .hapi import Model, summary  # noqa: F401
from . import callbacks  # noqa: F401
