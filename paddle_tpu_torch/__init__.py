"""paddle_tpu_torch — the PyTorch + CUDA port of ``paddle_tpu``.

The JAX package beside it stays the reference. This package mirrors its
layout module by module (``models/llama.py``, ``inference/paged.py``,
``inference/engine.py``, ``io/``, ``kernels/...``, the eager ``nn`` /
``optimizer`` surface, the flat op library (``paddle.add``, ``concat``,
``matmul``, ...: ``ops/``, ``tensor/``), ``paddle.save`` / ``load``,
``metric``, the hapi ``Model``, ``profiler``, ``autograd``, the
kernel autotuner, ``amp`` and the ``fft`` / ``linalg`` / ``signal``
namespaces) and
runs on an NVIDIA Hopper card: every
Pallas kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the eager surface: ``set_device("cpu")``); on the CPU every kernel
wrapper takes its plain PyTorch version. Nothing here imports ``jax`` or
``paddle_tpu``.
"""
__version__ = "0.1.0"

from .core.dtype import (bfloat16, bool_, complex64, complex128,  # noqa
                         float16, float32, float64, get_default_dtype, int8,
                         int16, int32, int64, set_default_dtype, uint8)
from .core.tensor import Parameter, Tensor, is_tensor  # noqa: F401
# the flat op surface (paddle.add, concat, matmul, ...); ops/__init__'s
# __all__ keeps its domain modules out, so paddle_tpu_torch.linalg is
# not ops.linalg (a later domain library)
from .ops import *  # noqa: F401,F403
from .ops import create_parameter, create_tensor  # noqa: F401
from . import tensor  # noqa: F401
from . import autograd, incubate, nn, optimizer, profiler  # noqa: F401
from .autograd import grad  # noqa: F401
from .core.state import enable_grad, no_grad, set_grad_enabled  # noqa
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.tensor import to_tensor  # noqa: F401
from .device import get_device, set_device  # noqa: F401
from .framework.random import get_rng_state, seed, set_rng_state  # noqa
from .framework.io import (async_save, clear_async_save_task_queue,  # noqa
                           load, save)
from . import io, metric  # noqa: F401
from . import hapi  # noqa: F401
from .hapi import Model, summary  # noqa: F401
from . import callbacks  # noqa: F401
from . import amp  # noqa: F401
# the namespace modules by name: ``from . import linalg`` would find the
# ``linalg`` the ops star-import could leave here (ops.linalg)
import importlib as _importlib

linalg = _importlib.import_module(".linalg", __name__)
fft = _importlib.import_module(".fft", __name__)
signal = _importlib.import_module(".signal", __name__)
from .signal import istft, stft  # noqa: E402,F401
from .ops.manipulation_ext import tensor_unfold as unfold  # noqa: E402,F401
