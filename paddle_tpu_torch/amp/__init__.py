"""``paddle.amp`` (port of ``paddle_tpu/amp/__init__.py``)."""
import torch

from . import amp_lists  # noqa: F401
from .auto_cast import (amp_decorate, amp_guard, auto_cast, black_list,  # noqa
                        current_cast_dtype_for, decorate,
                        is_auto_cast_enabled, white_list)
from .grad_scaler import AmpScaler, GradScaler, OptimizerState  # noqa


def is_float16_supported(device=None):
    """True on a CUDA device (``device``; else the current one, or any
    card when none is set), False on the CPU, as the reference is off an
    accelerator."""
    from .. import device as D
    if device is None and D._current_device is None:
        return torch.cuda.is_available()
    return D.to_torch_device(device).type == "cuda"


def is_bfloat16_supported(device=None):
    return True
