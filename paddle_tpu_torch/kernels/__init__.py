"""Hand-written Hopper kernels of the port and their dispatch (port of
``paddle_tpu/kernels/__init__.py``).

Each kernel module has a wrapper that launches the CUDA kernel for CUDA
tensors (or raises) and takes the kernel's plain PyTorch version for CPU
tensors; there is no fallback from the card to the plain version:

- ``flash_attention.flash_attention_fwd``: ``csrc/flash_fwd.cu``;
- ``paged_attention.ragged_paged_attention``: ``csrc/paged_decode.cu``.

The launch counters mirror the reference's ``_DISPATCH_STATS``.
"""
from __future__ import annotations

from . import flash_attention, paged_attention  # noqa: F401
from ._stats import DISPATCH_STATS as _DISPATCH_STATS

# the decode seam inference/paged.py calls (the reference's name)
dispatched_paged_attention = paged_attention.ragged_paged_attention

__all__ = ["flash_attention", "paged_attention",
           "dispatched_paged_attention", "dispatch_stats",
           "reset_dispatch_stats"]


def dispatch_stats() -> dict:
    return dict(_DISPATCH_STATS)


def reset_dispatch_stats() -> None:
    for k in _DISPATCH_STATS:
        _DISPATCH_STATS[k] = 0
