"""Device memory statistics (port of ``paddle_tpu/device/memory.py``).

The reference reads each local device's allocator through PJRT
``memory_stats()``. The port reads PyTorch's CUDA caching allocator:

- ``bytes_in_use``: ``torch.cuda.memory_allocated`` (bytes held by live
  tensors);
- ``peak_bytes_in_use``: ``torch.cuda.max_memory_allocated``;
- ``bytes_limit``: the card's total memory (``torch.cuda.mem_get_info``);
- ``bytes_free``: the bytes a new allocation could still take: the
  driver's free bytes (``mem_get_info``) plus what the allocator has
  reserved but not handed out (``memory_reserved - memory_allocated``).
  Memory held outside the allocator (the CUDA context, other libraries,
  other processes) is not in it, though ``bytes_limit - bytes_in_use``
  would count it as free.

The contract is the reference's: the readers never raise (a telemetry
read must not take down a serving loop) and never fabricate. Without a
card the host's CPU device reports nothing and yields ``{}``, as the
reference's CPU client does, and ``monitor/memory.py`` then emits no
gauge rather than a zero that would read as "0 bytes of device memory".
"""
from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["memory_stats", "all_memory_stats"]


def memory_stats(device: Optional[int] = None) -> dict:
    """One CUDA device's allocator reading as a plain dict (``device``:
    an index, default the current device); ``{}`` without a card or when
    the query raises."""
    try:
        if not torch.cuda.is_available():
            return {}
        idx = torch.cuda.current_device() if device is None else int(device)
        free, total = torch.cuda.mem_get_info(idx)
        in_use = int(torch.cuda.memory_allocated(idx))
        cached = int(torch.cuda.memory_reserved(idx)) - in_use
        return {"bytes_in_use": in_use,
                "peak_bytes_in_use": int(
                    torch.cuda.max_memory_allocated(idx)),
                "bytes_limit": int(total),
                "bytes_free": int(free) + max(cached, 0)}
    except Exception:
        return {}


def all_memory_stats() -> List[dict]:
    """One dict per local device, in device order: each CUDA device's
    :func:`memory_stats`, or ``[{}]`` on a host without a card (its CPU
    device, which reports nothing). ``[]`` when device discovery itself
    fails."""
    try:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception:
        return []
    if n == 0:
        return [{}]
    return [memory_stats(i) for i in range(n)]
