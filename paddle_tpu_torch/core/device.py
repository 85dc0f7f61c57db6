"""Device selection for the port's entry points: the card by default,
the CPU only when the caller asks for it."""
from __future__ import annotations

import torch

from . import enforce as E


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device, and raises when there is
    none: an entry point never drops to the CPU quietly. ``"cpu"`` (or
    any explicit device) is taken as given."""
    if device is None:
        E.enforce(torch.cuda.is_available(),
                  "no CUDA device is available",
                  error=E.UnavailableError,
                  hint="pass device='cpu' to run the plain PyTorch "
                       "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
