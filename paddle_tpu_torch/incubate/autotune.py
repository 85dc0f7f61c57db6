"""``paddle.incubate.autotune`` (port of ``paddle_tpu/incubate/autotune.py``,
reference: python/paddle/incubate/autotune.py set_config) over the tuner
in ``paddle_tpu_torch.kernels.autotune``.

The reference's config has three sections: ``kernel`` (picking among
kernel candidates: here the KV page size and the cross-entropy vocab
chunk, measured on the card), ``layout`` and ``dataloader``. ``kernel``'s
``enable`` is ``FLAGS_use_autotune``; ``layout`` has no tuner in the port
(PyTorch keeps the layouts the model code asks for), so enabling it is
recorded and warned about; ``dataloader`` is accepted and stored.
"""
from __future__ import annotations

import json
import warnings

from ..core import flags as _flags

__all__ = ["set_config", "get_config"]

_CONFIG = {"kernel": {"enable": True},
           "layout": {"enable": False},
           "dataloader": {"enable": False}}


def set_config(config=None):
    """Enable or disable autotune domains. ``config`` is a dict (or a path
    to a JSON file) like ``{"kernel": {"enable": True, "tuning_range":
    [1, 10]}, ...}``, the reference's schema; None enables the kernel
    tuner."""
    if config is None:
        _flags.set_flags({"use_autotune": True})
        _CONFIG["kernel"]["enable"] = True
        return
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    for section in ("kernel", "layout", "dataloader"):
        if section in config:
            _CONFIG[section].update(config[section])
    _flags.set_flags({"use_autotune": bool(
        _CONFIG["kernel"].get("enable", True))})
    if _CONFIG["layout"].get("enable"):
        warnings.warn(
            "autotune.layout has no tuner in the PyTorch port (tensors keep "
            "the memory layout the model code gives them); the flag is "
            "recorded only", stacklevel=2)


def get_config() -> dict:
    return {k: dict(v) for k, v in _CONFIG.items()}
