"""The seeded generator of the eager surface (port of ``seed``,
``paddle_tpu/framework/random.py:88``).

One ``torch.Generator`` for each device, all seeded by the last
``seed(s)``; the initializers and the random ops draw from the current
device's, and ``get_rng_state`` / ``set_rng_state`` save and restore its
state (ports of ``paddle_tpu/framework/random.py:94-100``). The numbers
differ from JAX's for the same seed: tests hand weights across instead.
"""
from __future__ import annotations

import torch

from ..device import to_torch_device

__all__ = ["seed", "default_generator", "get_rng_state", "set_rng_state"]

_SEED = None
_GENERATORS = {}


def default_generator(device=None) -> torch.Generator:
    """The generator of ``device`` (default: the current device), made
    and seeded on first use."""
    dev = to_torch_device(device)
    gen = _GENERATORS.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        if _SEED is not None:
            gen.manual_seed(_SEED)
        _GENERATORS[dev] = gen
    return gen


def seed(s: int) -> torch.Generator:
    """``paddle.seed``: reseed every device's generator with ``s``; returns
    the current device's."""
    global _SEED
    _SEED = int(s)
    _GENERATORS.clear()
    return default_generator()


def get_rng_state(device=None):
    """``paddle.get_rng_state``: a list holding the state of ``device``'s
    generator (default: the current device's)."""
    return [default_generator(device).get_state()]


def set_rng_state(state, device=None):
    """``paddle.set_rng_state``: restore a ``get_rng_state`` list."""
    default_generator(device).set_state(state[0])
