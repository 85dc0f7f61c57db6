"""Model-FLOPs utilization (port of ``paddle_tpu/monitor/mfu.py``).

MFU is the fraction of the card's peak FLOP/s that a model sustains.
Its two inputs:

- **FLOPs of one step or call.** The reference reads them from XLA's
  cost analysis of the compiled program (``lowered_flops``). Eager
  PyTorch compiles no program, so here ``lowered_flops`` /
  ``lowered_cost`` RUN the function once under
  ``torch.utils.flop_counter.FlopCounterMode`` and return the FLOPs its
  matmuls, convolutions and attention calls were counted at; the
  serving engine counts its programs from their shapes instead
  (``inference/engine.py`` ``serving_program_flops``). Neither reports
  bytes: ``lowered_cost``'s ``bytes_accessed`` is None, never made up.
- **Peak FLOP/s.** A table by card: the H100's dense bfloat16
  tensor-core peak, 989e12 (SXM). ``PADDLE_TPU_PEAK_FLOPS`` overrides it,
  the reference's escape hatch for hosts without a table entry; a CPU
  host without the override gets a 1e12 nominal denominator.

``record_program_flops`` feeds the reference's ``jit.program.flops``
counter and ``jit.program.last_flops`` gauge; ``mfu`` divides.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["PEAK_FLOPS_TABLE", "peak_flops", "resolve_peak",
           "lowered_flops", "lowered_cost", "record_program_flops", "mfu"]

# Dense bfloat16 tensor-core peak FLOP/s by card (SXM parts).
PEAK_FLOPS_TABLE = {
    "h100": 989e12,
}

# Nominal denominator for CPU runs with no override: keeps MFU finite
# and comparable across runs without claiming to measure the host.
_CPU_NOMINAL = 1e12


def _device_kind(device=None):
    """``(kind, platform)`` of ``device`` (default: the current CUDA
    device, else the CPU)."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return "cpu", "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu", "cpu"
    return torch.cuda.get_device_name(device), "gpu"


def resolve_peak(env_name: str, table: dict, nominal: float,
                 device=None, scale: float = 1.0) -> dict:
    """The one peak resolver shared by the FLOPs table here and the
    bandwidth tables of ``monitor/roofline.py`` (so the FLOP and byte
    denominators of one device always come from one card's row). Order:
    the ``env_name`` override (``scale`` applied) -> the table row whose
    key is in the device's name -> ``nominal`` (absolute units). Returns
    ``{"value", "source", "generation"}``; ``source`` is ``"env"``,
    ``"table"`` or ``"nominal"``."""
    env = os.environ.get(env_name)
    if env:
        try:
            v = float(env)
            if v > 0:
                return {"value": v * scale, "source": "env",
                        "generation": None}
        except ValueError:
            pass
    kind, _ = _device_kind(device)
    kind = kind.lower().replace(" ", "")
    for k, v in table.items():
        if k in kind:
            return {"value": v * scale, "source": "table",
                    "generation": k}
    return {"value": nominal, "source": "nominal", "generation": None}


def peak_flops(device=None) -> float:
    """Peak FLOP/s of ``device`` (default: the current card):
    ``PADDLE_TPU_PEAK_FLOPS`` -> the table -> 1e12 nominal."""
    return resolve_peak("PADDLE_TPU_PEAK_FLOPS", PEAK_FLOPS_TABLE,
                        _CPU_NOMINAL, device)["value"]


def _note_unavailable():
    from . import inc as _inc
    _inc("monitor.cost_analysis.unavailable",
         doc="cost_analysis() reads that raised or omitted the "
             "requested key (flops / bytes accessed)")


def lowered_cost(fn, *args, **kwargs) -> dict:
    """``{"flops": Optional[float], "bytes_accessed": None}`` of one call
    of ``fn(*args, **kwargs)``, which this RUNS once under
    ``FlopCounterMode`` (wrapped in ``monitor.suppress_accounting``).
    A call that raises gives ``None`` FLOPs and bumps
    ``monitor.cost_analysis.unavailable``, as does the byte count, which
    the counter does not give."""
    from torch.utils.flop_counter import FlopCounterMode

    from . import suppress_accounting as _suppress
    try:
        with _suppress(), FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
        flops = float(counter.get_total_flops())
    except Exception:
        flops = None
    _note_unavailable()
    return {"flops": flops, "bytes_accessed": None}


def lowered_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn(*args, **kwargs)`` as ``FlopCounterMode``
    counts them (the call runs once); None when it raises."""
    return lowered_cost(fn, *args, **kwargs)["flops"]


def record_program_flops(flops: Optional[float], source: str = "jit"):
    """Accumulate a program's FLOPs into the registry (``jit.program.flops``
    counter + ``jit.program.last_flops`` gauge). Callers gate on
    ``monitor.enabled()``; None records nothing."""
    if not flops or flops <= 0:
        return
    from . import inc as _inc
    from . import set_gauge as _set_gauge
    _inc("jit.program.flops", int(flops),
         doc="total XLA-cost-analysis FLOPs of compiled programs "
             "(one invocation each), accumulated per cache miss")
    _set_gauge("jit.program.last_flops", int(flops),
               doc="XLA-cost-analysis FLOPs of the most recently "
                   "compiled program")


def mfu(flops_per_step: float, steps_per_sec: float,
        device=None, peak: Optional[float] = None) -> float:
    """Model FLOPs utilization: achieved FLOP/s over peak FLOP/s."""
    p = peak if peak is not None else peak_flops(device)
    if p <= 0 or flops_per_step <= 0 or steps_per_sec <= 0:
        return 0.0
    return flops_per_step * steps_per_sec / p
