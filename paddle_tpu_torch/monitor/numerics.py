"""Numerics plane, its KV half (port of the part of
``paddle_tpu/monitor/numerics.py`` that the serving engine feeds):
per-layer per-page absmax of the engine's KV pool and, for int8 pools,
the quantizer's write-time health.

- **KV-page absmax** (:func:`record_kv_absmax`): sampled 1-in-N decode
  chunks (``PADDLE_TPU_KV_SAMPLE``, default 16; 0 disables) at the
  engine's per-chunk download seam: plain PyTorch reductions over the
  pool run after the chunk's tokens reached the host, so the card has
  finished the chunk and the sample adds no synchronization of work in
  flight. The distribution is the scale-choosing evidence for per-page
  KV quantization.
- **KV-quant health** (:func:`record_kv_quant`): for int8 pools, the
  referenced pages' scale values and the fraction of codes at the +-127
  rail.

The step-stats half (``record_step_stats``, ``worst_layer``,
``top_movers``) has one caller, the training sentinel, and waits for it
(ROADMAP A10), with ``audit_quantized_tree`` / ``sqnr_db`` /
``dequant_ref``. Gating: every record path is one cached
``FLAGS_enable_monitor`` branch when the monitor is off.
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from ..core import flags as _flags

__all__ = ["kv_sample_rate", "set_kv_sample_rate", "record_kv_absmax",
           "record_kv_quant", "kv_quant_snapshot", "kv_snapshot",
           "numerics_snapshot", "reset"]

_FLAG = _flags.flag_info("enable_monitor")

# KV-page absmax distribution (engine-fed, 1-in-N chunks)
_KV_RATE: list = [None]          # None = re-read env on next use
_KV_MU = threading.Lock()
_KV = {"samples": 0, "pages": 0, "min": None, "max": None,
       "sum": 0.0, "recent": deque(maxlen=64)}
# KV-quant write-time health (engine-fed when FLAGS_serving_kv_quant):
# latest sampled scale-plane p99 + saturated-code fraction
_KVQ = {"samples": 0, "scale_p99": None, "clip_fraction": None}


def kv_sample_rate() -> int:
    """1-in-N decode-chunk sampling rate for KV-page absmax
    (``PADDLE_TPU_KV_SAMPLE``, default 16; 0 disables)."""
    r = _KV_RATE[0]
    if r is None:
        try:
            r = int(os.environ.get("PADDLE_TPU_KV_SAMPLE", "16"))
        except ValueError:
            r = 16
        r = max(r, 0)
        _KV_RATE[0] = r
    return r


def set_kv_sample_rate(n: Optional[int]):
    """Override the KV sampling rate in process (0 disables); ``None``
    re-reads the env var on next use."""
    _KV_RATE[0] = max(int(n), 0) if n is not None else None


def record_kv_absmax(absmax_k, absmax_v=None):
    """Digest one sampled chunk's per-layer per-page KV absmax arrays
    (any shape; the engine passes [L, P]). Maintains a running
    min/mean/max over every observed page value plus a bounded ring of
    per-sample quantile summaries — the distribution per-page KV-quant
    scale selection reads. Monitor-gated."""
    if not _FLAG.value:
        return
    from . import inc as _inc
    from . import set_gauge as _set_gauge

    parts = [np.asarray(absmax_k, np.float32).ravel()]
    if absmax_v is not None:
        parts.append(np.asarray(absmax_v, np.float32).ravel())
    vals = np.concatenate(parts)
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return
    with _KV_MU:
        _KV["samples"] += 1
        _KV["pages"] += int(vals.size)
        _KV["sum"] += float(vals.sum())
        vmin, vmax = float(vals.min()), float(vals.max())
        _KV["min"] = vmin if _KV["min"] is None else min(_KV["min"], vmin)
        _KV["max"] = vmax if _KV["max"] is None else max(_KV["max"], vmax)
        _KV["recent"].append({
            "unix_time": round(time.time(), 3),
            "pages": int(vals.size),
            "min": round(vmin, 9),
            "p50": round(float(np.percentile(vals, 50)), 9),
            "p95": round(float(np.percentile(vals, 95)), 9),
            "max": round(vmax, 9),
            "mean": round(float(vals.mean()), 9),
        })
        gmax = _KV["max"]
    _inc("numerics.kv.samples",
         doc="decode chunks whose KV-page absmax was sampled (1-in-N "
             "at the per-chunk download seam)")
    _inc("numerics.kv.pages", int(vals.size),
         doc="per-layer page absmax values observed by KV sampling")
    _set_gauge("numerics.kv.absmax.max", round(gmax, 9),
               doc="largest KV-page absmax observed — the per-page "
                   "KV-quantization scale ceiling")


def record_kv_quant(scales, clip_fraction: float):
    """Digest one sampled chunk's KV-quant write-time health
    (FLAGS_serving_kv_quant engines, same 1-in-N seam as
    :func:`record_kv_absmax`): the referenced pages' scale-plane
    values and the fraction of int8 codes sitting at the +-127 clamp
    — saturation means a page's write-time scale went stale against
    later appends. Monitor-gated."""
    if not _FLAG.value:
        return
    from . import set_gauge as _set_gauge

    vals = np.asarray(scales, np.float32).ravel()
    vals = vals[np.isfinite(vals) & (vals > 0)]
    clip = float(clip_fraction)
    with _KV_MU:
        _KVQ["samples"] += 1
        if vals.size:
            _KVQ["scale_p99"] = round(
                float(np.percentile(vals, 99)), 9)
        _KVQ["clip_fraction"] = round(clip, 9)
        p99 = _KVQ["scale_p99"]
    if p99 is not None:
        _set_gauge("numerics.kv_quant.scale_p99", p99,
                   doc="p99 of the referenced KV pages' write-time "
                       "quantization scales (per-page per-kv-head "
                       "absmax/127) at the latest sample")
    _set_gauge("numerics.kv_quant.clip_fraction", round(clip, 9),
               doc="fraction of referenced int8 KV codes at the "
                   "+-127 clamp at the latest sample — saturation "
                   "from scales gone stale against later appends")


def kv_quant_snapshot() -> dict:
    with _KV_MU:
        return dict(_KVQ)


def kv_snapshot() -> dict:
    with _KV_MU:
        return {
            "sample_rate": kv_sample_rate(),
            "samples": _KV["samples"],
            "pages": _KV["pages"],
            "min": _KV["min"],
            "max": _KV["max"],
            "mean": (_KV["sum"] / _KV["pages"]) if _KV["pages"] else None,
            "recent": list(_KV["recent"]),
        }


# -- reporting ---------------------------------------------------------------

def _j(v):
    """JSON-safe float: non-finite -> None (a strict parser must never
    choke on a NaN token; the 'finite' flags carry the distinction)."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _j(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_j(x) for x in v]
    return v


def numerics_snapshot(n: Optional[int] = None) -> dict:
    """The KV part of the reference's ``/numerics`` payload (and of the
    flight record's ``numerics`` block): the KV-page absmax distribution
    and the KV-quant health. ``n`` is the reference's step-row count and
    selects nothing here (the step rows wait for the sentinel)."""
    del n
    return _j({"kv": kv_snapshot(), "kv_quant": kv_quant_snapshot()})


def reset():
    with _KV_MU:
        _KV.update(samples=0, pages=0, sum=0.0, min=None, max=None)
        _KV["recent"].clear()
        _KVQ.update(samples=0, scale_p99=None, clip_fraction=None)
