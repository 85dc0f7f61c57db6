"""Bounded step-indexed timeseries ring + step-time drift detection (port
of ``paddle_tpu/monitor/timeseries.py``, which holds no JAX: the port
is the reference's code).

Histograms answer "what is the p99" but not "when did it change": a
long run whose step time silently degrades 30% over six hours looks
identical in a cumulative histogram to one that was always 30% slower.
This module is the time axis — a process-global bounded ring of
per-step rows:

``{"step", "unix_time", "total_ms", "data_wait_ms", "compute_ms",
"checkpoint_ms", "loss", "grad_norm_ema", "goodput_tokens_per_sec",
"exec_ms"}``

fed from the two step-closing seams (``StepTimer.end_step`` and the
``SentinelLoop`` guarded loop), served at ``/timeseries``
(``monitor/server.py``) and included in the flight-record dump — so a
crash's black box shows the step-time *trajectory*, not just the final
distribution.

**Drift detection**: the trailing window answers "is the run slower
than it used to be". ``drift_status()`` compares the median ``total_ms``
of the most recent ``PADDLE_TPU_DRIFT_RECENT`` (default 8) rows against
the median of the up-to-``PADDLE_TPU_DRIFT_BASELINE`` (default 32) rows
before them; the ratio lands on the ``train.step.drift_ratio`` gauge
and trips ``drifting`` past ``PADDLE_TPU_DRIFT_THRESHOLD`` (default
1.25). The detector registers itself as a **warn-level** ``/healthz``
provider on first use: its report is visible to probes but its ``ok``
stays True — a slow step is a page, not a liveness failure, and it must
never get a making-progress worker restarted. The anomaly sentinel
reads the same signal (observe-only — drift never changes a verdict).

Gating: ``record_step`` is one cached-flag branch when
``FLAGS_enable_monitor`` is off; nothing registers, the ring stays
empty.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import List, Optional

from ..core import flags as _flags

__all__ = ["record_step", "rows", "capacity", "total_rows",
           "drift_status", "drift_ratio", "timeseries_snapshot",
           "set_capacity", "reset"]

_FLAG = _flags.flag_info("enable_monitor")

_DEFAULT_CAPACITY = 512

_MU = threading.Lock()
_RING: deque = deque(maxlen=_DEFAULT_CAPACITY)
_TOTAL = [0]                    # lifetime rows (bounding evidence)
_LAST_STEP = [0]                # auto step index when callers pass None
_PROVIDER_REGISTERED = [False]


def _env_int(name: str, default: int, lo: int) -> int:
    try:
        return max(int(os.environ.get(name, str(default))), lo)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, str(default)))
        return v if v > 1.0 else default
    except ValueError:
        return default


def set_capacity(n: Optional[int]):
    """Resize the ring (tests; ``None`` restores the env/default).
    Existing rows are kept up to the new bound."""
    global _RING
    if n is None:
        n = _env_int("PADDLE_TPU_TIMESERIES_STEPS", _DEFAULT_CAPACITY, 16)
    with _MU:
        _RING = deque(_RING, maxlen=max(int(n), 16))


# resolve the env-configured capacity once at import (same pattern as
# the trace ring)
set_capacity(None)


def capacity() -> int:
    return _RING.maxlen


def total_rows() -> int:
    return _TOTAL[0]


def _maybe_register_provider():
    """Register the warn-level /healthz contributor once, and only
    while some plane could read it (the engine/sentinel gating rule: a
    fully-off process must not grow the provider map)."""
    if _PROVIDER_REGISTERED[0]:
        return
    from . import server as _server
    if not (_FLAG.value or _server.plane_active()):
        return
    _PROVIDER_REGISTERED[0] = True
    _server.register_health_provider("steptime_drift", _drift_provider)


def _drift_provider() -> dict:
    """Warn-level: the drift report rides /healthz but ``ok`` stays
    True — a slow-but-progressing worker must not be restarted by a
    liveness probe."""
    st = drift_status()
    return {"ok": True, "level": "warn", **st}


def record_step(step: Optional[int] = None, *, total_ms=None,
                data_wait_ms=None, compute_ms=None, checkpoint_ms=None,
                loss=None, grad_norm_ema=None,
                goodput_tokens_per_sec=None, exec_ms=None):
    """Append one step row (monitor-gated; one cached-flag branch when
    off). ``step=None`` auto-increments from the last recorded step.
    ``grad_norm_ema=None`` is filled from the sentinel's
    ``train.anomaly.grad_norm_ema`` gauge when one exists, so StepTimer
    rows pick up the sentinel's view without the loops knowing about
    each other. Refreshes ``train.step.drift_ratio`` when the trailing
    windows can answer."""
    if not _FLAG.value:
        return
    from . import _REGISTRY
    from . import set_gauge as _set_gauge

    if grad_norm_ema is None:
        g = _REGISTRY.get("train.anomaly.grad_norm_ema")
        if g is not None:
            grad_norm_ema = g.value
    row = {
        "step": int(step) if step is not None else _LAST_STEP[0] + 1,
        "unix_time": round(time.time(), 3),
        "total_ms": _num(total_ms),
        "data_wait_ms": _num(data_wait_ms),
        "compute_ms": _num(compute_ms),
        "checkpoint_ms": _num(checkpoint_ms),
        "loss": _num(loss),
        "grad_norm_ema": _num(grad_norm_ema),
        "goodput_tokens_per_sec": _num(goodput_tokens_per_sec),
        "exec_ms": _num(exec_ms),
    }
    with _MU:
        _RING.append(row)
        _TOTAL[0] += 1
        _LAST_STEP[0] = row["step"]
        ratio = _drift_ratio_locked()
    if ratio is not None:
        _set_gauge("train.step.drift_ratio", round(ratio, 4),
                   doc="recent-median / trailing-baseline-median step "
                       "time — >1 means the run is slowing down")
    _maybe_register_provider()


def _num(v) -> Optional[float]:
    if v is None:
        return None
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return round(f, 6)


def rows(n: Optional[int] = None) -> List[dict]:
    """The buffered rows, oldest first (last ``n`` when given)."""
    with _MU:
        out = list(_RING)
    return out[-n:] if n else out


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    m = len(s) // 2
    return s[m] if len(s) % 2 else (s[m - 1] + s[m]) / 2.0


def _drift_windows():
    recent_n = _env_int("PADDLE_TPU_DRIFT_RECENT", 8, 2)
    baseline_n = _env_int("PADDLE_TPU_DRIFT_BASELINE", 32, 2)
    return recent_n, baseline_n


def _drift_ratio_locked() -> Optional[float]:
    recent_n, baseline_n = _drift_windows()
    totals = [r["total_ms"] for r in _RING if r["total_ms"] is not None]
    # need a full recent window plus at least as many baseline rows —
    # a detector with a thin baseline alarms on warmup noise
    if len(totals) < 2 * recent_n:
        return None
    recent = totals[-recent_n:]
    baseline = totals[-(recent_n + baseline_n):-recent_n]
    base_med = _median(baseline)
    if base_med <= 0:
        return None
    return _median(recent) / base_med


def drift_ratio() -> Optional[float]:
    with _MU:
        return _drift_ratio_locked()


def drift_status() -> dict:
    """The full drift report: ratio, windows, medians, threshold, and
    the boolean verdict. ``ratio`` is None (and ``drifting`` False)
    until both trailing windows have data — never fabricated."""
    recent_n, baseline_n = _drift_windows()
    threshold = _env_float("PADDLE_TPU_DRIFT_THRESHOLD", 1.25)
    with _MU:
        totals = [r["total_ms"] for r in _RING
                  if r["total_ms"] is not None]
    ratio = None
    recent_med = base_med = None
    if len(totals) >= 2 * recent_n:
        recent = totals[-recent_n:]
        baseline = totals[-(recent_n + baseline_n):-recent_n]
        base_med = _median(baseline)
        recent_med = _median(recent)
        if base_med > 0:
            ratio = recent_med / base_med
    return {
        "ratio": round(ratio, 4) if ratio is not None else None,
        "drifting": bool(ratio is not None and ratio >= threshold),
        "threshold": threshold,
        "recent_window": recent_n,
        "baseline_window": baseline_n,
        "recent_median_ms": round(recent_med, 4)
        if recent_med is not None else None,
        "baseline_median_ms": round(base_med, 4)
        if base_med is not None else None,
        "rows": len(totals),
    }


def timeseries_snapshot(n: Optional[int] = None) -> dict:
    """The ``/timeseries`` payload (and the flight record's
    ``timeseries`` block): rows oldest-first + drift report +
    bounding evidence."""
    return {
        "capacity": capacity(),
        "total_rows": total_rows(),
        "drift": drift_status(),
        "rows": rows(n),
    }


def reset():
    with _MU:
        _RING.clear()
        _TOTAL[0] = 0
        _LAST_STEP[0] = 0
