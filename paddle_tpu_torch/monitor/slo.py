"""The autoscale demand model (a copy of the pure functions of
``paddle_tpu/monitor/slo.py``: ``demand_model``, ``retry_after_hint``,
``_env_float`` and ``_DEFAULT_HORIZON_S``).

The serving engine's shedding calls these with the monitor off: a shed
submission, a displaced request and a drained one carry
``retry_after_s`` from ``retry_after_hint(engine.autoscale_payload())``.
The rest of the reference's module (per-request records, tenant
aggregates, objectives, burn rates and the scheduler-tick ring that
``retry_after_hint(None)`` reads) is the SLO plane, ROADMAP A7(c); here
``retry_after_hint`` requires a payload.
"""
from __future__ import annotations

import math
import os
from typing import Optional

__all__ = ["demand_model", "retry_after_hint"]

_DEFAULT_HORIZON_S = 30.0


def _env_float(name: str, default: float, lo: float = 0.0) -> float:
    try:
        v = float(os.environ.get(name, str(default)))
        return v if v > lo else default
    except ValueError:
        return default


def demand_model(queue_depth: int, live_slots: int, num_slots: int,
                 pages_free_fraction: float, trend: Optional[float] = None,
                 headroom: Optional[dict] = None) -> dict:
    """The autoscale demand model as a pure function of one replica's
    scheduler state.

    ``utilization`` = max(live-slot fraction, page-pool used fraction,
    device-memory unadmittable fraction when a ``headroom`` payload is
    given); ``demand_estimate`` = utilization + queue_depth / num_slots +
    max(queue trend, 0) x horizon / num_slots
    (``PADDLE_TPU_AUTOSCALE_HORIZON_S``, default 30);
    ``desired_capacity_hint`` is its ceiling. ``drain_safe`` = no queued
    and no live requests."""
    num_slots = max(int(num_slots), 1)
    queue_depth = int(queue_depth)
    live_slots = int(live_slots)
    slot_util = live_slots / num_slots
    page_util = max(1.0 - float(pages_free_fraction), 0.0)
    mem_util = None
    est_admittable = None
    if headroom:
        est_admittable = headroom.get("est_admittable_bytes")
        limit = (headroom.get("hbm") or {}).get("totals", {}) \
            .get("bytes_limit")
        if est_admittable is not None and limit:
            mem_util = min(max(1.0 - est_admittable / limit, 0.0), 1.0)
    utilization = max(v for v in (slot_util, page_util, mem_util)
                      if v is not None)
    backlog = queue_depth / num_slots
    horizon = _env_float("PADDLE_TPU_AUTOSCALE_HORIZON_S",
                         _DEFAULT_HORIZON_S)
    growth = max(trend or 0.0, 0.0) * horizon / num_slots
    demand = utilization + backlog + growth
    desired = max(int(math.ceil(demand - 1e-9)), 0)
    return {
        "queue_depth": queue_depth,
        "live_slots": live_slots,
        "num_slots": num_slots,
        "pages_free_fraction": round(float(pages_free_fraction), 4),
        "queue_depth_trend_per_s": round(trend, 4)
        if trend is not None else None,
        "utilization": round(utilization, 4),
        "memory_utilization": round(mem_util, 4)
        if mem_util is not None else None,
        "est_admittable_bytes": est_admittable,
        "backlog_slots": round(backlog, 4),
        "horizon_s": horizon,
        "demand_estimate": round(demand, 4),
        "desired_capacity_hint": desired,
        "drain_safe": queue_depth == 0 and live_slots == 0,
    }


def retry_after_hint(payload: dict) -> float:
    """Seconds a shed client should wait before retrying, from a
    :func:`demand_model` payload: the demand in excess of this one
    replica, spread over the autoscale horizon (an overloaded-by-2x
    replica hints one full horizon), clamped to [1, 2 x horizon] so a
    deep backlog never tells a client to go away for hours."""
    horizon = payload.get("horizon_s") or _DEFAULT_HORIZON_S
    excess = max(payload["demand_estimate"] - 1.0, 0.0)
    return round(min(max(excess * horizon, 1.0), 2.0 * horizon), 3)
