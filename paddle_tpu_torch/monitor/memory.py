"""Device-memory gauges and the serving headroom estimate (port of
``paddle_tpu/monitor/memory.py``).

Elastic autoscaling and admission both ask how much device memory is
left and how many more sequences this process could admit. Two
inputs, both measured elsewhere, are composed here:

- **Device bytes** from ``device/memory.py`` (each CUDA device's caching
  allocator: ``bytes_in_use``, ``peak_bytes_in_use``, the card's
  total memory as ``bytes_limit``, and ``bytes_free``, what a new
  allocation could still take; a host without a card reports
  nothing). :func:`update_hbm_gauges` sums them over the local devices
  that report into the reference's ``device.hbm.*`` gauges. Devices
  that report nothing emit **no** gauges: a zero would read as "0 bytes
  of device memory", which is fabrication, not telemetry.
- **Page-pool utilization** (the ``serving.pages.total|in_use`` gauges
  the engine maintains) and the **largest per-program temp footprint**
  (``monitor/programs.py`` ``max_temp_bytes``). The reference reads the
  latter from XLA's memory analysis of its compiled programs; the port
  runs eager PyTorch and has no such analysis, so it is 0, the
  reference's value before any analysis ran.

Everything is pull-shaped: the ``/metrics``, ``/memory`` and ``/slo``
routes (``monitor/server.py``) call :func:`update_hbm_gauges` /
:func:`headroom` per scrape, so the gauges are fresh at scrape time and
cost nothing between scrapes. Gauges are monitor-gated (``set_gauge``
self-gates); the plain dict readers work regardless.
"""
from __future__ import annotations

from typing import Callable, List, Optional

__all__ = ["hbm_stats", "update_hbm_gauges", "headroom"]

# The allocator keys worth exporting (the reference's PJRT names), each
# summed across the local devices that report it.
_HBM_KEYS = ("bytes_in_use", "bytes_limit", "peak_bytes_in_use",
             "bytes_free")


def hbm_stats(stats_fn: Optional[Callable[[], List[dict]]] = None
              ) -> dict:
    """Per-device memory stats + cross-device sums.

    Returns ``{"devices": [per-device dicts], "totals": {key: sum},
    "devices_reporting": n}`` — ``totals`` only contains keys at least
    one device reported, and is ``{}`` on backends that report nothing
    (CPU). ``stats_fn`` injects a fake reading for tests."""
    if stats_fn is None:
        from ..device.memory import all_memory_stats as stats_fn
    per_dev = stats_fn()
    totals: dict = {}
    reporting = 0
    for st in per_dev:
        if not st:
            continue
        reporting += 1
        for key in _HBM_KEYS:
            if key in st:
                try:
                    totals[key] = totals.get(key, 0) + int(st[key])
                except (TypeError, ValueError):
                    pass
    return {"devices": per_dev, "totals": totals,
            "devices_reporting": reporting}


def update_hbm_gauges(stats_fn=None) -> dict:
    """Refresh the ``device.hbm.*`` gauges from a fresh backend read
    and return the :func:`hbm_stats` payload. Gauges are only written
    for keys the backend actually reported — never fabricated — and
    only while the monitor flag is on (``set_gauge`` self-gates)."""
    from . import set_gauge as _set_gauge

    stats = hbm_stats(stats_fn)
    totals = stats["totals"]
    if not totals:
        return stats
    docs = {
        "bytes_in_use": "device bytes allocated (summed across local "
                        "devices that report)",
        "bytes_limit": "device memory capacity (summed across local "
                       "devices that report)",
        "peak_bytes_in_use": "high-water mark of device bytes "
                             "allocated (summed across local devices)",
        "bytes_free": "device bytes a new allocation could take: the "
                      "driver's free plus the allocator's reserved but "
                      "unallocated (summed across local devices)",
    }
    for key, v in totals.items():
        _set_gauge(f"device.hbm.{key}", v, doc=docs.get(key, ""))
    _set_gauge("device.hbm.devices_reporting",
               stats["devices_reporting"],
               doc="local devices whose backend reports memory stats")
    free = totals.get("bytes_limit", 0) - totals.get("bytes_in_use", 0)
    if "bytes_limit" in totals and "bytes_in_use" in totals:
        _set_gauge("device.hbm.headroom_bytes", max(free, 0),
                   doc="bytes_limit - bytes_in_use across reporting "
                       "devices (before per-program temp reservation)")
    return stats


def _gauge_value(name: str):
    from . import _REGISTRY
    m = _REGISTRY.get(name)
    return m.value if m is not None else None


def headroom(stats_fn=None) -> dict:
    """The admission-policy composition: page-pool slack x HBM slack x
    per-program temp reservation.

    Returns a dict with whatever components are measurable right now
    (absent backends/pools contribute ``None``, never fake zeros):

    - ``pages_total`` / ``pages_in_use`` / ``pages_free_fraction`` —
      from the serving gauges (None before any engine exists);
    - ``hbm_free_bytes`` — limit minus in-use, when the backend
      reports;
    - ``program_temp_bytes_max`` — the largest analyzed program's temp
      claim (0 in the port, which has no XLA memory analysis);
    - ``est_admittable_bytes`` — HBM free minus the temp reservation,
      the bytes genuinely available for new KV pages. Where the devices
      report ``bytes_free`` (the card does), HBM free is capped by it,
      so memory held outside the allocator (the CUDA context, other
      processes) is not counted as admittable.

    Also refreshes the ``serving.headroom.pages_free_fraction`` gauge
    when a pool exists (monitor-gated)."""
    from . import set_gauge as _set_gauge
    from . import programs as _programs

    stats = update_hbm_gauges(stats_fn)
    totals = stats["totals"]
    # the full per-device payload rides along so a consumer showing
    # both (the /memory endpoint) reads the backend exactly once and
    # the two views can never disagree
    out: dict = {"devices_reporting": stats["devices_reporting"],
                 "hbm": stats}

    total = _gauge_value("serving.pages.total")
    in_use = _gauge_value("serving.pages.in_use")
    out["pages_total"] = total
    out["pages_in_use"] = in_use
    if total:
        frac = max(total - (in_use or 0), 0) / total
        out["pages_free_fraction"] = round(frac, 4)
        _set_gauge("serving.headroom.pages_free_fraction",
                   round(frac, 4),
                   doc="free fraction of the serving KV page pool")
    else:
        out["pages_free_fraction"] = None

    temp_max = _programs.max_temp_bytes()
    out["program_temp_bytes_max"] = temp_max

    if "bytes_limit" in totals and "bytes_in_use" in totals:
        free = max(totals["bytes_limit"] - totals["bytes_in_use"], 0)
        out["hbm_free_bytes"] = free
        if "bytes_free" in totals:
            free = min(free, max(totals["bytes_free"], 0))
        out["est_admittable_bytes"] = max(free - temp_max, 0)
    else:
        out["hbm_free_bytes"] = None
        out["est_admittable_bytes"] = None
    return out
