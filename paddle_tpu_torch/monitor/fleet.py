"""Fleet-aggregated telemetry: a cross-process snapshot gather and its
divergence report (port of ``paddle_tpu/monitor/fleet.py``).

:func:`aggregated_snapshot` gathers every rank's ``monitor.snapshot()``
(with the SLO tenant cost table) and reduces them into min / max / sum /
mean and per-host views, with a host-divergence report: the metrics
whose cross-host relative spread is largest, sorted, so one rank's
drifting value is the first line.

It is a COLLECTIVE: every rank of the default process group calls it at
the same point of its program (a training step boundary, a serving
maintenance tick). The gather is ``torch.distributed.all_gather_object``
over the default group; the reference rides its tagged key-value gather
with generation reclamation, which keeps a coordination store from
growing, and a collective leaves no keys behind to reclaim (ROADMAP C,
"Reference behaviour"). The freshest result is cached; the operator
server's ``/metrics?scope=fleet`` serves the cache, so a scrape never
waits for peers. A single process gathers nothing: the aggregate is of
its own snapshot, computed fresh per scrape.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

__all__ = ["aggregated_snapshot", "last_aggregate", "aggregate_hosts",
           "divergence", "expose_fleet_text", "world_size", "reset"]

_MU = threading.Lock()
_LAST: list = [None]

# Relative spread below this is float jitter, not divergence.
_DIVERGENCE_FLOOR = 1e-9


def world_size() -> int:
    """Processes in the default group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _scalar_metrics(snap: dict) -> dict:
    """{name: value} across the counters and gauges of one snapshot."""
    out = {}
    for kind in ("counters", "gauges"):
        out.update(snap.get(kind, {}))
    return out


def aggregate_hosts(host_snaps: List[dict]) -> dict:
    """Reduce per-host snapshots into
    ``{"scalars": {name: {min,max,sum,mean,hosts:[...]}},
    "histograms": {name: {count,sum,min,max}}}``. A metric missing on
    some hosts aggregates over the hosts that have it (its ``hosts``
    list carries None for the others — absence is visible, not
    zero-filled)."""
    scalars: dict = {}
    names = []
    per_host = [_scalar_metrics(s) for s in host_snaps]
    for h in per_host:
        for n in h:
            if n not in scalars:
                names.append(n)
                scalars[n] = None
    for name in names:
        vals = [h.get(name) for h in per_host]
        present = [v for v in vals if isinstance(v, (int, float))]
        if not present:
            continue
        scalars[name] = {
            "min": min(present),
            "max": max(present),
            "sum": sum(present),
            "mean": sum(present) / len(present),
            "hosts": vals,
        }
    scalars = {n: v for n, v in scalars.items() if v is not None}

    hists: dict = {}
    n_hosts = len(host_snaps)
    for rank, snap in enumerate(host_snaps):
        for name, h in snap.get("histograms", {}).items():
            if not isinstance(h, dict) or not h.get("count"):
                continue
            agg = hists.setdefault(name, {"count": 0, "sum": 0.0,
                                          "min": None, "max": None,
                                          "host_means": [None] * n_hosts})
            agg["count"] += h["count"]
            agg["sum"] += h.get("sum", 0.0)
            # per-host mean: the divergence report's histogram input —
            # one rank's slow collectives (comm.latency.*) surface as a
            # drifting mean even when counts match. Absent stays None.
            agg["host_means"][rank] = h.get("sum", 0.0) / h["count"]
            for key, pick in (("min", min), ("max", max)):
                v = h.get(key)
                if v is not None:
                    agg[key] = v if agg[key] is None else pick(agg[key], v)

    out = {"scalars": scalars, "histograms": hists}
    # SLO tenant aggregates (monitor/slo.py): per-host cost tables ride
    # the gathered payload under "slo_tenants"; the fleet view is the
    # field-wise SUM per tenant — summed serving cost per tenant across
    # replicas is the number a billing/scheduling consumer wants. Each
    # host's table is already cardinality-bounded, so the union is at
    # most hosts x (max_tenants + 1) entries.
    tenants: dict = {}
    for snap in host_snaps:
        for t, fields in (snap.get("slo_tenants") or {}).items():
            if not isinstance(fields, dict):
                continue
            agg_t = tenants.setdefault(t, {})
            for k, v in fields.items():
                if isinstance(v, (int, float)):
                    agg_t[k] = agg_t.get(k, 0) + v
    if tenants:
        out["slo_tenants"] = tenants
    return out


def divergence(agg: dict, top_n: int = 20) -> List[dict]:
    """The fleet's most-divergent scalar metrics: relative cross-host
    spread ``(max - min) / magnitude``, largest first — where the
    magnitude is the largest |value| observed, not the mean (a gauge
    legitimately straddling zero has mean ~0; dividing by it would
    blow up to ~1e9 and bury the real drifting-rank metric this report
    exists to surface — with |max| the ratio is bounded by 2). Counters
    that legitimately differ (per-host token counts) show up too — the
    operator reads the list with the metric semantics in mind; the
    point is that NOTHING cross-host-skewed stays invisible."""
    out = []
    for name, s in agg.get("scalars", {}).items():
        spread = s["max"] - s["min"]
        denom = max(abs(s["max"]), abs(s["min"]), abs(s["mean"]),
                    _DIVERGENCE_FLOOR)
        rel = spread / denom
        if rel > _DIVERGENCE_FLOOR:
            out.append({"metric": name, "min": s["min"], "max": s["max"],
                        "mean": s["mean"],
                        "relative_spread": round(rel, 6)})
    # Histogram per-host means ride the same report as `<name>:mean`
    # pseudo-metrics: a rank whose collective latency
    # (comm.latency.<kind>_ms) drifts has identical counts but a fat
    # mean — invisible to the scalar pass above. Hosts that never
    # observed the histogram stay None and simply don't participate.
    for name, h in agg.get("histograms", {}).items():
        means = [m for m in h.get("host_means", []) if m is not None]
        if len(means) < 2:
            continue
        mx, mn = max(means), min(means)
        denom = max(abs(mx), abs(mn), _DIVERGENCE_FLOOR)
        rel = (mx - mn) / denom
        if rel > _DIVERGENCE_FLOOR:
            out.append({"metric": f"{name}:mean", "min": mn, "max": mx,
                        "mean": sum(means) / len(means),
                        "relative_spread": round(rel, 6)})
    out.sort(key=lambda d: -d["relative_spread"])
    return out[:top_n]


def aggregated_snapshot(name: str = "monitor") -> dict:
    """COLLECTIVE: gather every rank's ``monitor.snapshot()`` over the
    default process group (``all_gather_object``) and reduce. Every rank
    returns the same payload; the freshest is cached for
    :func:`last_aggregate` and the fleet scrape. A single process gathers
    nothing."""
    from . import inc as _inc
    from . import slo as _slo
    from . import snapshot as _snapshot

    local = _snapshot()
    tenants = _slo.tenants_for_fleet()
    if tenants:
        # the per-tenant cost table rides the gathered payload (an extra
        # key the scalar and histogram reducers ignore)
        local = dict(local)
        local["slo_tenants"] = tenants
    nproc = world_size()
    if nproc > 1:
        from . import comms as _comms
        snaps = _comms.gather_object([None] * nproc, local)
    else:
        snaps = [local]
    agg = aggregate_hosts(snaps)
    payload = {
        "kind": "paddle_tpu.fleet_snapshot",
        "name": name,
        "world_size": nproc,
        "unix_time": round(time.time(), 3),
        "hosts": snaps,
        "aggregate": agg,
        "divergence": divergence(agg),
    }
    with _MU:
        _LAST[0] = payload
    _inc("monitor.fleet.snapshots",
         doc="cross-host aggregated snapshots gathered")
    return payload


def last_aggregate() -> Optional[dict]:
    """The freshest :func:`aggregated_snapshot` payload, or None when
    no collective has run yet this process."""
    with _MU:
        return _LAST[0]


def reset():
    with _MU:
        _LAST[0] = None


def expose_fleet_text(payload: dict) -> str:
    """Prometheus text rendering of an aggregate payload: one gauge
    family per scalar metric with ``agg="min|max|sum|mean"`` and
    ``host="<rank>"`` labeled samples (label values escaped), plus
    merged histogram count/sum. Aggregated series are exposed as
    gauges — a cross-host min of a counter is not itself monotonic."""
    from .exposition import escape_help, render_sample, sanitize_name

    agg = payload.get("aggregate", {})
    lines = [
        "# HELP paddle_fleet_world_size hosts contributing to this "
        "aggregate",
        "# TYPE paddle_fleet_world_size gauge",
        render_sample("paddle_fleet_world_size", None,
                      payload.get("world_size", 1)),
    ]
    for name, s in agg.get("scalars", {}).items():
        pname = sanitize_name(name)
        lines.append(f"# HELP {pname} "
                     f"{escape_help('fleet aggregate of ' + name)}")
        lines.append(f"# TYPE {pname} gauge")
        for key in ("min", "max", "sum", "mean"):
            lines.append(render_sample(name, {"agg": key}, s[key]))
        for rank, v in enumerate(s["hosts"]):
            if v is not None:
                lines.append(render_sample(name, {"host": str(rank)}, v))
    for name, h in agg.get("histograms", {}).items():
        pname = sanitize_name(name)
        lines.append(f"# HELP {pname} "
                     f"{escape_help('fleet-merged histogram of ' + name)}")
        lines.append(f"# TYPE {pname} gauge")
        for key in ("count", "sum", "min", "max"):
            if h.get(key) is not None:
                lines.append(render_sample(name, {"agg": key}, h[key]))
        # per-host means as labeled samples: the scrape-side view of
        # the divergence report's histogram input
        for rank, v in enumerate(h.get("host_means", [])):
            if v is not None:
                lines.append(render_sample(name, {"host": str(rank),
                                                  "agg": "mean"}, v))
    # fleet-summed per-tenant SLO cost aggregates: one family per cost
    # field, one {tenant="..."} sample per tenant (label escaping —
    # tenant names are client-supplied)
    tenants = agg.get("slo_tenants") or {}
    fields: dict = {}
    for t, tf in tenants.items():
        for k, v in tf.items():
            if isinstance(v, (int, float)):
                fields.setdefault(k, []).append((t, v))
    for field in sorted(fields):
        name = f"slo.tenant.{field}"
        pname = sanitize_name(name)
        lines.append(f"# HELP {pname} "
                     f"{escape_help('fleet-summed per-tenant ' + field)}")
        lines.append(f"# TYPE {pname} gauge")
        for t, v in sorted(fields[field]):
            lines.append(render_sample(name, {"tenant": t,
                                              "agg": "sum"}, v))
    return "\n".join(lines) + "\n"
