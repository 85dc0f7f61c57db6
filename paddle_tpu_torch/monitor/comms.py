"""Communication accounting (port of ``paddle_tpu/monitor/comms.py``).

The reference scans the HLO of each compiled program for the
collectives XLA's partitioner inserted. The port runs eager DTensor
code and compiles no program, so it counts the collectives where it
issues them, at its own seams:

- ``distributed/spmd.py``: every ``redistribute`` (``constrain``,
  ``shard``, ``replicate``, ``gather_axis``, ``bias_add``) and
  ``full``, one collective for each mesh dimension whose placement
  changes with communication: ``Shard -> Replicate`` an all-gather,
  ``Partial -> Replicate`` an all-reduce, ``Partial -> Shard`` a
  reduce-scatter, ``Shard(i) -> Shard(j)`` an all-to-all;
- the host object gathers (``all_gather_object``: the checkpoint's
  commit votes, the sentinel's agreement, the fleet scrape), which are
  also wall-timed into ``comm.latency.all_gather_ms``.

Bytes are per device and come from the shapes: the result's local bytes
of a redistribute, as the reference counts a collective's result shape
(ROADMAP C, "Reference behaviour"). Counting is monitor-gated: with
``FLAGS_enable_monitor`` off each seam pays one branch.
``observe_latency`` and ``comm_summary`` keep the reference's metric
names and payload keys.
"""
from __future__ import annotations

import pickle
import threading
import time
from typing import Dict, Optional

__all__ = ["COLLECTIVE_KINDS", "record_collective", "placement_kinds",
           "gather_object",
           "total_counts", "observe_latency", "comm_summary", "counts",
           "reset"]

# The reference's five kinds.
COLLECTIVE_KINDS = ("all_reduce", "all_gather", "reduce_scatter",
                    "collective_permute", "all_to_all")

_MU = threading.Lock()
_COUNTS: Dict[str, dict] = {}


def record_collective(kind: str, nbytes: int, count: int = 1):
    """Count ``count`` collectives of ``kind`` moving ``nbytes`` per device
    in all. Self-gated (monitor flag)."""
    from . import enabled as _enabled
    from . import inc as _inc
    if not _enabled():
        return
    with _MU:
        rec = _COUNTS.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += int(count)
        rec["bytes"] += int(nbytes)
    _inc("comm.collectives.total", int(count),
         doc="collectives issued at the port's seams (redistributes, "
             "object gathers)")
    _inc("comm.bytes.total", int(nbytes),
         doc="per-device bytes of the collectives issued at the port's "
             "seams")


def placement_kinds(src, dst) -> list:
    """The collective each mesh dimension needs to go from placements
    ``src`` to ``dst`` (one entry a changing dimension that communicates;
    slicing a replicated value needs none)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    kinds = []
    for a, b in zip(src, dst):
        if a == b:
            continue
        if isinstance(a, Partial):
            kinds.append("reduce_scatter" if isinstance(b, Shard)
                         else "all_reduce" if isinstance(b, Replicate)
                         else None)
        elif isinstance(a, Shard):
            kinds.append("all_gather" if isinstance(b, Replicate)
                         else "all_to_all" if isinstance(b, Shard)
                         else None)
    return [k for k in kinds if k]


def gather_object(out: list, obj, group=None):
    """``torch.distributed.all_gather_object(out, obj, group=group)``,
    counted as one all-gather of ``obj``'s pickled bytes and wall-timed
    into ``comm.latency.all_gather_ms`` when the monitor is on."""
    import torch.distributed as dist

    from . import enabled as _enabled
    if not _enabled():
        dist.all_gather_object(out, obj, group=group)
        return out
    t0 = time.perf_counter()
    dist.all_gather_object(out, obj, group=group)
    observe_latency("all_gather", (time.perf_counter() - t0) * 1e3)
    record_collective("all_gather", len(pickle.dumps(obj)))
    return out


def total_counts(comms: Optional[dict]) -> tuple:
    """``(total ops, total bytes)`` of a ``{kind: {"count", "bytes"}}``
    map (``(0, 0)`` for None / empty)."""
    if not comms:
        return 0, 0
    return (sum(v.get("count", 0) for v in comms.values()),
            sum(v.get("bytes", 0) for v in comms.values()))


def observe_latency(kind: str, ms: float):
    """Per-kind collective wall time into ``comm.latency.<kind>_ms``
    on the shared SLO bucket layout. Self-gated (monitor flag)."""
    from . import observe as _observe
    from .registry import LATENCY_BUCKETS_MS
    _observe(f"comm.latency.{kind}_ms", ms,
             doc="wall time of one eager/host collective of this kind",
             buckets=LATENCY_BUCKETS_MS)


def counts() -> Dict[str, dict]:
    """``{kind: {"count", "bytes"}}`` counted since the last reset."""
    with _MU:
        return {k: dict(v) for k, v in _COUNTS.items()}


def comm_summary() -> dict:
    """The ``/roofline`` payload's comm block, under the reference's
    keys: ``kinds`` (the seams' counts), ``programs_analyzed`` and
    ``programs_with_collectives`` (registry programs carrying
    collectives: none in the port, whose programs are not analyzed)."""
    from . import programs as _programs
    analyzed = with_comms = 0
    for rec in _programs.programs_snapshot():
        comms = rec.get("collectives")
        if comms is None:
            continue
        analyzed += 1
        with_comms += bool(comms)
    return {"kinds": counts(), "programs_analyzed": analyzed,
            "programs_with_collectives": with_comms}


def reset():
    with _MU:
        _COUNTS.clear()
