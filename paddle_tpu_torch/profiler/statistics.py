"""Profiler statistics: raw recorder events -> per-name aggregates and
the ``Profiler.summary()`` tables (copy of
``paddle_tpu/profiler/statistics.py``).

Reference capability: python/paddle/profiler/profiler_statistic.py
(HostStatisticNode / EventSummary / _build_table): the layer that turns
the span stream into the user-facing "calls / total / avg / max / min /
ratio" tables. Host spans only (the card's kernel times are in the
``torch.profiler`` device trace that ``Profiler(device_tracing=True)``
writes), one aggregation keyed by span name, optional per-thread
grouping for ``thread_sep=True``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Iterable, List, Optional

__all__ = ["SortedKeys", "EventStat", "aggregate", "build_table",
           "summary_string"]


class SortedKeys(Enum):
    """Summary-table sort keys (reference: profiler/profiler.py
    SortedKeys). CPU* sort the host-span columns; the GPU* aliases are
    accepted and sort the same columns (the card's kernel times live in
    the torch.profiler device trace, not in the host event stream)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


_SORT_ATTR = {
    SortedKeys.CPUTotal: "total_ns", SortedKeys.GPUTotal: "total_ns",
    SortedKeys.CPUAvg: "avg_ns", SortedKeys.GPUAvg: "avg_ns",
    SortedKeys.CPUMax: "max_ns", SortedKeys.GPUMax: "max_ns",
    SortedKeys.CPUMin: "min_ns", SortedKeys.GPUMin: "min_ns",
}

_UNIT_DIV = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}


@dataclass
class EventStat:
    """Aggregate of every span sharing one name (reference:
    EventSummary.GeneralItem)."""
    name: str
    calls: int = 0
    total_ns: int = 0
    max_ns: int = 0
    min_ns: int = field(default=2 ** 63 - 1)
    ratio: float = 0.0          # total / observed span, percent

    @property
    def avg_ns(self) -> float:
        return self.total_ns / self.calls if self.calls else 0.0

    def add(self, dur_ns: int):
        self.calls += 1
        self.total_ns += dur_ns
        if dur_ns > self.max_ns:
            self.max_ns = dur_ns
        if dur_ns < self.min_ns:
            self.min_ns = dur_ns


def aggregate(events: Iterable[dict],
              span_ns: Optional[int] = None) -> Dict[str, EventStat]:
    """Fold recorder events ({name, begin_ns, end_ns, tid}) into
    per-name stats. ``ratio`` is each name's total against the observed
    window (earliest begin -> latest end, or an explicit ``span_ns``);
    nested spans both bill their full duration, so ratios are
    per-name shares, not a partition of 100% (same property as the
    reference's operator view)."""
    stats: Dict[str, EventStat] = {}
    lo = None
    hi = None
    for e in events:
        b, en = e["begin_ns"], e["end_ns"]
        st = stats.get(e["name"])
        if st is None:
            st = stats[e["name"]] = EventStat(e["name"])
        st.add(en - b)
        if lo is None or b < lo:
            lo = b
        if hi is None or en > hi:
            hi = en
    span = span_ns if span_ns else ((hi - lo) if stats else 0)
    if span:
        for st in stats.values():
            st.ratio = 100.0 * st.total_ns / span
    return stats


def _sort(stats: List[EventStat], sorted_by) -> List[EventStat]:
    attr = _SORT_ATTR.get(sorted_by, "total_ns")
    return sorted(stats, key=lambda s: (-getattr(s, attr), s.name))


def build_table(stats: Dict[str, EventStat], sorted_by=None,
                time_unit: str = "ms", row_limit: int = 0) -> str:
    """Render one aggregation as the reference-shaped text table
    (Name / Calls / Total / Avg / Max / Min / Ratio columns)."""
    if time_unit not in _UNIT_DIV:
        raise ValueError(f"time_unit must be one of {list(_UNIT_DIV)}")
    div = _UNIT_DIV[time_unit]
    rows = _sort(list(stats.values()), sorted_by)
    if row_limit:
        rows = rows[:row_limit]
    u = time_unit
    header = (f"{'Name':<40} {'Calls':>8} {'Total(' + u + ')':>14} "
              f"{'Avg(' + u + ')':>12} {'Max(' + u + ')':>12} "
              f"{'Min(' + u + ')':>12} {'Ratio(%)':>9}")
    sep = "-" * len(header)
    lines = [sep, header, sep]
    for s in rows:
        mn = 0 if s.calls == 0 else s.min_ns
        lines.append(
            f"{s.name[:40]:<40} {s.calls:>8} {s.total_ns / div:>14.3f} "
            f"{s.avg_ns / div:>12.3f} {s.max_ns / div:>12.3f} "
            f"{mn / div:>12.3f} {s.ratio:>9.2f}")
    lines.append(sep)
    return "\n".join(lines)


def summary_string(events: List[dict], sorted_by=None,
                   time_unit: str = "ms", thread_sep: bool = False,
                   span_ns: Optional[int] = None) -> str:
    """The full ``Profiler.summary()`` body: aggregate + render, with
    one table per thread when ``thread_sep``."""
    if not thread_sep:
        return build_table(aggregate(events, span_ns), sorted_by,
                           time_unit)
    by_tid: Dict[int, List[dict]] = {}
    for e in events:
        by_tid.setdefault(e.get("tid", 0), []).append(e)
    parts = []
    for tid in sorted(by_tid):
        parts.append(f"Thread {tid}")
        parts.append(build_table(aggregate(by_tid[tid], span_ns),
                                 sorted_by, time_unit))
    return "\n".join(parts)


def op_breakdown(events: List[dict]) -> dict:
    """Machine-readable per-name stats (calls / total / avg / max / min
    ns + ratio) — the dict the bench and tests consume instead of
    parsing the text table."""
    return {
        name: {"calls": s.calls, "total_ns": s.total_ns,
               "avg_ns": s.avg_ns, "max_ns": s.max_ns,
               "min_ns": 0 if s.calls == 0 else s.min_ns,
               "ratio_pct": round(s.ratio, 4)}
        for name, s in sorted(aggregate(events).items())
    }


__all__.append("op_breakdown")
