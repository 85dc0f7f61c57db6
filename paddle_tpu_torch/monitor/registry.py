"""Typed process-global stat registry (a copy of
``paddle_tpu/monitor/registry.py``).

Reference capability: paddle/fluid/platform/monitor.h (StatRegistry /
StatValue: named int64 stats registered globally, exported in bulk) +
paddle/phi/core/memory/stats.h (HostMemoryStat* peak/current byte
accounting). The reference's design: one registry holding three metric
types — Counter (monotonic), Gauge (set/add, with a helper for
live/peak pairs), Histogram (exponential buckets, Prometheus-shaped) —
because the consumers here are not nvml pollers but (a) the bench
harness embedding a snapshot into BENCH_*.json and (b) a Prometheus
scrape of ``monitor.expose_text()``.

Thread-safety: every mutation takes the metric's own lock (op dispatch
and dataloader workers update from many threads); registry creation
takes the registry lock. Reads (``snapshot``) lock per metric, so a
snapshot taken mid-train is internally consistent per metric without
stopping the world.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "StatRegistry",
           "LATENCY_BUCKETS_MS"]

# SLO-shaped ms buckets shared by the serving-latency and train-step
# phase histograms: 0.1ms floor (CPU-smoke chunks), 2min ceiling,
# dense through the 1ms-10s band where TTFT/TPOT and step-phase
# targets live. One definition so the two metric families keep the
# same quantile resolution.
LATENCY_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1e3, 2.5e3, 5e3, 1e4, 3e4,
                      6e4, 1.2e5)


class Counter:
    """Monotonically increasing int/float stat (monitor.h StatValue
    with increase-only discipline)."""

    kind = "counter"
    __slots__ = ("name", "doc", "_mu", "_value")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self._mu = threading.Lock()
        self._value = 0

    def incr(self, n=1):
        with self._mu:
            self._value += n

    inc = incr          # prometheus-client spelling
    add = incr          # monitor.h spelling

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._mu:
            self._value = 0

    def snapshot(self):
        return self._value


class Gauge:
    """Set/add stat that can go down (live bytes, queue depth)."""

    kind = "gauge"
    __slots__ = ("name", "doc", "_mu", "_value")

    def __init__(self, name: str, doc: str = ""):
        self.name = name
        self.doc = doc
        self._mu = threading.Lock()
        self._value = 0

    def set(self, v):
        with self._mu:
            self._value = v

    def add(self, d):
        with self._mu:
            self._value += d

    def sub(self, d):
        self.add(-d)

    def add_and_max_into(self, d, peak: "Gauge"):
        """Atomically ``self += d`` and fold the new value into ``peak``
        (the stats.h Update pattern: current and peak move under one
        lock so a racing decrement can't hide a true high-water mark)."""
        with self._mu:
            self._value += d
            v = self._value
        with peak._mu:
            if v > peak._value:
                peak._value = v

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._mu:
            self._value = 0

    def snapshot(self):
        return self._value


# Default buckets: exponential in powers of 4 from 1us up — wide enough
# to cover one span range from a ~100ns python op dispatch to a
# multi-minute XLA compile without per-site tuning.
_DEFAULT_BUCKETS = tuple(4.0 ** i for i in range(-1, 16))


class Histogram:
    """Bucketed distribution (count/sum/min/max + cumulative buckets,
    the Prometheus histogram shape)."""

    kind = "histogram"
    __slots__ = ("name", "doc", "buckets", "_mu", "_counts", "_count",
                 "_sum", "_min", "_max")

    def __init__(self, name: str, doc: str = "",
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.doc = doc
        self.buckets = tuple(sorted(buckets or _DEFAULT_BUCKETS))
        self._mu = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # +1 = +Inf
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v):
        v = float(v)
        with self._mu:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            lo, hi = 0, len(self.buckets)
            while lo < hi:                  # first bucket with bound >= v
                mid = (lo + hi) // 2
                if v <= self.buckets[mid]:
                    hi = mid
                else:
                    lo = mid + 1
            self._counts[lo] += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def reset(self):
        with self._mu:
            self._counts = [0] * (len(self.buckets) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def snapshot(self) -> dict:
        with self._mu:
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "min": None, "max": None,
                        "avg": None}
            out = {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "avg": self._sum / self._count,
            }
            for q in (0.5, 0.9, 0.95, 0.99):
                out[f"p{int(q * 100)}"] = self._quantile_locked(q)
            return out

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (the
        histogram_quantile() math of PromQL): find the bucket holding
        the q-th observation, interpolate linearly inside it. The
        estimate is always clamped to the OBSERVED [min, max] — a
        bucket layout entirely below the data piles everything into
        +Inf, and the honest degraded answer there is the observed max,
        never inf/NaN. None when the histogram is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._mu:
            if self._count == 0:
                return None
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        rank = q * self._count
        acc = 0
        lo = 0.0
        for i, bound in enumerate(self.buckets):
            nxt = acc + self._counts[i]
            if nxt >= rank and self._counts[i] > 0:
                frac = (rank - acc) / self._counts[i]
                est = lo + (bound - lo) * frac
                return min(max(est, self._min), self._max)
            acc = nxt
            lo = bound
        # rank lands in the +Inf bucket: the finite upper edge the data
        # exceeded says nothing about how far — clamp to observed max
        return self._max

    def quantiles(self, qs=(0.5, 0.9, 0.99)) -> dict:
        """{"p50": estimate, ...} for each q; {} when empty."""
        with self._mu:
            if self._count == 0:
                return {}
            return {f"p{q * 100:g}": self._quantile_locked(q) for q in qs}

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count), ...] ending at (inf, count)
        — the ``le`` series of the Prometheus exposition."""
        with self._mu:
            out = []
            acc = 0
            for b, c in zip(self.buckets, self._counts):
                acc += c
                out.append((b, acc))
            out.append((math.inf, acc + self._counts[-1]))
            return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class StatRegistry:
    """Name -> metric map (monitor.h StatRegistry::Instance shape).

    ``get_or_create`` is the only write path; asking for an existing
    name with a different type is a bug, not a silent shadow."""

    def __init__(self):
        self._mu = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def get_or_create(self, kind: str, name: str, doc: str = "", **kw):
        with self._mu:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise TypeError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested as {kind}")
                return m
            m = _KINDS[kind](name, doc, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, doc: str = "") -> Counter:
        return self.get_or_create("counter", name, doc)

    def gauge(self, name: str, doc: str = "") -> Gauge:
        return self.get_or_create("gauge", name, doc)

    def histogram(self, name: str, doc: str = "",
                  buckets=None) -> Histogram:
        return self.get_or_create("histogram", name, doc, buckets=buckets)

    def get(self, name: str):
        with self._mu:
            return self._metrics.get(name)

    def metrics(self) -> List[object]:
        """Name-sorted metric list (deterministic snapshots/exposition)."""
        with self._mu:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """Nested dict {kind_plural: {name: value-or-stats}}; {} when no
        metric has been registered (the off-path contract: flag unset ->
        nothing was ever created -> empty)."""
        out: dict = {}
        for m in self.metrics():
            out.setdefault(m.kind + "s", {})[m.name] = m.snapshot()
        return out

    def reset(self):
        """Drop every metric (not just zero them): the off-path contract
        is an EMPTY registry, and callers cache metric handles keyed by
        name so zombie objects must not linger under live names."""
        with self._mu:
            self._metrics.clear()

    def __len__(self):
        with self._mu:
            return len(self._metrics)
