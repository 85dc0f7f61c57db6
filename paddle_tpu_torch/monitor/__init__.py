"""paddle_tpu_torch.monitor — process-global runtime metrics (port of
``paddle_tpu/monitor/``, the planes the serving engine calls).

A typed registry (counters, gauges, histograms) with two exposition
surfaces — Prometheus text and a run-id-keyed JSON snapshot — and the
planes built on it:

- ``trace``: the bounded event ring (spans, instants), the flight
  record and the chrome-trace export;
- ``slo``: per-request cost records, tenant aggregates, objectives,
  burn rates and burn alerting, the autoscale demand model;
- ``forensics``: per-request timelines, the scheduler decision ring,
  violation-cause attribution;
- ``programs``: the serving programs with their shapes, hits and FLOPs;
- ``exectime``: 1-in-N sampled execution timing at the engine's seams;
- ``numerics``: the KV half (KV-page absmax, KV-quant health);
- ``server``: the health-provider map (``health()``).

Gating: everything is behind ``FLAGS_enable_monitor`` (core/flags.py).
With the flag off (the default) every instrumented seam pays ONE branch
on a cached flag record, so ``snapshot()`` stays ``{}`` — nothing is
registered until something is recorded. Flip it on with
``FLAGS_enable_monitor=1`` in the environment or
``paddle_tpu_torch.set_flags({"FLAGS_enable_monitor": True})`` at runtime.
Metric names, trace events, forensics kinds and environment variables
are the reference's.

Not ported yet, with their queue items in ROADMAP.md:

- ``record_op``, ``tensor_bytes`` and ``tensor_free``, hooks of the
  eager ``Tensor`` (A10, ``core/``);
- the ``mfu``, ``steptimer``, ``fleet``, ``memory``, ``comms``,
  ``roofline`` and ``timeseries`` planes, the rest of ``numerics`` and
  ``profiler/`` (A10);
- ``federation``, the HTTP server (``start_server`` / ``stop_server``)
  and ``profile_capture`` (A7(d)).
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ..core import flags as _flags
from . import exposition as _exposition
from .registry import Counter, Gauge, Histogram, StatRegistry

__all__ = [
    "Counter", "Gauge", "Histogram", "StatRegistry",
    "enabled", "registry", "counter", "gauge", "histogram",
    "inc", "observe", "set_gauge",
    "snapshot", "expose_text", "dump_json", "reset", "timed",
    "trace", "server", "programs", "exectime", "numerics", "slo",
    "forensics", "suppressed", "suppress_accounting",
]

# The one process-global registry (monitor.h StatRegistry::Instance()).
_REGISTRY = StatRegistry()

# Cached flag record: set_flags mutates the _FlagInfo in place, so one
# attribute load reads the current value — the hot-path gate.
_FLAG = _flags.flag_info("enable_monitor")


def enabled() -> bool:
    """True when FLAGS_enable_monitor is set (env or set_flags)."""
    return _FLAG.value


# Accounting suppression: monitor-internal work that would otherwise
# count itself wraps itself in suppress_accounting(); counters that
# could fire inside it check suppressed(). Thread-local: one thread's
# suppression must not mute another's real work.
_SUPPRESS = threading.local()


def suppressed() -> bool:
    """True while this thread is inside a monitor-internal re-trace."""
    return getattr(_SUPPRESS, "depth", 0) > 0


class suppress_accounting:
    """Context manager muting accounting on this thread (re-entrant)."""

    def __enter__(self):
        _SUPPRESS.depth = getattr(_SUPPRESS, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _SUPPRESS.depth -= 1
        return False


def registry() -> StatRegistry:
    return _REGISTRY


# -- typed access (creates the metric; callers gate on enabled()) -----------

def counter(name: str, doc: str = "") -> Counter:
    return _REGISTRY.counter(name, doc)


def gauge(name: str, doc: str = "") -> Gauge:
    return _REGISTRY.gauge(name, doc)


def histogram(name: str, doc: str = "", buckets=None) -> Histogram:
    return _REGISTRY.histogram(name, doc, buckets=buckets)


# -- gated convenience (no-ops when the flag is off) ------------------------

def inc(name: str, n=1, doc: str = ""):
    if _FLAG.value:
        _REGISTRY.counter(name, doc).incr(n)


def observe(name: str, value, doc: str = "", buckets=None):
    if _FLAG.value:
        _REGISTRY.histogram(name, doc, buckets=buckets).observe(value)


def set_gauge(name: str, value, doc: str = ""):
    if _FLAG.value:
        _REGISTRY.gauge(name, doc).set(value)


# -- reporting --------------------------------------------------------------

def snapshot() -> dict:
    """Nested {kind: {name: value}} dict; {} when nothing registered."""
    return _REGISTRY.snapshot()


def expose_text() -> str:
    """Prometheus text exposition of every registered metric, plus the
    SLO plane's per-tenant labeled series (``slo_tenant_*{tenant=...}``
    — tenant names are client-supplied strings, so they ride label
    escaping, not metric names; empty until a tenant records). The
    reference also appends federation's per-replica series, empty until
    a federated report exists; federation is not ported (A7(d))."""
    text = _exposition.expose_text(_REGISTRY)
    tenant_text = slo.tenant_exposition_text()
    if tenant_text:
        text += tenant_text
    return text


def dump_json(run_id: Optional[str] = None,
              path: Optional[str] = None) -> dict:
    """Run-id-keyed JSON snapshot; optional atomic file write."""
    return _exposition.dump_json(_REGISTRY, run_id=run_id, path=path)


def reset():
    """Drop all metrics and the state of every ported plane (tests;
    between runs). The trace ring empties with the registry — a flight
    record dumped after a reset describes the new run, not the old
    one."""
    _REGISTRY.reset()
    trace.clear()
    programs.reset()
    exectime.reset()
    numerics.reset()
    slo.reset()
    forensics.reset()


class timed:
    """Context manager observing its wall time (ms) into a histogram
    when the monitor is enabled — zero-cost pass-through otherwise.
    ``buckets`` picks the histogram layout (e.g. the shared
    ``registry.LATENCY_BUCKETS_MS`` for SLO-shaped latencies)."""

    __slots__ = ("name", "doc", "buckets", "_t0")

    def __init__(self, name: str, doc: str = "", buckets=None):
        self.name = name
        self.doc = doc
        self.buckets = buckets
        self._t0 = None

    def __enter__(self):
        # always (re)assign: a reused instance must not observe a stale
        # _t0 from an earlier flag-on entry
        self._t0 = time.perf_counter() if _FLAG.value else None
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            observe(self.name, (time.perf_counter() - self._t0) * 1e3,
                    self.doc, buckets=self.buckets)
        return False


# The planes (imported AFTER the registry surface above: they call back
# into it lazily).
from . import trace  # noqa: E402
from . import programs  # noqa: E402
from . import exectime  # noqa: E402
from . import numerics  # noqa: E402
from . import slo  # noqa: E402
from . import forensics  # noqa: E402
from . import server  # noqa: E402
