"""paddle_tpu_torch.monitor — process-global runtime metrics (port of
``paddle_tpu/monitor/``, the planes the serving engine and the training
loops call).

A typed registry (counters, gauges, histograms) with two exposition
surfaces — Prometheus text and a run-id-keyed JSON snapshot — and the
planes built on it:

- ``trace``: the bounded event ring (spans, instants), the flight
  record and the chrome-trace export;
- ``slo``: per-request cost records, tenant aggregates, objectives,
  burn rates and burn alerting, the autoscale demand model;
- ``forensics``: per-request timelines, the scheduler decision ring,
  violation-cause attribution;
- ``programs``: the serving programs with their shapes, hits, FLOPs and
  bytes;
- ``mfu``: peak FLOP/s by card and model-FLOPs utilization;
- ``comms``: the collectives counted at the port's seams;
- ``roofline``: compute / HBM / comm-bound verdicts of the programs
  behind ``/roofline``;
- ``exectime``: 1-in-N sampled execution timing at the engine's seams;
- ``steptimer``: ``StepTimer`` (data-wait / compute / checkpoint phases
  and goodput), ``ambient_phase`` (the checkpoint manager's bill) and
  the step listeners that feed the hang watchdog;
- ``timeseries``: the bounded step ring and the step-time drift
  detector behind ``/timeseries``;
- ``numerics``: per-layer gradient statistics of the guarded step,
  the weight-quantization audit, KV-page absmax and KV-quant health;
- ``memory``: device-memory gauges and the serving headroom estimate;
- ``federation``: per-replica telemetry frames and the federated fleet
  verdict the elastic serving controller scales on;
- ``profile_capture``: the on-demand ``torch.profiler`` window;
- ``server``: the operator HTTP server (``start_server`` /
  ``stop_server`` / ``maybe_start``) and its health-provider map.

Gating: everything is behind ``FLAGS_enable_monitor`` (core/flags.py).
With the flag off (the default) every instrumented seam pays ONE branch
on a cached flag record, so ``snapshot()`` stays ``{}`` — nothing is
registered until something is recorded. Flip it on with
``FLAGS_enable_monitor=1`` in the environment or
``paddle_tpu_torch.set_flags({"FLAGS_enable_monitor": True})`` at runtime.
Metric names, trace events, forensics kinds and environment variables
are the reference's.

Counters recorded outside the planes: ``autotune.cache.hit|miss|evictions``
and ``autotune.sweeps``, the kernel autotuner (``kernels/autotune.py``).

The op library's hooks: ``record_op`` (``op.<name>.calls`` and the
``op.dispatch.wall_ns`` histogram), called by the dispatch seam
``ops/_op.py`` for every registered op, and ``tensor_bytes`` /
``tensor_free`` (``tensor.bytes.live`` / ``peak``), called for
``to_tensor`` and every registered op's outputs (``core/tensor.py``).
Python operators on torch tensors (``x + y``) are torch's and count
nothing.
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
    "inc", "observe", "set_gauge", "record_op", "tensor_bytes",
    "tensor_free",
    "snapshot", "expose_text", "dump_json", "reset", "timed",
    "trace", "server", "programs", "exectime", "numerics", "slo",
    "forensics", "memory", "federation", "profile_capture", "fleet",
    "mfu", "comms", "roofline",
    "StepTimer", "ambient_phase", "timeseries",
    "suppressed", "suppress_accounting",
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


# -- hot-path helpers (self-gated, handle-cached) ---------------------------

# Per-op metric handles: the dispatch seam calls record_op on every
# registered op while the flag is on, so the registry lock stays off
# that path: plain dict reads, and a first-seen name takes the lock.
_OP_HANDLES: dict = {}
_DISPATCH_HIST: list = []       # one-element cache of the shared histogram


def record_op(opname: str, wall_ns: int):
    """Per-op call counter + shared dispatch wall-time histogram."""
    if not _FLAG.value:
        return
    h = _OP_HANDLES.get(opname)
    if h is None:
        h = _REGISTRY.counter(f"op.{opname}.calls",
                              "eager dispatches of this op")
        _OP_HANDLES[opname] = h
    if not _DISPATCH_HIST:
        _DISPATCH_HIST.append(_REGISTRY.histogram(
            "op.dispatch.wall_ns",
            "wall time of one eager op dispatch (ns), all ops",
            buckets=tuple(float(10 ** i) for i in range(2, 11))))
    h.incr()
    _DISPATCH_HIST[0].observe(wall_ns)


_TENSOR_GAUGES: list = []       # [(live, peak)] one-element cache
# Generation counter bumped by reset(): frees of tensors counted in an
# earlier generation are dropped instead of landing on (and driving
# negative) gauges recreated after the reset.
_TENSOR_EPOCH = [0]


def tensor_bytes(nbytes: int):
    """Count a tensor allocation into the live / peak byte gauges.
    Returns the generation to pass back to ``tensor_free``, or None when
    the flag is off. Allocations count only while the flag is on, but a
    free lands whatever the flag (turning it off does not pin counted
    bytes in ``live``), only within the same generation (a ``reset()``
    orphans stragglers instead of driving the gauge negative)."""
    if not _FLAG.value:
        return None
    if not _TENSOR_GAUGES:
        _TENSOR_GAUGES.append((
            _REGISTRY.gauge("tensor.bytes.live",
                            "bytes held by live Tensor handles"),
            _REGISTRY.gauge("tensor.bytes.peak",
                            "high-water mark of tensor.bytes.live"),
        ))
    live, peak = _TENSOR_GAUGES[0]
    live.add_and_max_into(nbytes, peak)
    return _TENSOR_EPOCH[0]


def tensor_free(nbytes: int, epoch):
    """Return a counted allocation's bytes (the finalizer side of
    ``tensor_bytes``); dropped when the registry was reset since."""
    if epoch == _TENSOR_EPOCH[0] and _TENSOR_GAUGES:
        _TENSOR_GAUGES[0][0].add(-nbytes)


# -- reporting --------------------------------------------------------------

def snapshot() -> dict:
    """Nested {kind: {name: value}} dict; {} when nothing registered."""
    return _REGISTRY.snapshot()


def expose_text() -> str:
    """Prometheus text exposition of every registered metric, plus the
    SLO plane's per-tenant labeled series (``slo_tenant_*{tenant=...}``
    — tenant names are client-supplied strings, so they ride label
    escaping, not metric names; empty until a tenant records)."""
    text = _exposition.expose_text(_REGISTRY)
    tenant_text = slo.tenant_exposition_text()
    if tenant_text:
        text += tenant_text
    # federation per-replica attribution series (slo_fleet_replica_*
    # {replica="..."}); empty until a federated report exists
    fed_text = federation.exposition_text()
    if fed_text:
        text += fed_text
    return text


def dump_json(run_id: Optional[str] = None,
              path: Optional[str] = None) -> dict:
    """Run-id-keyed JSON snapshot; optional atomic file write."""
    return _exposition.dump_json(_REGISTRY, run_id=run_id, path=path)


def reset():
    """Drop all metrics and the state of every ported plane (tests;
    between runs). The trace ring empties with the registry — a flight
    record dumped after a reset describes the new run, not the old
    one. Live counted tensors become orphans: their later frees are
    dropped (generation mismatch), never negative gauges."""
    _REGISTRY.reset()
    _OP_HANDLES.clear()
    _DISPATCH_HIST.clear()
    _TENSOR_GAUGES.clear()
    _TENSOR_EPOCH[0] += 1
    trace.clear()
    programs.reset()
    exectime.reset()
    timeseries.reset()
    numerics.reset()
    slo.reset()
    federation.reset()
    forensics.reset()
    fleet.reset()
    comms.reset()
    import sys as _sys
    _introspect = _sys.modules.get("paddle_tpu_torch.distributed.introspect")
    if _introspect is not None:
        _introspect.reset()


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
from .steptimer import StepTimer, ambient_phase  # noqa: E402
from . import timeseries  # noqa: E402
from . import programs  # noqa: E402
from . import exectime  # noqa: E402
from . import numerics  # noqa: E402
from . import slo  # noqa: E402
from . import forensics  # noqa: E402
from . import memory  # noqa: E402
from . import federation  # noqa: E402
from . import profile_capture  # noqa: E402
from . import fleet  # noqa: E402
from . import server  # noqa: E402
from . import mfu  # noqa: E402
from . import comms  # noqa: E402
from . import roofline  # noqa: E402
