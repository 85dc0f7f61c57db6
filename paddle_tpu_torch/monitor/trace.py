"""Low-overhead structured span tracer + flight recorder (port of
``paddle_tpu/monitor/trace.py``).

Reference capability: the host-span stream of
paddle/fluid/platform/profiler (RecordEvent -> chrometracing_logger.cc)
plus the "black box" crash forensics production fleets bolt onto it.
The reference's design: one process-global BOUNDED ring buffer of
structured events — spans (``span(name, **attrs)`` context manager)
and instants (``instant(name, **attrs)``) with monotonic
``perf_counter_ns`` timestamps — that serves two consumers:

- **Timeline export**: ``export_chrome_trace(path)`` writes
  chrome://tracing JSON of these events, with the profiler's host spans
  (``paddle_tpu_torch.profiler``) merged in as a second track.
- **Flight recorder**: because the buffer is bounded and always holds
  the most recent events, ``dump_flight_record(path)`` at any moment —
  in particular the moment a fault fires (``testing/faults.py``) or a
  SIGTERM preemption lands — writes the last N events plus a full
  ``monitor.snapshot()`` as JSON: what the system was doing in the
  seconds before it died. Its extra blocks are the reference's:
  ``timeseries``, ``numerics``, ``slo``, ``federation``,
  ``forensics``.

Gating: everything rides ``FLAGS_enable_monitor``. Flag off = every
entry point is one cached-flag branch, the buffer stays empty, nothing
is registered. Thread-safety: the ring buffer is a ``deque(maxlen=N)``
— appends are GIL-atomic — with a lock around snapshots/clears.

The flight-record DESTINATION is armed separately (a production launch
script sets it once; tests arm it per-case):

- env ``PADDLE_TPU_FLIGHT_RECORD=/path/to/black_box.json``, or
- ``trace.set_flight_record_path(path)`` in process.

Unarmed, a firing fault dumps nothing — crash paths stay dependency-
free for users who never opted in.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

from ..core import flags as _flags

__all__ = [
    "span", "instant", "events", "clear", "capacity", "total_events",
    "dump_flight_record", "flight_payload", "export_chrome_trace",
    "set_flight_record_path", "flight_record_path", "record_fault",
]

_FLAG = _flags.flag_info("enable_monitor")

# Ring capacity: big enough to hold the last few seconds of a busy
# serving loop (a chunk emits ~3 spans), small enough that the flight
# record stays a readable few hundred KB.
_DEFAULT_CAPACITY = 4096


def _capacity_from_env() -> int:
    try:
        n = int(os.environ.get("PADDLE_TPU_TRACE_EVENTS",
                               str(_DEFAULT_CAPACITY)))
        return max(n, 16)
    except ValueError:
        return _DEFAULT_CAPACITY


class _Ring:
    """Bounded event buffer. Events are tuples
    ``(name, ph, t_ns, dur_ns, tid, attrs)`` with ``ph`` the
    chrome-trace phase ("X" complete span, "i" instant)."""

    def __init__(self, maxlen: int):
        self._mu = threading.Lock()
        self._dq: deque = deque(maxlen=maxlen)
        self._total = 0          # lifetime appends (bounding evidence)

    @property
    def maxlen(self) -> int:
        return self._dq.maxlen

    def add(self, ev: tuple):
        # deque.append is atomic under the GIL; _total is advisory so a
        # lost increment under a race would only undercount telemetry —
        # but take the lock anyway, this is never a hot path.
        with self._mu:
            self._dq.append(ev)
            self._total += 1

    def snapshot(self) -> List[tuple]:
        with self._mu:
            return list(self._dq)

    def clear(self):
        with self._mu:
            self._dq.clear()
            self._total = 0

    @property
    def total(self) -> int:
        return self._total


_RING = _Ring(_capacity_from_env())

# Flight-record destination. _UNSET falls through to the env var
# (resolved lazily so a test can set it after import); any value set
# through the API — including an explicit disarming None — wins.
_UNSET = object()
_FLIGHT_PATH: list = [_UNSET]


def enabled() -> bool:
    return _FLAG.value


class span:
    """Context manager recording one complete span into the ring when
    the monitor is enabled — a single cached-flag branch otherwise.

    ``with trace.span("serving.prefill", group=4):`` — keyword attrs
    land in the event's ``args`` and survive into flight records and
    chrome traces. Reentrant and thread-safe; nesting is expressed by
    timestamp containment (chrome's "X" events nest per tid)."""

    __slots__ = ("name", "attrs", "_t0")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs or None
        self._t0 = None

    def __enter__(self):
        # always (re)assign: a reused instance must not pair a stale t0
        self._t0 = time.perf_counter_ns() if _FLAG.value else None
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            now = time.perf_counter_ns()
            _RING.add((self.name, "X", self._t0, now - self._t0,
                       threading.get_ident() & 0xFFFFFF, self.attrs))
        return False


def instant(name: str, **attrs):
    """Record a zero-duration event (request milestones, faults)."""
    if _FLAG.value:
        _RING.add((name, "i", time.perf_counter_ns(), 0,
                   threading.get_ident() & 0xFFFFFF, attrs or None))


def complete(name: str, t0_ns: int, dur_ns: int, **attrs):
    """Record a span RETROACTIVELY from timestamps the caller already
    holds (perf_counter_ns) — for callers that measured an interval
    before deciding to trace it (StepTimer phases, latency seams)."""
    if _FLAG.value:
        _RING.add((name, "X", int(t0_ns), int(dur_ns),
                   threading.get_ident() & 0xFFFFFF, attrs or None))


def events() -> List[dict]:
    """The buffered events, oldest first, as dicts."""
    return [
        {"name": n, "ph": ph, "t_ns": t, "dur_ns": d, "tid": tid,
         **({"args": a} if a else {})}
        for n, ph, t, d, tid, a in _RING.snapshot()
    ]


def clear():
    _RING.clear()


def capacity() -> int:
    return _RING.maxlen


def total_events() -> int:
    """Lifetime events recorded (> len(events()) once the ring wraps)."""
    return _RING.total


# -- flight recorder --------------------------------------------------------

def set_flight_record_path(path: Optional[str]):
    """Arm (or disarm with None) the crash-time flight-record
    destination for this process; overrides the env var."""
    _FLIGHT_PATH[0] = path


def flight_record_path() -> Optional[str]:
    p = _FLIGHT_PATH[0]
    if p is _UNSET:
        return os.environ.get("PADDLE_TPU_FLIGHT_RECORD") or None
    return p or None


def flight_payload(reason: str = "manual") -> dict:
    """The flight-record payload WITHOUT writing it anywhere: the
    ring's events plus a full ``monitor.snapshot()``. The on-demand
    consumer is the operator-plane ``/flight`` endpoint (a live flight
    record without waiting for a crash); ``dump_flight_record`` writes
    the same shape on crash paths."""
    from . import snapshot as _snapshot
    try:
        # the step-time trajectory (monitor/timeseries.py): a crash's
        # black box should show whether steps were slowing down, not
        # just the final distribution. Guarded — a flight dump on a
        # crash path must never die on a telemetry extra.
        from . import timeseries as _timeseries
        ts = _timeseries.timeseries_snapshot()
    except Exception:
        ts = None
    try:
        # the value trajectory (monitor/numerics.py): which layer's
        # gradients were blowing up before the crash. Same guard.
        from . import numerics as _numerics
        nm = _numerics.numerics_snapshot(n=32)
    except Exception:
        nm = None
    try:
        # the serving story (monitor/slo.py): which tenants were in
        # flight and whether an SLO was burning when it died. headroom
        # stays None — a crash dump must not read the device backend.
        from . import slo as _slo
        sl = _slo.slo_snapshot()
    except Exception:
        sl = None
    try:
        # the fleet story (monitor/federation.py): which replicas were
        # publishing frames and what the last federated verdict said.
        # Cached state only — no transport or backend reads on a crash
        # path — and guarded like the other telemetry extras.
        from . import federation as _federation
        fd = _federation.flight_block()
    except Exception:
        fd = None
    try:
        # the request story (monitor/forensics.py): the slowest-N full
        # timelines, the scheduler decision tail, and the violation
        # attribution the engine had folded when it died. Same guard.
        from . import forensics as _forensics
        fo = _forensics.flight_block()
    except Exception:
        fo = None
    return {
        "kind": "paddle_tpu.flight_record",
        "reason": reason,
        "pid": os.getpid(),
        "unix_time": round(time.time(), 3),
        "trace_capacity": _RING.maxlen,
        "trace_total_events": _RING.total,
        "events": events(),
        "metrics": _snapshot(),
        "timeseries": ts,
        "numerics": nm,
        "slo": sl,
        "federation": fd,
        "forensics": fo,
    }


def dump_flight_record(path: Optional[str] = None,
                       reason: str = "manual") -> Optional[dict]:
    """Write the black box (see :func:`flight_payload`). ``path=None``
    uses the armed destination (no-op returning None when nothing is
    armed). The write is direct (open/write/flush, no tmp+rename):
    this runs on crash paths where a second syscall failing must not
    lose the payload, and a torn file from a mid-write kill is still
    front-truncated-parseable by forensic tooling — the alternative
    (rename) risks leaving NOTHING. Returns the payload dict."""
    path = path or flight_record_path()
    if path is None:
        return None
    payload = flight_payload(reason)
    d = os.path.dirname(os.path.abspath(path))
    try:
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
    except OSError:
        # a dead disk must not mask the original fault
        return payload
    return payload


def record_fault(point: str, action: str) -> Optional[dict]:
    """Crash-path hook (testing/faults.py, preemption handlers): stamp
    the fault itself into the ring, then dump the flight record to the
    armed destination. Never raises — forensics must not change what
    the crash would have done."""
    try:
        instant("fault.fired", point=point, action=action)
        return dump_flight_record(reason=f"fault:{point}:{action}")
    except Exception:
        return None


# -- chrome-trace export ----------------------------------------------------

def export_chrome_trace(path: str, include_profiler: bool = True) -> str:
    """Write chrome://tracing JSON of the ring's spans, merged with the
    profiler's host spans (when a ``paddle_tpu_torch.profiler`` recorder
    has events and ``include_profiler`` is set) as a second process track
    of the same timeline, ``paddle_tpu.profiler.host`` (pid 1). The ring
    stamps ``perf_counter_ns`` and both recorders the same monotonic
    clock (the native tracer's ``steady_clock``), so the tracks align
    without clock translation. The card's kernels are not in this file:
    they are in the profiler's device trace."""
    own = _RING.snapshot()
    prof_events: List[dict] = []
    if include_profiler:
        # read the module-level recorder WITHOUT building one: merging
        # must not trigger a native compile as a side effect
        from .. import profiler as _profiler
        rec = _profiler._recorder
        if rec is not None:
            prof_events = rec.events()

    t0_candidates = [e[2] for e in own] + \
        [e["begin_ns"] for e in prof_events]
    t0 = min(t0_candidates) if t0_candidates else 0
    trace = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": "paddle_tpu.trace"}},
    ]
    if prof_events:
        trace.append({"name": "process_name", "ph": "M", "pid": 1,
                      "args": {"name": "paddle_tpu.profiler.host"}})
    try:
        # serving lifecycle events link to their request's forensics
        # timeline (guarded: an export must not die on a telemetry
        # extra)
        from . import forensics as _forensics
    except Exception:
        _forensics = None
    for n, ph, t, d, tid, a in own:
        ev = {"name": n, "ph": ph, "pid": 0, "tid": tid,
              "ts": (t - t0) / 1000.0}
        if ph == "X":
            ev["dur"] = d / 1000.0
        else:
            ev["s"] = "t"            # thread-scoped instant
        if a:
            ev["args"] = dict(a)
            if (_forensics is not None and n.startswith("serving.")
                    and "rid" in a and _forensics.has(a["rid"])):
                ev["args"]["forensics"] = f"/requests/{a['rid']}"
        trace.append(ev)
    for e in prof_events:
        trace.append({"name": e["name"], "ph": "X", "pid": 1,
                      "tid": e["tid"],
                      "ts": (e["begin_ns"] - t0) / 1000.0,
                      "dur": (e["end_ns"] - e["begin_ns"]) / 1000.0})
    with open(path, "w") as f:
        json.dump({"traceEvents": trace}, f)
    return path
