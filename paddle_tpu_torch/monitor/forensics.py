"""Request forensics plane: per-request causal timelines, scheduler
decision audit, tail-latency attribution (a copy of
``paddle_tpu/monitor/forensics.py``; the ``kind`` strings, metric names
and environment variables are the reference's).

The serving scheduler makes many kinds of decisions — priority
admission, displacement, shedding, deadlines, SLO-aware preemption,
prefix-cache admission constraints, circuit breakers and failover
re-dispatch — and until this module nothing in the stack could say
WHICH of them put a request into the bad tail: the latency histograms
aggregate away the request, the cost records carry totals but
not causality, and the trace ring holds unlinked instants. This plane
closes that gap with three bounded, flag-gated structures:

- **Per-request timelines**: every request accumulates a causally
  ordered event list (enqueue, each admission-scan deferral with its
  typed reason, prefix-cache match result, prefill group join, first
  token, preemption with the victim-selection inputs that chose it,
  displacement/shed with the policy inputs, deadline expiry, failover
  strand/re-dispatch hops with ``recovered_from`` lineage, spec accept
  aggregates, retirement). The phase machine folds the time between
  events into named phases — ``queue_wait``, ``prefill``, ``decode``,
  ``preempted_out``, ``stranded_recovery`` — INCREMENTALLY, so the
  phase sums stay exact even when the bounded event list truncates,
  and by construction they sum to the timeline's own e2e.
- **Scheduler decision audit ring**: every admit / defer / shed /
  displace / preempt / evict / breaker-transition appends a
  ``DecisionRecord`` naming the inputs that drove it (queue depth,
  watermark + reclaimable pages, priorities compared, burn/breaker
  state), so policy behavior is auditable instead of inferred.
  Consecutive identical decisions (the same request deferred on the
  same reason step after step) coalesce into one record with a count.
- **Cause attribution**: at retirement each completed request is
  checked against the SLO objectives (``monitor/slo.objectives``);
  a violating request's dominant phase becomes its CAUSE, folded into
  a per-objective table ("p99 TTFT violations: N queue wait, M
  preemption, K failover recovery"). TTFT causes exclude ``decode``
  (decode time is after the first token by definition).

Surfaces: :func:`forensics_payload` (the audit ring + attribution +
slowest-N index) and :func:`request_payload` (one full timeline), served
at ``GET /forensics`` and ``GET /requests/<rid>`` by the operator HTTP
server (``monitor/server.py``); a guarded ``forensics`` block in the
flight record; ``serving.forensics.*`` metrics.

Gating & cost: everything rides ``FLAGS_enable_monitor`` — flag off,
every entry point is one cached-flag branch and NOTHING is registered
(the monitor discipline). Flag on, every hook is pure host bookkeeping at
seams the engine already synchronized (the cost plane's contract: zero added
device synchronizations at any rate, pinned by test via the exectime
``_block_until_ready`` indirection). Bounds: timelines are capped at
``PADDLE_TPU_FORENSICS_REQUESTS`` (default 512; terminal-first LRU
eviction), events per timeline at ``PADDLE_TPU_FORENSICS_EVENTS``
(default 64; truncation counted, phase sums unaffected), the decision
ring at ``PADDLE_TPU_FORENSICS_DECISIONS`` (default 256).
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from ..core import flags as _flags

__all__ = [
    "note", "note_defer", "note_spec", "note_terminal", "decision",
    "request_payload", "forensics_payload", "attribution_table",
    "flight_block", "decisions", "tracked", "has", "reset",
    "TERMINAL_STATES", "PHASES",
]

_FLAG = _flags.flag_info("enable_monitor")

# Every request that touches the engine (or its failover coordinator)
# ends in exactly one of these; the timeline records one terminal
# event for it.
TERMINAL_STATES = ("completed", "rejected", "expired", "shed",
                   "quarantined", "lost")

# Phase labels the incremental decomposition can produce. Their sum is
# the timeline's e2e by construction (each event closes the open phase
# into the accumulator before opening the next).
PHASES = ("queue_wait", "prefill", "decode", "preempted_out",
          "stranded_recovery")

# event kind -> phase opened by that event (None = no transition:
# defers and re-dispatch hops happen INSIDE a phase)
_KIND_PHASE = {
    "enqueue": "queue_wait",
    "admit": "prefill",
    "first_token": "decode",
    "preempt": "preempted_out",
    "strand": "stranded_recovery",
}

# terminal state -> terminal event kind
_TERMINAL_KIND = {
    "completed": "retire", "rejected": "reject", "expired": "expire",
    "shed": "shed", "quarantined": "quarantine", "lost": "lost",
}

# causes eligible per attribution objective: TTFT excludes decode
# (decode time is after the first token by definition)
_TTFT_CAUSES = ("queue_wait", "prefill", "preempted_out",
                "stranded_recovery")

_DEFAULT_REQUESTS = 512
_DEFAULT_EVENTS = 64
_DEFAULT_DECISIONS = 256


def _env_int(name: str, default: int, lo: int = 4) -> int:
    try:
        return max(int(os.environ.get(name, str(default))), lo)
    except (TypeError, ValueError):
        return default


_MAX_REQUESTS = _env_int("PADDLE_TPU_FORENSICS_REQUESTS",
                         _DEFAULT_REQUESTS)
_MAX_EVENTS = _env_int("PADDLE_TPU_FORENSICS_EVENTS", _DEFAULT_EVENTS)
_MAX_DECISIONS = _env_int("PADDLE_TPU_FORENSICS_DECISIONS",
                          _DEFAULT_DECISIONS)

_MU = threading.Lock()
_TIMELINES: "OrderedDict[int, _Timeline]" = OrderedDict()
_EVICTED = [0]
_DECISIONS: deque = deque(maxlen=_MAX_DECISIONS)
_DECISION_TOTAL = [0]
_DECISION_COUNTS: Dict[str, int] = {}
# per-objective violation attribution, folded at retirement
_ATTR: Dict[str, dict] = {}


class _Timeline:
    """One request's causal event list + incremental phase machine."""

    __slots__ = ("rid", "tenant", "priority", "events", "state",
                 "t0", "t_open", "open_phase", "phases", "t_terminal",
                 "t_first_token", "e2e_ms", "ttft_ms", "spec_rounds",
                 "spec_drafted", "spec_accepted", "truncated",
                 "recovered_from")

    def __init__(self, rid: int):
        self.rid = rid
        self.tenant: Optional[str] = None
        self.priority = 0
        self.events: List[dict] = []
        self.state: Optional[str] = None     # terminal state, or None
        self.t0: Optional[float] = None      # first event stamp
        self.t_open: Optional[float] = None  # open phase started here
        self.open_phase: Optional[str] = None
        self.phases: Dict[str, float] = {}   # label -> seconds
        self.t_terminal: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.e2e_ms: Optional[float] = None
        self.ttft_ms: Optional[float] = None
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.truncated = 0
        self.recovered_from: List[str] = []

    # -- phase machine ------------------------------------------------------

    def _advance(self, t: float, new_phase: Optional[str]):
        """Close the open phase into the accumulator, open the next."""
        if self.open_phase is not None and self.t_open is not None:
            dt = max(0.0, t - self.t_open)
            self.phases[self.open_phase] = \
                self.phases.get(self.open_phase, 0.0) + dt
        self.t_open = t
        self.open_phase = new_phase

    def _append(self, ev: dict):
        if len(self.events) >= _MAX_EVENTS:
            # keep the first event (the causal anchor) and the most
            # recent tail: drop the oldest non-anchor event. The phase
            # accumulator is incremental, so truncation never skews the
            # decomposition — only the event list thins.
            self.events.pop(1 if len(self.events) > 1 else 0)
            self.truncated += 1
        self.events.append(ev)

    def add(self, kind: str, t: float, attrs: dict):
        if self.t0 is None:
            self.t0 = t
        if kind == "enqueue":
            if self.open_phase is None and self.state is None:
                # fresh submission (or the first event at all)
                self._advance(t, "queue_wait")
            # else: a re-submission on a survivor after a strand — the
            # open stranded_recovery phase keeps running until admit
        else:
            phase = _KIND_PHASE.get(kind)
            if phase is not None:
                self._advance(t, phase)
            if kind == "first_token":
                # last wins: TTFT belongs to the run the client KEEPS
                # (a preempted run's first token was discarded); the
                # cost record's ttft_ms still takes precedence at
                # note_terminal
                self.t_first_token = t
        if kind == "defer" and self.events:
            last = self.events[-1]
            if last.get("kind") == "defer" \
                    and last.get("reason") == attrs.get("reason"):
                last["count"] = int(last.get("count", 1)) + 1
                last["t_last"] = t
                return
        rf = attrs.get("recovered_from")
        if rf:
            self.recovered_from = list(rf)
        ev = {"kind": kind, "t": t}
        ev.update(attrs)
        self._append(ev)

    def close(self, state: str, t: float, attrs: dict):
        kind = _TERMINAL_KIND.get(state, state)
        if self.t0 is None:
            self.t0 = t
        rf = attrs.get("recovered_from")
        if rf:
            self.recovered_from = list(rf)
        self._advance(t, None)
        self.state = state
        self.t_terminal = t
        if self.e2e_ms is None:
            self.e2e_ms = (t - self.t0) * 1e3
        if self.ttft_ms is None and self.t_first_token is not None:
            self.ttft_ms = (self.t_first_token - self.t0) * 1e3
        ev = {"kind": kind, "t": t}
        ev.update(attrs)
        self._append(ev)

    # -- payload ------------------------------------------------------------

    def payload(self) -> dict:
        t0 = self.t0 or 0.0
        phases = {k: round(v * 1e3, 3)
                  for k, v in sorted(self.phases.items())}
        out = {
            "rid": self.rid,
            "tenant": self.tenant,
            "priority": self.priority,
            "state": self.state,
            "e2e_ms": round(self.e2e_ms, 3)
            if self.e2e_ms is not None else None,
            "ttft_ms": round(self.ttft_ms, 3)
            if self.ttft_ms is not None else None,
            "phases": phases,
            "phase_sum_ms": round(sum(self.phases.values()) * 1e3, 3),
            "events": [
                dict(e, t_ms=round((e["t"] - t0) * 1e3, 3),
                     **({} if "t_last" not in e else
                        {"t_last_ms": round((e["t_last"] - t0) * 1e3,
                                            3)}))
                for e in self.events
            ],
        }
        for ev in out["events"]:
            ev.pop("t", None)
            ev.pop("t_last", None)
        if self.spec_rounds:
            out["spec"] = {"rounds": self.spec_rounds,
                           "drafted": self.spec_drafted,
                           "accepted": self.spec_accepted}
        if self.recovered_from:
            out["recovered_from"] = list(self.recovered_from)
        if self.truncated:
            out["truncated_events"] = self.truncated
        return out


def _inc(name: str, n: int = 1, doc: str = ""):
    # thin lazy shim over monitor.inc (import cycle: the package
    # imports this module); call sites keep literal metric names so
    # scripts/check_metrics_docs.py scans them
    from . import inc
    inc(name, n, doc=doc)


def _timeline_locked(rid: int) -> _Timeline:
    tl = _TIMELINES.get(rid)
    if tl is not None:
        return tl
    while len(_TIMELINES) >= _MAX_REQUESTS:
        victim = None
        for k, v in _TIMELINES.items():       # oldest terminal first
            if v.state is not None:
                victim = k
                break
        if victim is None:                    # all open: oldest
            victim = next(iter(_TIMELINES))
        _TIMELINES.pop(victim, None)
        _EVICTED[0] += 1
        _inc("serving.forensics.requests.evicted",
                     doc="request timelines dropped by the bounded "
                         "store (terminal-first LRU)")
    tl = _Timeline(rid)
    _TIMELINES[rid] = tl
    return tl


# -- recording API (every entry point self-gates on the flag) ----------------

def note(rid, kind: str, t: Optional[float] = None,
         tenant: Optional[str] = None, priority: Optional[int] = None,
         **attrs):
    """Append one causally-ordered event to ``rid``'s timeline. ``t``
    is a ``time.perf_counter()`` stamp the caller already took at the
    seam (pass it so the timeline matches the cost record's clocks);
    omitted, one is taken here."""
    if not _FLAG.value:
        return
    if t is None:
        t = time.perf_counter()
    rid = int(rid)
    with _MU:
        tl = _TIMELINES.get(rid)
        if tl is not None and tl.state is not None \
                and kind == "enqueue":
            # resubmission of a finished rid: the engine restarts the
            # run's mutable state, the timeline restarts with it
            _TIMELINES.pop(rid, None)
            tl = None
        if tl is None:
            tl = _timeline_locked(rid)
        if tenant is not None:
            tl.tenant = str(tenant)
        if priority is not None:
            tl.priority = int(priority)
        tl.add(kind, t, attrs)
    _inc("serving.forensics.events",
                 doc="request-timeline events recorded")


def note_defer(rid, reason: str, **inputs):
    """An admission-scan deferral: the request stayed queued for a
    typed reason. Consecutive same-reason defers coalesce into one
    event with a count — a watermark-blocked head request does not
    flood its timeline one event per scheduler step."""
    note(rid, "defer", reason=reason, **inputs)


def note_spec(rid, drafted: int, accepted: int):
    """Fold one speculative verify round into ``rid``'s aggregate
    (no event append — spec rounds are per-chunk-rate and would flood
    the bounded event list)."""
    if not _FLAG.value:
        return
    with _MU:
        tl = _TIMELINES.get(int(rid))
        if tl is None:
            return
        tl.spec_rounds += 1
        tl.spec_drafted += int(drafted)
        tl.spec_accepted += int(accepted)


def note_terminal(rid, state: str, t: Optional[float] = None,
                  e2e_ms: Optional[float] = None,
                  ttft_ms: Optional[float] = None,
                  tenant: Optional[str] = None, **attrs):
    """Record ``rid``'s single terminal event, close its phase
    decomposition, and fold it into the cause-attribution table.
    ``e2e_ms``/``ttft_ms`` from the cost record take precedence over
    the timeline's own stamps (same clocks, stamped microseconds
    apart)."""
    if not _FLAG.value:
        return
    if t is None:
        t = time.perf_counter()
    rid = int(rid)
    with _MU:
        tl = _TIMELINES.get(rid)
        if tl is not None and tl.state is not None:
            return                      # exactly one terminal event
        if tl is None:
            tl = _timeline_locked(rid)
        if tenant is not None:
            tl.tenant = str(tenant)
        if e2e_ms is not None:
            tl.e2e_ms = float(e2e_ms)
        if ttft_ms is not None:
            tl.ttft_ms = float(ttft_ms)
        tl.close(state, t, attrs)
        if state == "completed":
            _fold_attribution_locked(tl)
    _inc("serving.forensics.events")


def decision(kind: str, rid=None, **inputs):
    """Append one scheduler ``DecisionRecord`` to the audit ring:
    ``kind`` in admit/defer/shed/displace/preempt/evict/breaker, with
    the policy inputs that drove it. Consecutive identical
    (kind, rid, reason) records coalesce with a count."""
    if not _FLAG.value:
        return
    t = time.perf_counter()
    rec = {"kind": str(kind), "t": t}
    if rid is not None:
        rec["rid"] = int(rid)
    rec.update(inputs)
    with _MU:
        _DECISION_TOTAL[0] += 1
        _DECISION_COUNTS[kind] = _DECISION_COUNTS.get(kind, 0) + 1
        if _DECISIONS:
            last = _DECISIONS[-1]
            if (last.get("kind") == rec.get("kind")
                    and last.get("rid") == rec.get("rid")
                    and last.get("reason") == rec.get("reason")):
                last["count"] = int(last.get("count", 1)) + 1
                last["t_last"] = t
                return
        _DECISIONS.append(rec)
    _inc("serving.forensics.decisions",
                 doc="scheduler decision-audit records (admit, defer, "
                     "shed, displace, preempt, evict, breaker)")


# -- attribution -------------------------------------------------------------

def _objective_targets() -> Dict[str, float]:
    try:
        from . import slo as _slo
        obj = _slo.objectives()
        return {"ttft_p99_ms": float(obj["ttft_p99_ms"]),
                "e2e_p99_ms": float(obj["e2e_p99_ms"])}
    except Exception:
        return {"ttft_p99_ms": 1000.0, "e2e_p99_ms": 10000.0}


def _dominant_cause(phases: Dict[str, float],
                    causes) -> Optional[str]:
    best, best_v = None, 0.0
    for c in causes:
        v = phases.get(c, 0.0)
        if v > best_v:
            best, best_v = c, v
    return best


def _fold_attribution_locked(tl: _Timeline):
    targets = _objective_targets()
    for objective, value, causes in (
            ("ttft_p99_ms", tl.ttft_ms, _TTFT_CAUSES),
            ("e2e_p99_ms", tl.e2e_ms, PHASES)):
        a = _ATTR.setdefault(objective, {
            "target": targets.get(objective),
            "completed": 0, "violations": 0, "by_cause": {}})
        a["target"] = targets.get(objective)
        if value is None:
            continue
        a["completed"] += 1
        if value <= (a["target"] or float("inf")):
            continue
        a["violations"] += 1
        cause = _dominant_cause(tl.phases, causes) or "unattributed"
        a["by_cause"][cause] = a["by_cause"].get(cause, 0) + 1


def attribution_table() -> dict:
    """Per-objective violation attribution over the completed requests
    this plane observed: 'p99 TTFT violations: N queue wait, M
    preemption, K failover recovery'."""
    with _MU:
        out = {}
        for objective, a in sorted(_ATTR.items()):
            v = int(a["violations"])
            by = dict(sorted(a["by_cause"].items()))
            out[objective] = {
                "target": a["target"],
                "completed": int(a["completed"]),
                "violations": v,
                "violation_rate": round(v / a["completed"], 6)
                if a["completed"] else None,
                "by_cause": by,
                "by_cause_pct": {
                    k: round(100.0 * n / v, 2) for k, n in by.items()
                } if v else {},
                "top_cause": max(by, key=by.get) if by else None,
            }
        return out


# -- read API ----------------------------------------------------------------

def has(rid) -> bool:
    try:
        return int(rid) in _TIMELINES
    except (TypeError, ValueError):
        return False


def tracked() -> int:
    return len(_TIMELINES)


def request_payload(rid) -> Optional[dict]:
    """One request's full timeline (the ``/requests/<rid>`` body), or
    None when the rid is unknown/evicted."""
    try:
        rid = int(rid)
    except (TypeError, ValueError):
        return None
    with _MU:
        tl = _TIMELINES.get(rid)
        return tl.payload() if tl is not None else None


def decisions(n: Optional[int] = None) -> List[dict]:
    """The most recent decision records, oldest first."""
    with _MU:
        recs = list(_DECISIONS)
    return recs[-n:] if n else recs


def _slowest_locked(n: int, full: bool) -> List[dict]:
    done = [tl for tl in _TIMELINES.values()
            if tl.state is not None and tl.e2e_ms is not None]
    done.sort(key=lambda tl: -tl.e2e_ms)
    out = []
    for tl in done[:n]:
        if full:
            out.append(tl.payload())
        else:
            out.append({"rid": tl.rid, "state": tl.state,
                        "tenant": tl.tenant,
                        "e2e_ms": round(tl.e2e_ms, 3),
                        "top_phase": _dominant_cause(tl.phases,
                                                     PHASES)})
    return out


def forensics_payload(slowest_n: int = 16) -> dict:
    """The ``/forensics`` body: store occupancy, the decision audit
    ring, the cause-attribution table, and a slowest-N index of
    terminal timelines (full payloads live at ``/requests/<rid>``)."""
    from . import set_gauge as _set_gauge
    with _MU:
        by_state: Dict[str, int] = {}
        open_n = 0
        index = {}
        for tl in _TIMELINES.values():
            if tl.state is None:
                open_n += 1
            else:
                by_state[tl.state] = by_state.get(tl.state, 0) + 1
            index[str(tl.rid)] = {
                "state": tl.state,
                "e2e_ms": round(tl.e2e_ms, 3)
                if tl.e2e_ms is not None else None}
        slowest = _slowest_locked(slowest_n, full=False)
        ring = list(_DECISIONS)
    _set_gauge("serving.forensics.requests.tracked", len(index),
               doc="request timelines currently held by the bounded "
                   "forensics store")
    return {
        "kind": "paddle_tpu.forensics",
        "tracked": len(index),
        "open": open_n,
        "evicted": _EVICTED[0],
        "capacity": {"requests": _MAX_REQUESTS,
                     "events_per_request": _MAX_EVENTS,
                     "decisions": _MAX_DECISIONS},
        "terminal_by_state": dict(sorted(by_state.items())),
        "decisions": {
            "total": _DECISION_TOTAL[0],
            "by_kind": dict(sorted(_DECISION_COUNTS.items())),
            "ring": [
                {k: (round(v, 6) if isinstance(v, float) else v)
                 for k, v in r.items()
                 if k not in ("t", "t_last")}
                for r in ring],
        },
        "attribution": attribution_table(),
        "slowest": slowest,
        "requests": index,
    }


def flight_block(n: int = 8) -> Optional[dict]:
    """The flight-record extra: the slowest-N full timelines + the
    decision tail + attribution — what the scheduler had decided about
    the slowest requests in the seconds before a crash. None when the
    plane is empty (an off-path flight dump carries no block)."""
    with _MU:
        if not _TIMELINES and not _DECISIONS:
            return None
        slowest = _slowest_locked(n, full=True)
        tail = list(_DECISIONS)[-16:]
    return {
        "kind": "paddle_tpu.forensics",
        "tracked": len(_TIMELINES),
        "slowest": slowest,
        "decisions_tail": [
            {k: v for k, v in r.items() if k not in ("t", "t_last")}
            for r in tail],
        "attribution": attribution_table(),
    }


def reset():
    with _MU:
        _TIMELINES.clear()
        _EVICTED[0] = 0
        _DECISIONS.clear()
        _DECISION_TOTAL[0] = 0
        _DECISION_COUNTS.clear()
        _ATTR.clear()
