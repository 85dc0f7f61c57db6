"""Exactly-once request failover (port of
``paddle_tpu/inference/failover.py``): admission journal, stranded-work
re-dispatch, poison-request quarantine, per-replica circuit breakers.

- **Admission journal** (:class:`AdmissionJournal`): every request an
  engine accepts is recorded -- idempotency key, tenant, priority,
  deadline TTL, prompt spec (derivation seed) or inline tokens, pinned
  sampling seed, attempt count -- on the name-keyed heartbeat transport
  (``distributed/heartbeat.py``), under the participant name
  ``<replica>.journal``. Completion markers are written at every
  terminal event (completed, shed, expired), so a request that finished
  just before the crash is never double-served: re-dispatch skips any
  rid with a marker.
- **Stranded-work re-dispatch** (:class:`FailoverCoordinator`): when a
  replica is replaced, the coordinator reads its journal, skips completed
  markers, and queues the in-flight remainder for resubmission through
  the normal admission path on survivors -- remaining deadline carried,
  attempts bounded, backoff riding the demand-model ``retry_after_s``
  hint (capped). :func:`rebuild_request` turns a record back into an
  engine ``Request``. Every stranded request ends in exactly one terminal
  state (``completed`` / ``expired`` / ``shed`` / ``quarantined``) with a
  ``recovered_from`` lineage.
- **Poison-request quarantine**: a request whose replica dies N
  consecutive attempts terminates typed ``quarantined`` (content-hash
  keyed) rather than cascading kills across the fleet.
- **Circuit breakers** (:class:`CircuitBreaker`): a replica that
  repeatedly sheds fresh admissions trips open, routes new work away for
  a cooldown, then half-opens with a single probe -- close on success,
  reopen on failure.

The journal's kind, version, payload layout and environment knobs are
the reference's, so the port's coordinator reads a journal the JAX
engine wrote. Where the port differs: a record journals ``"seed"`` (the
engine's pinned sampling seed) where the reference journals ``"key"``
(its pinned PRNG key). The monitor counters and gauges
(``serving.failover.*``), trace events and forensics notes are the
reference's (monitor on only), and ``coordinator.counters`` counts either
way. Everything is gated behind
``FLAGS_serving_failover`` (default off): with the flag off no journal
is attached and scheduling and tokens are the engine's without it.
"""
from __future__ import annotations

import hashlib
import os
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from .. import monitor as _monitor
from ..monitor import forensics as _forensics
from ..monitor import trace as _trace


JOURNAL_KIND = "paddle_tpu.admission_journal"
JOURNAL_VERSION = 1
JOURNAL_SUFFIX = ".journal"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def request_fingerprint(prompt, max_new_tokens, temperature) -> str:
    """Content hash for the poison-request quarantine set: a request
    that keeps killing replicas is identified by WHAT it asks for, not
    by its rid (a client retrying under a fresh rid must still hit the
    quarantine). blake2b-128 over the prompt as int32 (the reference's
    bytes: the port's engine holds prompts as int64), the new-token
    count and the temperature."""
    h = hashlib.blake2b(digest_size=16)
    arr = np.ascontiguousarray(np.asarray(prompt, np.int32))
    h.update(arr.tobytes())
    h.update(str(int(max_new_tokens)).encode())
    h.update(repr(float(temperature)).encode())
    return h.hexdigest()


def journal_name(replica: str) -> str:
    return f"{replica}{JOURNAL_SUFFIX}"


class AdmissionJournal:
    """Write-through durability record for one replica's admitted
    requests, published on the name-keyed heartbeat transport under
    ``<replica>.journal`` (a name the controller never lists in its
    staleness scans, so the extra beat file is inert to liveness).

    The payload IS the journal: one publish per admit and per
    retirement keeps the transport copy current, so whatever the
    coordinator reads after a crash is at worst one event stale — and
    the completion marker for a request is written BEFORE its output
    is harvested, so "finished just before the crash" is always
    visible as completed, never re-served. Transport failures degrade
    honestly: the engine keeps serving and the affected requests fall
    back to today's ``lost`` typing."""

    def __init__(self, replica: str, *, dir_path: Optional[str] = None,
                 client=None, max_completed: int = 256):
        self.replica = str(replica)
        self._dir = dir_path
        self._client = client
        self._seq = 0
        self.inflight: Dict[str, dict] = {}
        # bounded completion-marker window (OrderedDict eviction): the
        # dedup only has to cover the crash window, not all history
        self.completed: "OrderedDict[str, dict]" = OrderedDict()
        self._max_completed = int(max_completed)
        self.publish_failures = 0

    # -- record construction ------------------------------------------------

    def _record(self, req) -> dict:
        prompt = np.asarray(getattr(req, "prompt"), np.int32)
        max_new = int(getattr(req, "max_new_tokens"))
        temp = float(getattr(req, "temperature", 0.0) or 0.0)
        rec = {
            "rid": int(getattr(req, "rid")),
            "tenant": str(getattr(req, "tenant", "default") or "default"),
            "priority": int(getattr(req, "priority", 0) or 0),
            "deadline_s": getattr(req, "deadline_s", None),
            "max_new_tokens": max_new,
            "temperature": temp,
            "attempts": int(getattr(req, "_failover_attempts", 0)),
            "recovered_from": list(getattr(req, "_recovered_from", ())),
        }
        fp = request_fingerprint(prompt, max_new, temp)
        rec["fingerprint"] = fp
        rec["idem"] = f"{rec['rid']}:{fp}"
        spec = getattr(req, "prompt_spec", None)
        if spec:
            # derivation spec (trace seed + rid + lengths): the replay
            # rebuilds the exact prompt as a pure function, keeping the
            # journal payload small for long prompts
            rec["prompt_spec"] = dict(spec)
        else:
            rec["prompt"] = [int(t) for t in prompt.tolist()]
        seed = getattr(req, "seed", None)
        if seed is not None:
            rec["seed"] = int(seed)
        return rec

    # -- write-through events -----------------------------------------------

    def admit(self, req) -> None:
        rec = self._record(req)
        self.inflight[str(rec["rid"])] = rec
        _monitor.inc("serving.failover.journal.records",
                     doc="admission-journal records published (one per "
                         "accepted request while FLAGS_serving_failover "
                         "is on)")
        self._publish()

    def finish(self, rid, state: str, tokens: int = 0) -> None:
        rid_s = str(int(rid))
        rec = self.inflight.pop(rid_s, None)
        marker = {"state": str(state), "tokens": int(tokens)}
        if rec is not None:
            marker["idem"] = rec.get("idem")
        self.completed[rid_s] = marker
        while len(self.completed) > self._max_completed:
            self.completed.popitem(last=False)
        _monitor.inc("serving.failover.journal.completions",
                     doc="completion markers written at retirement "
                         "(the exactly-once dedup record)")
        self._publish()

    def _publish(self) -> None:
        from ..distributed import heartbeat as _hb
        self._seq += 1
        payload = {"kind": JOURNAL_KIND, "v": JOURNAL_VERSION,
                   "replica": self.replica, "seq": self._seq,
                   "inflight": self.inflight,
                   "completed": dict(self.completed)}
        try:
            ok = _hb.publish_named(journal_name(self.replica), payload,
                                   dir_path=self._dir,
                                   client=self._client)
        except Exception:
            ok = False
        if not ok:
            self.publish_failures += 1


def read_journal(replica: str, *, dir_path: Optional[str] = None,
                 client=None) -> Optional[dict]:
    """Best surviving journal payload for ``replica`` (file beat +
    coordination-service KV, seq tiebreak — ``read_named`` semantics),
    or None when absent/malformed. Never raises."""
    from ..distributed import heartbeat as _hb
    try:
        payload = _hb.read_named(journal_name(replica),
                                 dir_path=dir_path, client=client)
    except Exception:
        return None
    if not isinstance(payload, dict):
        return None
    if payload.get("kind") != JOURNAL_KIND:
        return None
    try:
        if int(payload.get("v", 0)) > JOURNAL_VERSION:
            return None  # refuse to half-parse a future format
    except (TypeError, ValueError):
        return None
    return payload


def sweep_journal(replica: str, *, dir_path: Optional[str] = None,
                  client=None) -> None:
    from ..distributed import heartbeat as _hb
    try:
        _hb.remove_named(dir_path, journal_name(replica), client=client)
    except Exception:
        pass


class CircuitBreaker:
    """Per-replica fresh-admission breaker: ``closed`` until
    ``threshold`` CONSECUTIVE shed admissions, then ``open`` for
    ``cooldown_s`` (new work routes away), then ``half_open`` with a
    single probe — success closes, failure reopens. Clock is passed
    in (the replay drives it with virtual time)."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 2.0):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.state = "closed"
        self.failures = 0
        self.opened_count = 0
        self.closed_count = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    def allows(self, now: float) -> bool:
        if self.state == "open" and (now - self._opened_at
                                     >= self.cooldown_s):
            self.state = "half_open"
            self._probe_inflight = False
        if self.state == "closed":
            return True
        if self.state == "half_open":
            return not self._probe_inflight
        return False

    def note_probe(self) -> None:
        if self.state == "half_open":
            self._probe_inflight = True

    def record(self, ok: bool, now: float) -> None:
        if self.state == "half_open":
            self._probe_inflight = False
            if ok:
                self.state = "closed"
                self.failures = 0
                self.closed_count += 1
            else:
                self.state = "open"
                self._opened_at = now
                self.opened_count += 1
            return
        if ok:
            self.failures = 0
            return
        self.failures += 1
        if self.state == "closed" and self.failures >= self.threshold:
            self.state = "open"
            self._opened_at = now
            self.opened_count += 1

    def as_dict(self) -> dict:
        return {"state": self.state, "failures": self.failures,
                "opened": self.opened_count, "closed": self.closed_count}


class FailoverCoordinator:
    """Controller-side half of the durability discipline: consumes the
    journals of replaced replicas, owns the re-dispatch queue with
    bounded attempts + capped backoff, the quarantine hash set, and
    the per-replica circuit breakers. Single-threaded: no locking; the
    caller that replaces replicas and the one that re-dispatches share
    one thread.

    Knobs (env, read at construction):

    - ``PADDLE_TPU_FAILOVER_QUARANTINE_ATTEMPTS`` (default 3): a
      request stranded by this many replica deaths is quarantined.
    - ``PADDLE_TPU_FAILOVER_MAX_ATTEMPTS`` (default 6): total dispatch
      attempts (strands + shed retries) before a typed terminal shed.
    - ``PADDLE_TPU_FAILOVER_BACKOFF_CAP_S`` (default 5.0): ceiling on
      the re-dispatch backoff, including ``retry_after_s`` hints.
    - ``PADDLE_TPU_FAILOVER_BREAKER_THRESHOLD`` / ``..._COOLDOWN_S``
      (default 3 / 2.0): breaker trip point and open dwell."""

    def __init__(self, *, heartbeat_dir: Optional[str] = None,
                 client=None,
                 quarantine_attempts: Optional[int] = None,
                 max_attempts: Optional[int] = None,
                 backoff_cap_s: Optional[float] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_cooldown_s: Optional[float] = None):
        self._dir = heartbeat_dir
        self._client = client
        self.quarantine_attempts = max(1, int(
            quarantine_attempts if quarantine_attempts is not None
            else _env_int("PADDLE_TPU_FAILOVER_QUARANTINE_ATTEMPTS", 3)))
        self.max_attempts = max(1, int(
            max_attempts if max_attempts is not None
            else _env_int("PADDLE_TPU_FAILOVER_MAX_ATTEMPTS", 6)))
        self.backoff_cap_s = max(0.0, float(
            backoff_cap_s if backoff_cap_s is not None
            else _env_float("PADDLE_TPU_FAILOVER_BACKOFF_CAP_S", 5.0)))
        self._breaker_threshold = max(1, int(
            breaker_threshold if breaker_threshold is not None
            else _env_int("PADDLE_TPU_FAILOVER_BREAKER_THRESHOLD", 3)))
        self._breaker_cooldown = float(
            breaker_cooldown_s if breaker_cooldown_s is not None
            else _env_float("PADDLE_TPU_FAILOVER_BREAKER_COOLDOWN_S",
                            2.0))
        # the coordinator's time source: every not_before/backoff stamp
        # and every due() comparison read the SAME clock. The replay
        # pump swaps in its virtual clock so backoff is deterministic
        # in virtual seconds, not wall time.
        self.clock = time.monotonic
        self.pending: List[dict] = []      # stranded, awaiting re-dispatch
        self.terminal: Dict[int, dict] = {}  # rid -> rec with "state"
        self.quarantined_hashes: set = set()
        self.breakers: Dict[str, CircuitBreaker] = {}
        self._redispatched: Dict[int, dict] = {}  # rid -> rec, in flight
        self.counters = {"stranded": 0, "redispatched": 0,
                         "recovered": 0, "quarantined": 0, "deduped": 0,
                         "expired": 0, "shed": 0, "attempts": 0}

    # -- strand intake ------------------------------------------------------

    def _backoff(self, attempts: int) -> float:
        base = 0.25 * (2.0 ** max(0, int(attempts) - 1))
        return min(self.backoff_cap_s, base)

    def _finish(self, rec: dict, state: str) -> None:
        rid = int(rec["rid"])
        rec = dict(rec, state=state)
        self.terminal[rid] = rec
        self.counters[state if state in self.counters else "shed"] = \
            self.counters.get(state, 0) + 1
        _trace.instant("serving.failover.terminal", rid=rid, state=state,
                       attempts=rec.get("attempts", 0))
        if state in ("quarantined", "expired", "shed"):
            # coordinator-terminated strands never reach an engine
            # terminal: this is their one terminal timeline event
            _forensics.note_terminal(
                rid, state, attempts=rec.get("attempts", 0),
                tenant=rec.get("tenant"),
                recovered_from=list(rec.get("recovered_from") or []))

    def note_replaced(self, victim: str,
                      now: Optional[float] = None) -> int:
        """The controller replaced ``victim``: read its journal, skip
        every rid with a completion marker (the exactly-once dedup),
        quarantine poison requests, queue the rest for re-dispatch
        with backoff. Sweeps the journal and drops the breaker.
        Returns the number of requests stranded (queued or
        quarantined)."""
        now = self.clock() if now is None else now
        payload = read_journal(victim, dir_path=self._dir,
                               client=self._client)
        sweep_journal(victim, dir_path=self._dir, client=self._client)
        self.breakers.pop(victim, None)
        if payload is None:
            return 0
        completed = payload.get("completed") or {}
        # pending/terminal rids are settled elsewhere; a rid in
        # _redispatched is NOT skipped — its survivor just died too,
        # and this journal read is exactly its re-strand
        known = ({int(r["rid"]) for r in self.pending}
                 | set(self.terminal))
        stranded = 0
        for rid_s, rec in sorted((payload.get("inflight") or {}).items(),
                                 key=lambda kv: int(kv[1].get("rid", 0))):
            if not isinstance(rec, dict) or "rid" not in rec:
                continue
            rid = int(rec["rid"])
            if rid_s in completed:
                # finished just before the crash: the marker wins, the
                # output was (or will be) harvested — never re-serve
                self.counters["deduped"] += 1
                _monitor.inc("serving.failover.deduped",
                             doc="stranded rids skipped by a journal "
                                 "completion marker (exactly-once "
                                 "dedup)")
                continue
            if rid in known:
                continue
            self._redispatched.pop(rid, None)
            attempts = int(rec.get("attempts", 0)) + 1
            rec = dict(rec, attempts=attempts, t_strand=now,
                       # wall-clock strand stamp for a recovery time
                       # (never journaled — t_strand rides the
                       # coordinator clock, this one real time)
                       _t_strand_wall=time.perf_counter(),
                       recovered_from=list(rec.get("recovered_from")
                                           or []) + [victim])
            stranded += 1
            self.counters["stranded"] += 1
            _monitor.inc("serving.failover.stranded",
                         doc="journaled in-flight requests found on a "
                             "replaced replica")
            fp = rec.get("fingerprint")
            if ((fp and fp in self.quarantined_hashes)
                    or attempts >= self.quarantine_attempts):
                if fp:
                    self.quarantined_hashes.add(fp)
                _monitor.inc("serving.failover.quarantined",
                             doc="poison requests terminated typed "
                                 "`quarantined` after N consecutive "
                                 "replica-death attempts")
                self._finish(rec, "quarantined")
            else:
                rec["not_before"] = now + self._backoff(attempts)
                self.pending.append(rec)
            _trace.instant("serving.failover.strand", rid=rid,
                           replica=victim, attempts=attempts)
            # the strand hop rides the journal record's lineage, so a
            # recovered request's timeline spans replicas
            _forensics.note(rid, "strand",
                            t=rec["_t_strand_wall"], replica=victim,
                            attempts=attempts,
                            recovered_from=list(rec["recovered_from"]))
        _monitor.set_gauge("serving.failover.pending",
                           len(self.pending),
                           doc="stranded requests awaiting re-dispatch")
        return stranded

    # -- re-dispatch queue --------------------------------------------------

    def due(self, now: float) -> List[dict]:
        """Pop every stranded record whose backoff has elapsed. The
        caller must route each through ``redispatched``, ``requeue``
        or ``resolve`` — a popped record is no longer pending."""
        ready = [r for r in self.pending if r.get("not_before", 0.0)
                 <= now]
        if ready:
            self.pending = [r for r in self.pending
                            if r.get("not_before", 0.0) > now]
        return ready

    def redispatched(self, rec: dict, replica: str, now: float) -> None:
        rid = int(rec["rid"])
        self._redispatched[rid] = rec
        self.counters["redispatched"] += 1
        self.counters["attempts"] += 1
        _monitor.inc("serving.failover.redispatched",
                     doc="stranded requests resubmitted through normal "
                         "admission on a surviving replica")
        _trace.instant("serving.failover.redispatch", rid=rid,
                       replica=replica, attempts=rec.get("attempts", 0))
        _forensics.note(rid, "redispatch", replica=replica,
                        attempts=rec.get("attempts", 0))

    def requeue(self, rec: dict, now: float,
                retry_after_s: Optional[float] = None) -> None:
        """A re-dispatch attempt was shed by the survivor: back off on
        the (capped) ``retry_after_s`` hint and try again, until the
        total-attempt bound turns it into a typed terminal shed."""
        rid = int(rec["rid"])
        self._redispatched.pop(rid, None)
        self.counters["attempts"] += 1
        attempts = int(rec.get("attempts", 0)) + 1
        rec = dict(rec, attempts=attempts)
        if attempts >= self.max_attempts:
            self._finish(rec, "shed")
            return
        hint = self._backoff(attempts)
        if retry_after_s is not None:
            try:
                hint = min(self.backoff_cap_s,
                           max(0.0, float(retry_after_s)))
            except (TypeError, ValueError):
                pass
        rec["not_before"] = now + hint
        self.pending.append(rec)

    def resolve(self, rec: dict, state: str) -> None:
        """Terminal-state a stranded record without re-dispatching it
        (deadline spent while stranded -> ``expired``)."""
        self._redispatched.pop(int(rec["rid"]), None)
        if state == "expired":
            _monitor.inc("serving.failover.expired",
                         doc="stranded requests whose deadline was "
                             "already spent at re-dispatch time")
        self._finish(rec, state)

    def note_result(self, rid: int, state: str) -> None:
        """A re-dispatched request reached a terminal engine state on
        its survivor (the replay harvest observed the output)."""
        rec = self._redispatched.pop(int(rid), None)
        if rec is None:
            return
        if state == "completed":
            self.counters["recovered"] += 1
            _monitor.inc("serving.failover.recovered",
                         doc="stranded requests that COMPLETED on a "
                             "surviving replica after re-dispatch")

    def outstanding(self) -> int:
        return len(self.pending)

    # -- circuit breakers ---------------------------------------------------

    def _breaker(self, replica: str) -> CircuitBreaker:
        b = self.breakers.get(replica)
        if b is None:
            b = CircuitBreaker(self._breaker_threshold,
                               self._breaker_cooldown)
            self.breakers[replica] = b
        return b

    def pick_replica(self, live: List[str], rid: int,
                     now: float = 0.0) -> Optional[str]:
        """Deterministic rid-keyed routing over breaker-admissible
        replicas; falls back to ALL live replicas when every breaker
        is open (routing away from everyone is routing to no one)."""
        if not live:
            return None
        adm = [n for n in live if self._breaker(n).allows(now)]
        if not adm:
            adm = list(live)
        name = adm[int(rid) % len(adm)]
        self._breaker(name).note_probe()
        return name

    def admission_result(self, replica: str, ok: bool,
                         now: float = 0.0) -> None:
        """Feed one fresh-admission outcome to ``replica``'s breaker
        (sheds only — a malformed-request rejection says nothing about
        the replica's health and must be fed as neither)."""
        b = self._breaker(replica)
        before = b.state
        b.record(ok, now)
        if b.state != before:
            if b.state == "open":
                _monitor.inc("serving.failover.breaker.opened",
                             doc="circuit-breaker trips: a replica "
                                 "whose fresh admissions keep "
                                 "shedding routes new work away for "
                                 "a cooldown")
            elif b.state == "closed":
                _monitor.inc("serving.failover.breaker.closed",
                             doc="half-open probes that succeeded and "
                                 "closed the breaker")
            _trace.instant("serving.failover.breaker", replica=replica,
                           state=b.state)
            _forensics.decision("breaker", replica=replica,
                                state=b.state, failures=b.failures)
        _monitor.set_gauge(
            "serving.failover.breaker.open",
            sum(1 for x in self.breakers.values()
                if x.state != "closed"),
            doc="replicas currently open or half-open")

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> dict:
        by_state: Dict[str, int] = {}
        for rec in self.terminal.values():
            s = rec.get("state", "unknown")
            by_state[s] = by_state.get(s, 0) + 1
        return {"pending": len(self.pending),
                "inflight_redispatch": len(self._redispatched),
                "counters": dict(self.counters),
                "quarantined_hashes": len(self.quarantined_hashes),
                "terminal_by_state": by_state,
                "breakers": {n: b.as_dict()
                             for n, b in sorted(self.breakers.items())}}


def rebuild_request(rec: dict, vocab: int, deadline_s: Optional[float]):
    """Reconstruct a journaled request for re-dispatch (the port's copy of
    ``paddle_tpu/loadgen/replay.py``'s ``_rebuild_request``): the prompt
    from its derivation spec (``loadgen.traces._trace_prompt``) or inline
    tokens, the PINNED sampling seed (the same tokens on a survivor of
    the same device), the remaining deadline, and the attempt / lineage
    bookkeeping the journal re-records on the survivor. Returns None for
    a record too damaged to rebuild."""
    from ..loadgen.traces import _trace_prompt
    from .engine import Request
    spec = rec.get("prompt_spec")
    try:
        if spec:
            prompt = _trace_prompt(
                int(spec["seed"]), int(spec["rid"]),
                int(spec["prompt_len"]), int(spec.get("vocab", vocab)),
                str(spec.get("tenant", rec.get("tenant", "default"))),
                int(spec.get("prefix_len", 0) or 0))
        elif rec.get("prompt") is not None:
            prompt = np.asarray(rec["prompt"], np.int32)
        else:
            return None
        seed = rec.get("seed")
        req = Request(
            rid=int(rec["rid"]), prompt=prompt,
            max_new_tokens=int(rec["max_new_tokens"]),
            temperature=float(rec.get("temperature", 0.0) or 0.0),
            seed=None if seed is None else int(seed),
            tenant=str(rec.get("tenant", "default")),
            priority=int(rec.get("priority", 0) or 0),
            deadline_s=deadline_s,
            prompt_spec=dict(spec) if spec else None)
    except (KeyError, TypeError, ValueError):
        return None
    req._failover_attempts = int(rec.get("attempts", 0))
    req._recovered_from = list(rec.get("recovered_from") or [])
    return req


# -- active-coordinator registry ---------------------------------------------

_ACTIVE_COORD = None


def set_active_coordinator(coord: Optional[FailoverCoordinator]) -> None:
    """Register the live coordinator for the monitor planes (weakref —
    the controller owns its lifetime; a reader must never extend
    it)."""
    global _ACTIVE_COORD
    _ACTIVE_COORD = None if coord is None else weakref.ref(coord)


def active_coordinator() -> Optional[FailoverCoordinator]:
    ref = _ACTIVE_COORD
    return ref() if ref is not None else None
