"""Open-loop trace replay through the serving engine or a fleet (port of
``paddle_tpu/loadgen/replay.py``).

The replay driver is OPEN-LOOP (arrivals follow the trace, never the
engine's completion rate — the load generator a slow engine cannot
slow down, which is what makes goodput-vs-offered-load an honest
number) and runs on a VIRTUAL clock: virtual time advances a fixed
``dt_per_step`` per engine step, so a trace spanning minutes of
virtual arrivals replays in however long the decode steps take.
Submission order and episode firing are therefore pure functions of
(trace, dt_per_step, episodes) — with the engine's timing policies
(burn shedding, deadlines) left off, two replays of the same seed
produce IDENTICAL terminal states and token counts. Wall-clock latency
measurements still happen (the engine stamps real TTFT/TPOT/e2e with
the monitor on); they are quarantined in the scorecard's ``timing``
block.

Scripted episodes (:class:`Episode`):

- ``burst``  — inject ``n_requests`` extra best-effort submissions the
  moment virtual time passes ``at_s`` (deterministic overload: drives
  the bounded queue / priority admission into shedding);
- ``drain``  — ``engine.begin_drain()`` at ``at_s`` (single engine) or
  drain one replica (fleet);
- ``kill``   — fleet only (:func:`replay_fleet`): crash a replica via
  ``testing/faults.py`` (the ``loadgen.replica.<name>.step`` injection
  point), leaving its in-flight requests to be reported ``lost`` and
  the elastic controller (``distributed/fleet/elastic.py``) to detect
  the stale heartbeat and replace it. With exactly-once failover on
  (``replay_fleet(failover=True)`` / ``FLAGS_serving_failover``), the
  stranded requests are instead re-dispatched from the victim's
  admission journal through normal admission on survivors
  (``inference/failover.py``) and end
  ``completed``/``expired``/``shed``/``quarantined`` with a
  ``recovered_from`` lineage; ``lost`` then means the durability layer
  itself failed.

Every submitted request ends in exactly one typed terminal state:
``completed | expired | shed | rejected | lost`` (plus ``quarantined``
under failover) — ``shed`` carries the
engine's typed reason and ``retry_after_s`` hint whether it was refused
at submit (:class:`EngineOverloaded`) or displaced/drained out of the
queue (``RequestOutput.finish_reason == "shed"``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from .. import monitor as _monitor
from ..monitor import forensics as _forensics
from ..testing import faults as _faults
from .traces import ArrivalTrace, TraceRequest, _trace_prompt, prompt_tokens

__all__ = ["Episode", "ReplayResult", "replay_trace", "replay_fleet",
           "BURST_RID_BASE"]

# burst-episode injections get rids far above any trace rid so the two
# populations never collide and stay trivially separable in the verdict
BURST_RID_BASE = 1_000_000


@dataclasses.dataclass
class Episode:
    """One scripted event at virtual time ``at_s``. ``kind`` is
    ``burst`` (inject ``n_requests`` extra priority-0 submissions,
    tenant ``"burst"``), ``drain`` (begin the engine/replica drain
    lifecycle), or ``kill`` (fleet only: crash ``replica`` — default
    the newest — through the fault-injection layer)."""

    kind: str
    at_s: float
    n_requests: int = 8
    replica: Optional[str] = None

    def __post_init__(self):
        if self.kind not in ("burst", "drain", "kill"):
            raise ValueError(f"unknown episode kind {self.kind!r} "
                             "(want burst|drain|kill)")


@dataclasses.dataclass
class ReplayResult:
    """Everything the scorecard folds: the trace, the per-request
    terminal map, episode markers, per-engine stats, and the (few,
    quarantined) wall-clock measurements."""

    trace: ArrivalTrace
    # rid -> {state, tenant, tokens, prompt_len, reason?,
    #         retry_after_s?, replica?, episode?}
    terminal: Dict[int, dict]
    episodes: List[dict]
    engine_stats: Dict[str, dict]       # replica name -> stats dict
    engine_flags: dict
    steps: int
    dt_per_step: float
    wall_s: float
    offered: int = 0                    # trace + burst submissions
    offered_tokens: int = 0             # sum of their max_new_tokens
    fleet_events: Optional[list] = None
    failover: Optional[dict] = None     # coordinator snapshot (fleet
    #                                     replays with failover on)
    # wall-clock latency samples (ms) per request from the engine cost
    # records — timing-plane data the scorecard quarantines
    latency_samples: Dict[str, list] = dataclasses.field(
        default_factory=dict)

    def terminal_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.terminal.values():
            out[rec["state"]] = out.get(rec["state"], 0) + 1
        return out

    def useful_tokens(self) -> int:
        return sum(r["tokens"] for r in self.terminal.values()
                   if r["state"] == "completed")


def _engine_flags(eng) -> dict:
    """The overload-policy knobs that participate in the determinism
    contract (same seed + same flags ⇒ same terminal states)."""
    return {
        "priority_admission": bool(getattr(eng, "_priority_admission",
                                           False)),
        "max_queue": int(getattr(eng, "_max_queue", 0) or 0),
        "tenant_inflight_cap": int(getattr(eng, "_tenant_cap", 0) or 0),
        "shed_on_burn": bool(getattr(eng, "_shed_on_burn", False)),
        "slo_preemption": bool(getattr(eng, "_slo_preemption", False)),
        "failover": bool(getattr(eng, "_failover", False)),
        "prefix_cache": bool(getattr(eng, "_prefix", None) is not None),
        "spec_decode": bool(getattr(eng, "_spec_decode", False)),
        "num_slots": int(getattr(eng, "num_slots", 0)),
    }


def _mk_request(tr: TraceRequest, seed: int, vocab_size: int,
                honor_deadlines: bool):
    from ..inference.engine import Request
    pfx = int(getattr(tr, "prefix_len", 0) or 0)
    return Request(
        rid=tr.rid,
        prompt=_trace_prompt(seed, tr.rid, tr.prompt_len, vocab_size,
                             tr.tenant, pfx),
        max_new_tokens=tr.max_new_tokens, tenant=tr.tenant,
        priority=tr.priority,
        deadline_s=tr.deadline_s if honor_deadlines else None,
        # derivation spec for the admission journal: a failover
        # re-dispatch rebuilds the exact prompt as a pure function
        # (``inference.failover.rebuild_request``) instead of journaling
        # inline tokens (inert without a journal)
        prompt_spec={"seed": int(seed), "rid": int(tr.rid),
                     "prompt_len": int(tr.prompt_len),
                     "vocab": int(vocab_size),
                     "tenant": str(tr.tenant),
                     "prefix_len": pfx})


def _submit(eng, req, terminal: Dict[int, dict], tenant: str,
            episode: Optional[str] = None, coord=None,
            replica: Optional[str] = None, now: float = 0.0) -> bool:
    """Submit one request, folding a typed refusal into the terminal
    map. Returns True when the request ENTERED the engine (its
    terminal state will come from ``eng.outputs``). With a failover
    coordinator, the outcome feeds ``replica``'s circuit breaker —
    sheds only; a malformed-request rejection says nothing about the
    replica's health."""
    from ..inference.engine import EngineOverloaded, RequestRejected
    rec = {"state": None, "tenant": tenant,
           "prompt_len": int(np.asarray(req.prompt).shape[0]),
           "tokens": 0}
    if episode:
        rec["episode"] = episode
    try:
        eng.submit(req)
    except EngineOverloaded as e:
        rec.update(state="shed", reason=e.reason,
                   retry_after_s=e.retry_after_s)
        terminal[req.rid] = rec
        if coord is not None and replica is not None:
            coord.admission_result(replica, False, now)
        return False
    except RequestRejected as e:
        rec.update(state="rejected", reason=e.reason)
        terminal[req.rid] = rec
        return False
    if coord is not None and replica is not None:
        coord.admission_result(replica, True, now)
    return True


def _fold_failover_terminal(terminal: Dict[int, dict], rec: dict):
    """Fold a coordinator terminal record (quarantined, expired while
    stranded, attempts-exhausted shed) into the replay map — only over
    a missing or still-open record; a harvested engine output always
    wins."""
    rid = int(rec["rid"])
    t = terminal.get(rid)
    if t is not None and t.get("state") is not None:
        return
    spec = rec.get("prompt_spec") or {}
    plen = spec.get("prompt_len")
    if plen is None:
        plen = len(rec.get("prompt") or ())
    t = t or {}
    t.update(state=rec["state"],
             tenant=rec.get("tenant", "unknown"),
             prompt_len=int(plen or 0),
             tokens=int(t.get("tokens", 0) or 0),
             recovered_from=list(rec.get("recovered_from") or []),
             failover_attempts=int(rec.get("attempts", 0)))
    terminal[rid] = t


def _burst_requests(trace: ArrivalTrace, ep: Episode, idx: int,
                    vocab_size: int):
    """Deterministic burst payload: lengths drawn from a seed derived
    from (trace seed, episode index) — independent of how much of the
    trace rng was consumed."""
    from ..inference.engine import Request
    rng = np.random.default_rng([trace.seed & 0x7FFFFFFF, 7919, idx])
    cfgp = trace.config.get("prompt_len") or [4, 16]
    cfgg = trace.config.get("max_new_tokens") or [4, 16]
    reqs = []
    for i in range(ep.n_requests):
        rid = BURST_RID_BASE + idx * 10_000 + i
        plen = int(rng.integers(cfgp[0], cfgp[1] + 1))
        glen = int(rng.integers(cfgg[0], cfgg[1] + 1))
        reqs.append(Request(
            rid=rid,
            prompt=prompt_tokens(trace.seed, rid, plen, vocab_size),
            max_new_tokens=glen, tenant="burst", priority=0,
            prompt_spec={"seed": int(trace.seed), "rid": int(rid),
                         "prompt_len": int(plen),
                         "vocab": int(vocab_size)}))
    return reqs


def _harvest(eng, terminal: Dict[int, dict], rids, replica=None,
             latency: Optional[Dict[str, list]] = None):
    """Fold the outputs of THIS replay's rids into the terminal map
    (idempotent — a rid already folded keeps its first record; outputs
    from a warmup pass or an earlier replay on the same engine are
    invisible). ``latency`` collects per-request wall-clock samples
    from the cost records (monitor on) for the scorecard's quarantined
    timing block."""
    for rid in rids:
        out = eng.outputs.get(rid)
        if out is None:
            continue
        if rid in terminal and terminal[rid].get("state") is not None:
            continue
        rec = terminal.get(rid) or {"tenant": out.tenant,
                                    "prompt_len": out.prompt_len}
        rec.update(state=out.finish_reason,
                   tokens=int(np.asarray(out.tokens).shape[0]),
                   preemptions=out.preemptions)
        if out.finish_reason == "shed":
            rec["retry_after_s"] = out.retry_after_s
            if getattr(out, "shed_reason", None):
                rec["reason"] = out.shed_reason
        if replica is not None:
            rec["replica"] = replica
        terminal[rid] = rec
        if latency is not None and out.cost is not None:
            for k in ("queue_wait_ms", "ttft_ms", "tpot_ms", "e2e_ms"):
                v = getattr(out.cost, k, None)
                if v is not None:
                    latency.setdefault(k, []).append(round(float(v),
                                                           3))


def _count_metrics(result: "ReplayResult"):
    if not _monitor.enabled():
        return
    counts = result.terminal_counts()
    _monitor.inc("loadgen.replay.offered", result.offered,
                 doc="requests a trace replay offered the engine/fleet")
    for state in ("completed", "shed", "expired", "rejected", "lost",
                  "quarantined"):
        if counts.get(state):
            _monitor.inc(f"loadgen.replay.{state}", counts[state])
    _monitor.inc("loadgen.replay.tokens.useful",
                 result.useful_tokens(),
                 doc="decode tokens completed requests kept across "
                     "trace replays")


def replay_trace(eng, trace: ArrivalTrace, *,
                 dt_per_step: float = 0.01,
                 episodes: List[Episode] = (),
                 honor_deadlines: bool = False,
                 max_steps: int = 200_000) -> ReplayResult:
    """Replay ``trace`` through one live :class:`ServingEngine`.

    Virtual time starts at 0 and advances ``dt_per_step`` per engine
    step; a request is submitted the first step its ``arrival_s`` has
    passed, episodes fire the same way. ``honor_deadlines=False`` (the
    default) strips per-request ``deadline_s`` so terminal states stay
    a pure function of the virtual schedule — flip it on to exercise
    real TTL expiry (wall-clock-dependent). ``kill`` episodes need a
    fleet — use :func:`replay_fleet`."""
    for ep in episodes:
        if ep.kind == "kill":
            raise ValueError("kill episodes need replay_fleet "
                             "(a single engine has nothing to fail "
                             "over to)")
    vocab = int(eng.config.vocab_size)
    pending = sorted(trace.requests, key=lambda r: (r.arrival_s, r.rid))
    eps = sorted(enumerate(episodes), key=lambda e: e[1].at_s)
    terminal: Dict[int, dict] = {}
    ep_log: List[dict] = []
    entered: set = set()
    offered, offered_tok = 0, 0
    vnow, steps = 0.0, 0
    t0 = time.perf_counter()
    while True:
        while pending and pending[0].arrival_s <= vnow:
            tr = pending.pop(0)
            offered += 1
            offered_tok += tr.max_new_tokens
            if _submit(eng, _mk_request(tr, trace.seed, vocab,
                                        honor_deadlines),
                       terminal, tr.tenant):
                entered.add(tr.rid)
        while eps and eps[0][1].at_s <= vnow:
            idx, ep = eps.pop(0)
            mark = {"kind": ep.kind, "at_s": ep.at_s, "step": steps,
                    "index": idx}
            if ep.kind == "burst":
                reqs = _burst_requests(trace, ep, idx, vocab)
                offered += len(reqs)
                offered_tok += sum(r.max_new_tokens for r in reqs)
                n_in = 0
                for r in reqs:
                    if _submit(eng, r, terminal, "burst",
                               episode="burst"):
                        entered.add(r.rid)
                        n_in += 1
                mark.update(n_requests=len(reqs), admitted=n_in)
            elif ep.kind == "drain":
                eng.begin_drain()
            mark["slo"] = _slo_probe()
            ep_log.append(mark)
        _faults.hit("loadgen.replay.step")
        active = eng.step()
        steps += 1
        vnow += dt_per_step
        if not active and not pending and not eps:
            break
        if steps >= max_steps:
            raise RuntimeError(
                f"replay did not drain within {max_steps} steps "
                f"({len(pending)} arrivals pending)")
    lat: Dict[str, list] = {}
    _harvest(eng, terminal, entered, latency=lat)
    for rid in entered:
        if rid not in terminal or terminal[rid].get("state") is None:
            # entered the engine but never retired — a contract
            # violation the scorecard verdict must surface, not hide
            rec = terminal.get(rid) or {"tenant": "unknown",
                                        "prompt_len": 0}
            rec.update(state="lost", tokens=rec.get("tokens", 0))
            terminal[rid] = rec
            _forensics.note_terminal(rid, "lost",
                                     tenant=rec.get("tenant"))
    result = ReplayResult(
        trace=trace, terminal=terminal, episodes=ep_log,
        engine_stats={"engine0": eng.stats.as_dict()},
        engine_flags=_engine_flags(eng), steps=steps,
        dt_per_step=dt_per_step,
        wall_s=round(time.perf_counter() - t0, 6), offered=offered,
        offered_tokens=offered_tok, latency_samples=lat)
    _count_metrics(result)
    return result


def _slo_probe() -> Optional[dict]:
    """A small episode-local SLO snapshot (burn + compliance per
    objective) — timing-plane data, quarantined by the scorecard."""
    if not _monitor.enabled():
        return None
    try:
        from ..monitor import slo as _slo
        rep = _slo.compliance_report()
        return {k: {"compliance": v.get("compliance"),
                    "burn_fast": v.get("burn_fast")}
                for k, v in rep.get("objectives", {}).items()
                if v.get("compliance") is not None}
    except Exception:
        return None


def replay_fleet(make_engine, trace: ArrivalTrace, *,
                 replicas: int = 2, max_replicas: Optional[int] = None,
                 episodes: List[Episode] = (),
                 dt_per_tick: float = 0.05, steps_per_tick: int = 2,
                 heartbeat_dir: Optional[str] = None,
                 heartbeat_timeout: float = 0.0,
                 poll_interval: float = 0.005,
                 honor_deadlines: bool = False,
                 max_ticks: int = 50_000,
                 failover: Optional[bool] = None,
                 manager=None) -> ReplayResult:
    """Replay ``trace`` through a multi-replica fleet driven by
    :meth:`AdaptiveElasticManager.run_serving`.

    ``make_engine(name) -> ServingEngine`` builds each replica; the
    replay pump rides the controller's ``on_tick`` hook (submission,
    episode firing and engine stepping all happen on the controller
    thread, ordered with its spawn/stop decisions — no feeder-thread
    races). Requests route round-robin over live replicas by rid.
    A ``kill`` episode arms the ``loadgen.replica.<name>.step``
    injection point (``testing/faults.py``): the pump stops stepping
    the victim, its heartbeat goes stale, the controller force-stops
    and replaces it, and its in-flight requests are reported with
    terminal state ``lost``. Requires ``heartbeat_dir`` +
    ``heartbeat_timeout > 0`` for kill episodes to heal.

    ``failover`` (default ``FLAGS_serving_failover``, off): each
    spawned replica attaches an admission journal under its heartbeat
    name, fresh submissions route through the controller coordinator's
    circuit breakers and feed them their outcomes, and the pump drains
    the coordinator's re-dispatch queue — work stranded by a kill is
    resubmitted through normal admission on survivors (remaining
    deadline carried when ``honor_deadlines``, bounded attempts,
    capped ``retry_after_s`` backoff riding the VIRTUAL clock) and
    ends in exactly one terminal state with a ``recovered_from``
    lineage plus a timing-plane per-request ``recovery_s``."""
    import threading

    from ..distributed.fleet.elastic import AdaptiveElasticManager
    from ..inference import failover as _fo

    for ep in episodes:
        if ep.kind == "kill" and not (heartbeat_dir
                                      and heartbeat_timeout > 0):
            raise ValueError("kill episodes need heartbeat_dir and "
                             "heartbeat_timeout > 0 so the controller "
                             "can detect and replace the victim")
    vocab = None
    mgr = manager or AdaptiveElasticManager()
    from ..core import flags as _cflags
    failover_on = bool(_cflags.flag_value("serving_failover")
                       if failover is None else failover)
    engines: Dict[str, object] = {}     # every engine ever spawned
    crashed: set = set()
    assigned: Dict[str, set] = {}       # replica -> rids submitted
    terminal: Dict[int, dict] = {}
    ep_log: List[dict] = []
    pending = sorted(trace.requests, key=lambda r: (r.arrival_s, r.rid))
    eps = sorted(enumerate(episodes), key=lambda e: e[1].at_s)
    state = {"vnow": 0.0, "offered": 0, "offered_tokens": 0,
             "steps": 0}
    armed_points: set = set()
    # failover bookkeeping: rid -> (survivor name, journal record) for
    # re-dispatched requests whose terminal output the pump polls (it
    # stamps the timing-plane recovery_s and tells the coordinator)
    redisp: Dict[int, tuple] = {}
    arrival_by_rid = ({r.rid: r.arrival_s for r in trace.requests}
                      if failover_on and honor_deadlines else {})
    done = threading.Event()
    t0 = time.perf_counter()

    def spawn(name):
        eng = make_engine(name)
        if heartbeat_dir:
            eng.publish_frames(name, heartbeat_dir, min_interval_s=0.0)
        else:
            eng.publish_frames(name, local_only=True)
        if failover_on and hasattr(eng, "attach_journal"):
            # durable admission journal under the replica's heartbeat
            # name (requires the engine's own failover switch — an
            # engine built flags-off declines and work stays `lost`)
            eng.attach_journal(name, heartbeat_dir)
        engines[name] = eng
        assigned.setdefault(name, set())
        return eng

    def stop(name, handle):
        # controller-ordered retirement (drain completed or stale
        # replace); outputs stay harvestable on the engine object
        pass

    def on_tick(ticks, live_replicas):
        nonlocal vocab
        live = [n for n in sorted(live_replicas) if n not in crashed]
        if vocab is None and live:
            vocab = int(engines[live[0]].config.vocab_size)
        coord = (getattr(mgr, "failover_coordinator", None)
                 if failover_on else None)
        if coord is not None and not state.get("clocked"):
            # the coordinator's backoff/due stamps ride the replay's
            # VIRTUAL clock: deterministic in virtual seconds
            coord.clock = lambda: state["vnow"]
            state["clocked"] = True
        if crashed and not state.get("recovered") and any(
                n not in state.get("pre_kill", ()) for n in live):
            # first replacement spawned after a crash: the recovery
            # marker the scorecard diffs against the kill stamp
            state["recovered"] = True
            ep_log.append({"kind": "recovered", "tick": ticks,
                           "wall_s": round(
                               time.perf_counter() - t0, 6)})
        vnow = state["vnow"]
        # episodes first: a burst lands before this tick's arrivals
        while eps and eps[0][1].at_s <= vnow:
            idx, ep = eps.pop(0)
            mark = {"kind": ep.kind, "at_s": ep.at_s,
                    "tick": ticks, "index": idx,
                    "wall_s": round(time.perf_counter() - t0, 6)}
            if ep.kind == "burst" and live:
                reqs = _burst_requests(trace, ep, idx, vocab)
                state["offered"] += len(reqs)
                state["offered_tokens"] += sum(r.max_new_tokens
                                               for r in reqs)
                for i, r in enumerate(reqs):
                    if coord is not None:
                        name = coord.pick_replica(live, i, now=vnow)
                    else:
                        name = live[i % len(live)]
                    if _submit(engines[name], r, terminal, "burst",
                               episode="burst", coord=coord,
                               replica=name, now=vnow):
                        assigned[name].add(r.rid)
                mark["n_requests"] = len(reqs)
            elif ep.kind == "drain" and live:
                victim = ep.replica or live[-1]
                engines[victim].begin_drain()
                mark["replica"] = victim
            elif ep.kind == "kill" and live:
                victim = ep.replica or live[-1]
                state["pre_kill"] = set(live)
                point = f"loadgen.replica.{victim}.step"
                _faults.inject(point, action="raise")
                armed_points.add(point)
                mark["replica"] = victim
            mark["slo"] = _slo_probe()
            ep_log.append(mark)
        while pending and pending[0].arrival_s <= vnow and live:
            tr = pending.pop(0)
            state["offered"] += 1
            state["offered_tokens"] += tr.max_new_tokens
            if coord is not None:
                name = coord.pick_replica(live, tr.rid, now=vnow)
            else:
                name = live[tr.rid % len(live)]
            if _submit(engines[name],
                       _mk_request(tr, trace.seed, vocab,
                                   honor_deadlines),
                       terminal, tr.tenant, coord=coord,
                       replica=name, now=vnow):
                assigned[name].add(tr.rid)
        if coord is not None and live:
            # drain the re-dispatch queue: stranded journal records
            # whose backoff elapsed re-enter NORMAL admission on a
            # breaker-admissible survivor
            for rec in coord.due(vnow):
                rid = int(rec["rid"])
                deadline = None
                if honor_deadlines and rec.get("deadline_s") is not None:
                    arr = arrival_by_rid.get(rid)
                    spent = (vnow - arr) if arr is not None else 0.0
                    deadline = float(rec["deadline_s"]) - spent
                    if deadline <= 0.0:
                        # the TTL was spent while stranded: typed
                        # expired, never re-dispatched past its budget
                        coord.resolve(rec, "expired")
                        _fold_failover_terminal(terminal,
                                                coord.terminal[rid])
                        continue
                req = _fo.rebuild_request(rec, vocab, deadline)
                if req is None:
                    coord.resolve(rec, "shed")
                    _fold_failover_terminal(terminal,
                                            coord.terminal[rid])
                    continue
                name = coord.pick_replica(live, rid, now=vnow)
                from ..inference.engine import (EngineOverloaded,
                                                RequestRejected)
                try:
                    engines[name].submit(req)
                except EngineOverloaded as e:
                    coord.admission_result(name, False, vnow)
                    coord.requeue(rec, vnow,
                                  retry_after_s=e.retry_after_s)
                    if rid in coord.terminal:
                        _fold_failover_terminal(terminal,
                                                coord.terminal[rid])
                    continue
                except RequestRejected:
                    coord.resolve(rec, "shed")
                    _fold_failover_terminal(terminal,
                                            coord.terminal[rid])
                    continue
                coord.admission_result(name, True, vnow)
                coord.redispatched(rec, name, vnow)
                assigned[name].add(rid)
                redisp[rid] = (name, rec)
                # placeholder terminal record: _harvest folds the
                # survivor's finish onto it, keeping the lineage
                prev = terminal.get(rid) or {}
                terminal[rid] = dict(
                    prev, state=None,
                    tenant=rec.get("tenant", "unknown"),
                    prompt_len=int(np.asarray(req.prompt).shape[0]),
                    tokens=0,
                    recovered_from=list(rec.get("recovered_from")
                                        or []),
                    failover_attempts=int(rec.get("attempts", 0)))
        for name in live:
            eng = engines[name]
            try:
                _faults.hit(f"loadgen.replica.{name}.step")
                for _ in range(steps_per_tick):
                    eng.step()
            except _faults.FaultInjected:
                # the scripted crash: stop stepping/publishing — the
                # replica's heartbeat goes stale and the controller
                # replaces it; its in-flight work is lost
                crashed.add(name)
                _faults.clear(f"loadgen.replica.{name}.step")
                if coord is not None:
                    # exactly-once accounting: tokens the victim had
                    # generated for still-in-flight slots die with it
                    # (the survivor regenerates from scratch), so they
                    # are discarded — same contract as the preemption
                    # recompute path — keeping token conservation
                    # checkable even though nothing ends up `lost`
                    for slot in eng.slots:
                        if slot is not None:
                            eng.stats.tokens_discarded += slot.gen
                ep_log.append({"kind": "killed", "replica": name,
                               "tick": ticks,
                               "wall_s": round(
                                   time.perf_counter() - t0, 6)})
        if coord is not None and redisp:
            # poll re-dispatched rids for their survivor-side finish:
            # stamps the timing-plane recovery_s (kill -> terminal,
            # wall seconds) and settles the coordinator's bookkeeping
            for rid in list(redisp):
                name, rec = redisp[rid]
                if name in crashed:
                    # the survivor died too — note_replaced re-strands
                    # this rid from ITS journal on the next strand
                    del redisp[rid]
                    continue
                out = engines[name].outputs.get(rid)
                if out is None:
                    continue
                coord.note_result(rid, out.finish_reason)
                t = terminal.get(rid)
                if t is not None and rec.get("_t_strand_wall"):
                    t["recovery_s"] = round(
                        time.perf_counter() - rec["_t_strand_wall"], 6)
                del redisp[rid]
        state["steps"] += steps_per_tick
        state["vnow"] = vnow + dt_per_tick
        # with failover on, a crashed replica the controller still
        # tracks is stranded work the coordinator has not seen yet:
        # keep the loop alive through staleness detection, the journal
        # consume, and the re-dispatch drain — otherwise the replay
        # exits the moment the SURVIVORS go idle and the durability
        # layer never gets its tick
        settling = coord is not None and (
            any(n in live_replicas for n in crashed)
            or coord.outstanding() or bool(redisp))
        if not pending and not eps and not settling:
            idle = all(
                not engines[n].queue and
                all(s is None for s in engines[n].slots)
                for n in live)
            if idle and live:
                done.set()

    summary = None
    try:
        summary = mgr.run_serving(
            spawn, stop, min_replicas=replicas,
            max_replicas=max_replicas or replicas + 1,
            poll_interval=poll_interval, heartbeat_dir=heartbeat_dir,
            heartbeat_timeout=heartbeat_timeout, max_ticks=max_ticks,
            stop_event=done, failover=failover_on, on_tick=on_tick)
    finally:
        # a kill fault the victim never hit (it was replaced first)
        # must not stay armed past this replay
        for point in armed_points:
            _faults.clear(point)
    lat: Dict[str, list] = {}
    for name, eng in engines.items():
        _harvest(eng, terminal, assigned.get(name, ()), replica=name,
                 latency=lat)
    coord = (getattr(mgr, "failover_coordinator", None)
             if failover_on else None)
    if coord is not None:
        # coordinator-typed terminals (quarantined, expired while
        # stranded, attempts-exhausted shed) land BEFORE the lost
        # typing below — a stranded request the durability layer
        # settled is never `lost`
        for rec in coord.terminal.values():
            _fold_failover_terminal(terminal, rec)
    # in-flight work that never retired — on a crashed replica OR one
    # the controller force-stopped/replaced mid-request — is typed
    # ``lost``: the crash-visibility state the kill episode exists to
    # surface, never a silent accounting hole (with failover on it
    # means the durability layer itself failed, e.g. an unjournaled
    # engine or a journal the transport dropped)
    for name, rids in assigned.items():
        for rid in rids:
            rec = terminal.get(rid)
            if rec is None or rec.get("state") is None:
                rec = rec or {"tenant": "unknown", "prompt_len": 0}
                rec.update(state="lost", tokens=rec.get("tokens", 0),
                           replica=name)
                terminal[rid] = rec
                _forensics.note_terminal(rid, "lost",
                                         tenant=rec.get("tenant"),
                                         replica=name)
    for rid, rec in terminal.items():
        if rec["state"] is None:
            rec["state"] = "lost"
    result = ReplayResult(
        trace=trace, terminal=terminal, episodes=ep_log,
        engine_stats={n: e.stats.as_dict()
                      for n, e in engines.items()},
        engine_flags=(_engine_flags(next(iter(engines.values())))
                      if engines else {}),
        steps=state["steps"], dt_per_step=dt_per_tick,
        wall_s=round(time.perf_counter() - t0, 6),
        offered=state["offered"],
        offered_tokens=state["offered_tokens"],
        fleet_events=list(mgr.events), latency_samples=lat,
        failover=((summary or {}).get("failover")
                  if summary and summary.get("failover") is not None
                  else (coord.snapshot() if coord is not None
                        else None)))
    _count_metrics(result)
    return result
