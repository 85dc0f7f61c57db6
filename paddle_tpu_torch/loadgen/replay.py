"""Open-loop trace replay through one serving engine (port of the
single-engine half of ``paddle_tpu/loadgen/replay.py``).

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
- ``drain``  — ``engine.begin_drain()`` at ``at_s``;
- ``kill``   — a fleet episode (crash a replica); the fleet replay
  (``replay_fleet``, with the elastic controller and failover
  re-dispatch) is ROADMAP A7(d), so :func:`replay_trace` refuses it.

Every submitted request ends in exactly one typed terminal state:
``completed | expired | shed | rejected | lost`` — ``shed`` carries the
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

__all__ = ["Episode", "ReplayResult", "replay_trace", "BURST_RID_BASE"]

# burst-episode injections get rids far above any trace rid so the two
# populations never collide and stay trivially separable in the verdict
BURST_RID_BASE = 1_000_000


@dataclasses.dataclass
class Episode:
    """One scripted event at virtual time ``at_s``. ``kind`` is
    ``burst`` (inject ``n_requests`` extra priority-0 submissions,
    tenant ``"burst"``), ``drain`` (begin the engine's drain lifecycle),
    or ``kill`` (a fleet episode: crash ``replica``)."""

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
    failover: Optional[dict] = None     # fleet replays only
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
            episode: Optional[str] = None) -> bool:
    """Submit one request, folding a typed refusal into the terminal
    map. Returns True when the request ENTERED the engine (its
    terminal state will come from ``eng.outputs``)."""
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
        return False
    except RequestRejected as e:
        rec.update(state="rejected", reason=e.reason)
        terminal[req.rid] = rec
        return False
    return True


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
    fleet, which is not ported yet (ROADMAP A7(d))."""
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
