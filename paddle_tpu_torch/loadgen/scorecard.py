"""SLO scorecard: one JSON verdict per trace replay (a copy of
``paddle_tpu/loadgen/scorecard.py``).

The scorecard folds everything the observability plane already
records — per-request terminal states and token counts from the
replay driver, TTFT/TPOT/e2e/queue-wait histograms and per-tenant
burn rates from ``monitor/slo.py`` — into a single document with a
hard separation:

- ``deterministic``: pure functions of (trace seed, engine flags,
  virtual schedule) — terminal-state counts, typed shed reasons,
  token accounting, goodput vs offered load, per-tenant fairness,
  episode admission counts. Two same-seed replays must produce
  byte-identical content here; the determinism tests diff exactly
  this block.
- ``timing``: everything stamped from the wall clock — latency
  quantiles, burn rates, episode-local SLO probes, fleet frames,
  wall seconds. Quarantined so nondeterminism never leaks into the
  deterministic contract. The fleet block reads federated frames
  (``monitor/federation.py``, ROADMAP A7(d)); until federation is
  ported it is ``{"available": False}``, the reference's answer when no
  frame was published.
- ``verdict``: pass/fail with typed reasons — every request in
  exactly one terminal state, the token conservation contract, shed
  requests carrying retry hints, no ``lost`` work outside a scripted
  kill episode.

The most recent scorecard is kept module-global (bounded: one); the
reference serves it at ``GET /scorecard``.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from .. import monitor as _monitor
from .replay import ReplayResult

__all__ = ["build_scorecard", "last_scorecard", "set_last_scorecard",
           "reset"]

SCORECARD_VERSION = 1

_LAST = [None]      # type: list


def _shed_reason_type(reason: Optional[str]) -> str:
    """Collapse the engine's free-text shed reason onto the typed
    policy that produced it (the reasons are engine-authored strings,
    so substring routing is stable)."""
    r = (reason or "").lower()
    if "drain" in r:
        return "draining"
    if "displaced" in r:
        return "displaced"
    if "burn" in r:
        return "slo_burn"
    if "queue full" in r:
        return "queue_full"
    return "other"


def _jain(values) -> Optional[float]:
    """Jain's fairness index over per-tenant service ratios: 1.0 =
    perfectly even, 1/n = one tenant took everything."""
    vals = [float(v) for v in values]
    if not vals:
        return None
    sq = sum(v * v for v in vals)
    if sq <= 0:
        return 1.0
    return round((sum(vals) ** 2) / (len(vals) * sq), 6)


def _latency_block(samples: Optional[Dict[str, list]] = None) -> dict:
    """Latency quantiles (wall-clock plane). Prefers the replay's own
    per-request cost samples — scoped to exactly the requests this
    replay retired — over the process-global serving histograms, which
    accumulate across every engine the process ever ran (and which
    other readers share, so a replay must never reset them)."""
    if samples:
        import numpy as np
        out = {}
        for name, vals in samples.items():
            if not vals:
                continue
            a = np.asarray(vals, dtype=float)
            out[name] = {
                "count": int(a.size),
                "p50": round(float(np.percentile(a, 50)), 3),
                "p95": round(float(np.percentile(a, 95)), 3),
                "p99": round(float(np.percentile(a, 99)), 3),
            }
        if out:
            return out
    out = {}
    try:
        reg = _monitor.registry()
        for name in ("queue_wait_ms", "ttft_ms", "tpot_ms", "e2e_ms"):
            m = reg.get(f"serving.latency.{name}")
            if m is not None and m.count:
                out[name] = {
                    "count": m.count,
                    **{k: round(v, 3) for k, v in
                       m.quantiles((0.5, 0.95, 0.99)).items()},
                }
    except Exception:
        pass
    return out


def _slo_block() -> dict:
    try:
        from ..monitor import slo as _slo
        rep = _slo.compliance_report()
        tens = _slo.tenant_compliance()
        return {
            "objectives": {
                k: {"compliance": v.get("compliance"),
                    "burn_fast": v.get("burn_fast"),
                    "burn_slow": v.get("burn_slow")}
                for k, v in rep.get("objectives", {}).items()},
            "alerting": rep.get("alerting", []),
            "per_tenant": tens,
        }
    except Exception:
        return {}


def _forensics_attribution_block() -> dict:
    """The forensics plane's wall-clock violation-cause table (timing
    plane: phase durations are real time). Empty with the monitor
    off — presence never perturbs the deterministic half."""
    try:
        from ..monitor import forensics as _forensics
        return _forensics.attribution_table()
    except Exception:
        return {}


def _fleet_block() -> dict:
    """Federated frames (``monitor/federation.py``) are not ported: no
    frame is ever published, so the block is the reference's answer for
    that case."""
    return {"available": False}


def _sum_engine_stat(result: "ReplayResult", key: str) -> int:
    return sum(int(s.get(key, 0) or 0)
               for s in result.engine_stats.values())


def _prefix_cache_block(result: "ReplayResult") -> dict:
    """Radix shared-prefix cache accounting from the engines'
    deterministic counters: hit rate over admission lookups, prompt
    tokens served from cached KV instead of prefill, and LRU nodes
    evicted under pool pressure. All-zero with the flag off."""
    lookups = _sum_engine_stat(result, "prefix_lookups")
    hits = _sum_engine_stat(result, "prefix_hits")
    return {
        "lookups": lookups,
        "hits": hits,
        "hit_rate": round(hits / lookups, 6) if lookups else None,
        "prefill_tokens_saved": _sum_engine_stat(
            result, "prefix_tokens_saved"),
        "evictions": _sum_engine_stat(result, "prefix_evictions"),
    }


def _spec_decode_block(result: "ReplayResult") -> dict:
    """Speculative-decode accounting: drafts proposed vs accepted by
    the greedy verify, per-sequence verify rounds, and the mean
    accepted run length. All-zero with the flag off."""
    rounds = _sum_engine_stat(result, "spec_rounds")
    drafted = _sum_engine_stat(result, "spec_drafted")
    accepted = _sum_engine_stat(result, "spec_accepted")
    return {
        "rounds": rounds,
        "drafted": drafted,
        "accepted": accepted,
        "acceptance_rate": round(accepted / drafted, 6)
        if drafted else None,
        "mean_accepted_run": round(accepted / rounds, 6)
        if rounds else None,
    }


def build_scorecard(result: ReplayResult, *,
                    include_fleet: bool = True) -> dict:
    """Fold one :class:`ReplayResult` into the scorecard document and
    remember it (:func:`last_scorecard`)."""
    trace = result.trace
    counts = result.terminal_counts()
    by_reason: Dict[str, int] = {}
    per_tenant: Dict[str, dict] = {}
    shed_missing_hint = 0
    useful_tokens = 0
    for rid, rec in sorted(result.terminal.items()):
        tenant = rec.get("tenant", "default")
        t = per_tenant.setdefault(
            tenant, {"offered": 0, "completed": 0, "shed": 0,
                     "expired": 0, "rejected": 0, "lost": 0,
                     "quarantined": 0, "useful_tokens": 0})
        t["offered"] += 1
        state = rec["state"]
        t[state] = t.get(state, 0) + 1
        if state == "completed":
            tok = int(rec.get("tokens", 0))
            t["useful_tokens"] += tok
            useful_tokens += tok
        elif state == "shed":
            by_reason[_shed_reason_type(rec.get("reason"))] = \
                by_reason.get(_shed_reason_type(rec.get("reason")),
                              0) + 1
            if rec.get("retry_after_s") is None:
                shed_missing_hint += 1
    offered = result.offered
    # offered tokens include burst injections (the result tracks every
    # submission); fall back to the trace sum for bare results
    offered_tokens = result.offered_tokens or trace.offered_tokens()
    completed = counts.get("completed", 0)
    # token conservation per engine: generated - discarded == emitted
    token_contract_ok = True
    emitted = sum(int(r.get("tokens", 0))
                  for r in result.terminal.values())
    gen = disc = 0
    for stats in result.engine_stats.values():
        gen += int(stats.get("tokens_generated", 0))
        disc += int(stats.get("tokens_discarded", 0))
    if result.terminal_counts().get("lost", 0) == 0 \
            and gen - disc != emitted:
        token_contract_ok = False
    accounted = sum(counts.values())
    reasons = []
    if accounted != offered:
        reasons.append(f"terminal-state accounting hole: {offered} "
                       f"offered vs {accounted} terminal records")
    if not token_contract_ok:
        reasons.append(f"token conservation violated: generated {gen} "
                       f"- discarded {disc} != emitted {emitted}")
    if shed_missing_hint:
        reasons.append(f"{shed_missing_hint} shed request(s) carry no "
                       "retry_after_s hint")
    kill_scripted = any(e.get("kind") in ("kill", "killed")
                        for e in result.episodes)
    if counts.get("lost", 0) and not kill_scripted:
        reasons.append(f"{counts['lost']} request(s) lost without a "
                       "scripted kill episode")
    fairness = _jain(
        [t["completed"] / t["offered"]
         for t in per_tenant.values() if t["offered"]])
    deterministic = {
        "trace": {
            "seed": trace.seed, "sha256": trace.sha256(),
            "requests": len(trace.requests),
            "horizon_s": trace.horizon_s,
            "tenants": trace.tenants(),
        },
        "engine_flags": result.engine_flags,
        "dt_per_step": result.dt_per_step,
        "terminal": counts,
        "shed_by_reason": dict(sorted(by_reason.items())),
        "tokens": {"useful": useful_tokens, "emitted": emitted,
                   "generated": gen, "discarded": disc,
                   "offered": offered_tokens},
        "goodput": {
            "offered_requests": offered,
            "completed_requests": completed,
            "request_goodput": round(completed / offered, 6)
            if offered else None,
            "offered_tokens": offered_tokens,
            "useful_tokens": useful_tokens,
            "token_goodput": round(useful_tokens / offered_tokens, 6)
            if offered_tokens else None,
        },
        "per_tenant": {k: dict(v) for k, v in
                       sorted(per_tenant.items())},
        # exactly-once failover accounting: deterministic zeros with
        # the flag off (no journal, no coordinator), so the flags-off
        # determinism diff is unchanged by the block's presence
        "failover": {
            "recovered": sum(
                1 for r in result.terminal.values()
                if r.get("state") == "completed"
                and r.get("recovered_from")),
            "failover_attempts": sum(
                int(r.get("failover_attempts", 0) or 0)
                for r in result.terminal.values()),
            "quarantined": counts.get("quarantined", 0),
        },
        # prefix-cache / spec-decode accounting: summed from the
        # deterministic engine counters, so flags off ⇒ all-zero blocks
        # (presence never perturbs the flags-off determinism diff) and
        # flags on ⇒ seed-reproducible hit/acceptance numbers
        "prefix_cache": _prefix_cache_block(result),
        "spec_decode": _spec_decode_block(result),
        # request-disruption attribution, counted purely from terminal
        # records (virtual-time replay ⇒ byte-identical across
        # same-seed runs; the timing-plane half below holds the
        # wall-clock violation-cause table)
        "attribution": {
            "requests_preempted": sum(
                1 for r in result.terminal.values()
                if int(r.get("preemptions", 0) or 0) > 0),
            "preemptions": sum(
                int(r.get("preemptions", 0) or 0)
                for r in result.terminal.values()),
            "displaced": by_reason.get("displaced", 0),
            "expired": counts.get("expired", 0),
            "recovered": sum(
                1 for r in result.terminal.values()
                if r.get("state") == "completed"
                and r.get("recovered_from")),
            "quarantined": counts.get("quarantined", 0),
            "lost": counts.get("lost", 0),
        },
        "fairness": {"jain_completion_index": fairness},
        "episodes": [
            {k: v for k, v in e.items()
             if k not in ("slo", "wall_s")}
            for e in result.episodes],
    }
    timing = {
        "wall_s": result.wall_s,
        "steps": result.steps,
        "latency_ms": _latency_block(result.latency_samples),
        "slo": _slo_block(),
        "attribution": _forensics_attribution_block(),
        "episodes": [
            {"kind": e.get("kind"), "index": e.get("index"),
             "slo": e.get("slo"), "wall_s": e.get("wall_s")}
            for e in result.episodes],
    }
    if result.fleet_events is not None:
        timing["fleet_events"] = [
            {"status": str(s), "reason": d.get("reason"),
             "replica": d.get("replica")}
            for s, _t, d in result.fleet_events]
        # recovery after a kill: wall time from the crash marker to
        # the controller's replacement spawn (both stamped by the
        # replay pump on the controller thread)
        kill = next((e for e in result.episodes
                     if e.get("kind") == "killed"), None)
        recov = next((e for e in result.episodes
                      if e.get("kind") == "recovered"), None)
        if kill is not None:
            timing["recovery_s"] = (
                round(recov["wall_s"] - kill["wall_s"], 6)
                if recov is not None and kill.get("wall_s") is not None
                else None)
    # per-request failover recovery (strand -> survivor terminal, wall
    # seconds) + the coordinator's own snapshot — timing plane: both
    # depend on real heartbeat-staleness detection latency
    recov_samples = sorted(
        float(r["recovery_s"]) for r in result.terminal.values()
        if r.get("recovery_s") is not None)
    if recov_samples or result.failover is not None:
        import numpy as _np
        fo_t: dict = {}
        if recov_samples:
            a = _np.asarray(recov_samples, dtype=float)
            fo_t["recovery_s"] = {
                "count": int(a.size),
                "p50": round(float(_np.percentile(a, 50)), 6),
                "p99": round(float(_np.percentile(a, 99)), 6),
                "max": round(float(a.max()), 6),
            }
        if result.failover is not None:
            fo_t["coordinator"] = result.failover
        timing["failover"] = fo_t
    if include_fleet:
        timing["fleet"] = _fleet_block()
    card = {
        "version": SCORECARD_VERSION,
        "verdict": {"pass": not reasons, "reasons": reasons},
        "deterministic": deterministic,
        "timing": timing,
    }
    # the document is a wire contract: it must survive the JSON round
    # trip it takes into result files
    json.dumps(card)
    if _monitor.enabled():
        _monitor.inc("loadgen.scorecard.builds",
                     doc="trace-replay scorecards folded")
    set_last_scorecard(card)
    return card


def set_last_scorecard(card: Optional[dict]):
    _LAST[0] = card


def last_scorecard() -> Optional[dict]:
    return _LAST[0]


def reset():
    _LAST[0] = None
