"""SLO accounting plane: per-request/per-tenant cost attribution,
error-budget burn rates, and observe-only autoscaling signals (a copy
of ``paddle_tpu/monitor/slo.py``; names, objectives, environment
variables and the burn math are the reference's).

The serving latency histograms aggregate every request of the
process; this module keeps what they cannot: per-request cost records,
a tenant dimension, SLO objectives and windowed compliance. The
engine's ``shed_on_burn`` acts on its burn alert. Three surfaces, all
behind the one ``FLAGS_enable_monitor`` branch (off path = zero
registrations, empty rings):

- **Per-request records + tenant aggregates.** The serving engine
  retires (or rejects) a request with a cost record — prefill/decode/
  discarded tokens, CUMULATIVE queue wait across preemption re-queues,
  page-seconds, slot steps, modeled FLOPs (``inference/engine.py``
  builds it at its existing host-sync seams; zero added device
  synchronizations). :func:`record_request` keeps the last
  ``PADDLE_TPU_SLO_WINDOW`` records in a bounded ring (cumulative
  histograms cannot answer "the last N requests") and folds the costs
  into per-tenant aggregates with BOUNDED cardinality:
  ``PADDLE_TPU_MAX_TENANTS`` (default 32) distinct tenants are
  tracked; every further tenant name collapses into ``_other`` — a
  hostile client cycling tenant names can never grow the label space.
  Tenant label values ride the exposition escaping
  (:func:`tenant_exposition_text` → ``slo_tenant_*{tenant="..."}``
  series appended to ``monitor.expose_text()``).

- **Objectives + burn rates.** :func:`objectives` reads the four
  env-configured targets (p99 TTFT/TPOT/e2e ms + availability =
  non-rejected fraction). Over the record ring,
  :func:`compliance_report` answers per objective: windowed compliance
  ratio, FAST (last ``PADDLE_TPU_SLO_FAST_WINDOW``, default 32
  requests) and SLOW (full ring) error-budget burn rates —
  ``bad_fraction / (1 - target_ratio)``, the SRE multi-window shape
  with request-count windows — and budget remaining
  (``1 - burn_slow``; negative = overdrawn). Windows with fewer than
  ``PADDLE_TPU_SLO_MIN_SAMPLES`` (default 5) relevant records answer
  ``None`` — never fabricated. A fast burn at or over
  ``PADDLE_TPU_SLO_BURN_WARN`` (default 14.4, the canonical SRE
  fast-burn page threshold) flips the objective into the ``alerting``
  list and the WARN-level health-provider report (``monitor/server.py``
  ``health()``; the reference serves it at ``/healthz``) — ``ok`` stays
  True, matching the drift-detector precedent: burning budget pages,
  it never gets a progressing worker restarted.

- **Autoscaling signals, observe-only.** The engine feeds one cheap
  host tick per scheduling step (:func:`note_sched_tick`: queue depth,
  live slots, pages-free fraction). :func:`update_autoscale_gauges`
  (run at scrape time — ``/metrics`` and ``/slo``) turns the tick ring
  into ``serving.autoscale.*`` gauges: queue-depth trend (req/s),
  utilization = max(slot, page, HBM) pressure — the HBM leg composes
  ``monitor/memory.headroom()``'s ``est_admittable_bytes`` when a
  scrape passes it — a demand estimate in replicas of this engine's
  size (utilization + queued-backlog slots + trend x horizon), the
  integer ``desired_capacity_hint``, and a ``drain_safe`` flag (no
  queued and no live requests: this replica can drain without
  dropping work). Nothing acts on them yet — they are the exact feed
  the elastic scaler will consume.
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..core import flags as _flags

__all__ = [
    "objectives", "set_objectives", "record_request", "record_rejected",
    "record_shed",
    "records", "compliance_report", "burn_alerting", "tenants_snapshot",
    "tenant_compliance",
    "tenants_for_fleet", "tenant_exposition_text", "note_sched_tick",
    "demand_model", "retry_after_hint",
    "update_autoscale_gauges", "slo_snapshot", "window_capacity",
    "set_window", "max_tenants", "set_max_tenants", "total_records",
    "reset", "OVERFLOW_TENANT",
]

_FLAG = _flags.flag_info("enable_monitor")

_DEFAULT_WINDOW = 256
_DEFAULT_FAST_WINDOW = 32
_DEFAULT_MIN_SAMPLES = 5
_DEFAULT_BURN_WARN = 14.4
_DEFAULT_MAX_TENANTS = 32
_DEFAULT_HORIZON_S = 30.0

OVERFLOW_TENANT = "_other"

# Objective name -> default target value. The p99 latency objectives
# imply a 0.99 good-request target ratio (1% error budget);
# availability's target ratio is the objective value itself.
_DEFAULT_OBJECTIVES = {
    "ttft_p99_ms": 1000.0,
    "tpot_p99_ms": 250.0,
    "e2e_p99_ms": 10000.0,
    "availability": 0.995,
}
# record field the latency objectives read
_OBJECTIVE_FIELD = {
    "ttft_p99_ms": "ttft_ms",
    "tpot_p99_ms": "tpot_ms",
    "e2e_p99_ms": "e2e_ms",
}

_MU = threading.Lock()
_RING: deque = deque(maxlen=_DEFAULT_WINDOW)
_TOTAL = [0]                     # lifetime records (bounding evidence)
_TENANTS: Dict[str, dict] = {}
_OVERFLOW_RECORDS = [0]          # records collapsed into _other
_OBJ_OVERRIDE: dict = {}
_MAX_TENANTS_OVERRIDE: list = [None]
_PROVIDER_REGISTERED = [False]

# Autoscale tick state: a short ring of (monotonic_t, queue_depth) for
# the trend plus the latest full scheduler tick. One deque append per
# engine step — the whole hot-path cost of the autoscale plane.
_TICKS: deque = deque(maxlen=64)
_LAST_TICK: list = [None]

# Tenant aggregate fields: (name, int|float, exposition doc). One
# Prometheus family per field, one labeled sample per tenant.
_TENANT_FIELDS = (
    ("requests", int, "requests recorded for this tenant "
                      "(completed + rejected)"),
    ("completed", int, "requests retired with output for this tenant"),
    ("rejected", int, "submissions refused at the door for this tenant"),
    ("shed", int, "admissible submissions refused by overload policy "
                  "(bounded queue, SLO burn, displacement, drain) with "
                  "a retry_after_s hint"),
    ("expired", int, "requests retired by their submit-time deadline "
                     "(in queue or evicted from the running batch)"),
    ("prefill_tokens", int, "prompt tokens prefilled (re-prefills after "
                            "preemption included)"),
    ("decode_tokens", int, "tokens emitted by decode chunks (work done, "
                           "including tokens a preemption later "
                           "discarded)"),
    ("discarded_tokens", int, "sampled tokens thrown away by preemption "
                              "recompute"),
    ("queue_wait_ms", float, "summed queue wait ms (cumulative across "
                             "preemption re-queues)"),
    ("page_seconds", float, "integrated KV pages held x wall seconds "
                            "(chunk-edge resolution)"),
    ("slot_steps", int, "decode-grid steps a slot was held "
                        "(chunk length x chunks)"),
    ("model_flops", float, "modeled FLOPs attributed (registered "
                           "program FLOPs split across live slots)"),
    ("preemptions", int, "times this tenant's requests were evicted "
                         "for recompute"),
)


def _env_int(name: str, default: int, lo: int = 1) -> int:
    try:
        return max(int(os.environ.get(name, str(default))), lo)
    except ValueError:
        return default


def _env_float(name: str, default: float, lo: float = 0.0) -> float:
    try:
        v = float(os.environ.get(name, str(default)))
        return v if v > lo else default
    except ValueError:
        return default


# -- objectives -------------------------------------------------------------

def objectives() -> dict:
    """The four SLO targets: env-configured
    (``PADDLE_TPU_SLO_TTFT_P99_MS`` etc.), overridable in process via
    :func:`set_objectives`."""
    out = {}
    for name, default in _DEFAULT_OBJECTIVES.items():
        if name in _OBJ_OVERRIDE:
            out[name] = _OBJ_OVERRIDE[name]
            continue
        v = _env_float(f"PADDLE_TPU_SLO_{name.upper()}", default)
        if name == "availability" and not v < 1.0:
            # availability=1.0 means a zero error budget, which makes
            # every burn rate unanswerable forever — the same input
            # set_objectives rejects; fall back to the default instead
            # of silently disabling the objective
            v = default
        out[name] = v
    return out


def set_objectives(**kw):
    """Override objectives in process (tests, bespoke loops):
    ``set_objectives(ttft_p99_ms=500)``. ``None`` drops an override
    back to the env/default; unknown names raise."""
    for name, value in kw.items():
        if name not in _DEFAULT_OBJECTIVES:
            raise ValueError(
                f"unknown SLO objective {name!r}; known: "
                f"{sorted(_DEFAULT_OBJECTIVES)}")
        if value is None:
            _OBJ_OVERRIDE.pop(name, None)
            continue
        value = float(value)
        if not value > 0 or (name == "availability" and value >= 1.0):
            raise ValueError(f"objective {name}={value} out of range")
        _OBJ_OVERRIDE[name] = value


def _target_ratio(name: str, value: float) -> float:
    return value if name == "availability" else 0.99


# -- window + tenants -------------------------------------------------------

def window_capacity() -> int:
    return _RING.maxlen


def total_records() -> int:
    return _TOTAL[0]


def set_window(n: Optional[int]):
    """Resize the record ring (tests; ``None`` restores env/default)."""
    global _RING
    if n is None:
        n = _env_int("PADDLE_TPU_SLO_WINDOW", _DEFAULT_WINDOW, 8)
    with _MU:
        _RING = deque(_RING, maxlen=max(int(n), 8))


set_window(None)        # resolve the env-configured capacity at import


def max_tenants() -> int:
    v = _MAX_TENANTS_OVERRIDE[0]
    if v is not None:
        return v
    return _env_int("PADDLE_TPU_MAX_TENANTS", _DEFAULT_MAX_TENANTS, 1)


def set_max_tenants(n: Optional[int]):
    """Override the tenant cardinality cap in process (tests)."""
    _MAX_TENANTS_OVERRIDE[0] = max(int(n), 1) if n is not None else None


def _tenant_key_locked(name: str, allow_new: bool) -> str:
    """Bounded-cardinality tenant key: a tenant already tracked keeps
    its name; a NEW tenant is tracked only while fewer than
    ``max_tenants()`` real tenants exist — beyond that it collapses
    into ``_other``. The registry/label space is bounded by
    construction, never by trust in client-supplied names.

    ``allow_new`` is False for REJECTED submissions: a tenant name
    earns its label slot by completing a request — otherwise 32
    malformed submissions with random tenant claims (refused before
    touching any engine state, i.e. free for the attacker) would
    permanently squat the label space and evict every legitimate
    tenant into ``_other``."""
    if name in _TENANTS:
        return name
    if allow_new:
        real = sum(1 for t in _TENANTS if t != OVERFLOW_TENANT)
        if real < max_tenants():
            return name
    _OVERFLOW_RECORDS[0] += 1
    return OVERFLOW_TENANT


def _fold_tenant_locked(key: str, rec: dict):
    agg = _TENANTS.get(key)
    if agg is None:
        agg = {f: (0 if kind is int else 0.0)
               for f, kind, _ in _TENANT_FIELDS}
        _TENANTS[key] = agg
    agg["requests"] += 1
    fold_costs = True
    if rec.get("rejected"):
        agg["rejected"] += 1
        if rec.get("shed"):
            # a shed is a POLICY refusal of admissible work (bounded
            # queue / burn / drain), counted alongside the malformed
            # rejections it rides availability with. A shed of
            # admitted-then-displaced/drained work CARRIES a cost
            # record (prefill, page-seconds, queue wait) — fold it;
            # submit-time sheds carry no cost fields and fold nothing.
            agg["shed"] += 1
        else:
            fold_costs = False   # malformed: touched no engine state
    elif rec.get("expired"):
        # deadline-expired: not completed, but it DID consume queue
        # wait / pages / slot steps — fold the cost columns
        agg["expired"] += 1
    else:
        agg["completed"] += 1
    if not fold_costs:
        return
    for field, kind, _ in _TENANT_FIELDS:
        if field in ("requests", "completed", "rejected", "shed",
                     "expired"):
            continue
        v = rec.get(field)
        if v is None:
            continue
        agg[field] += int(v) if kind is int else float(v)


def record_request(rec: dict):
    """Fold one retired request's cost record into the window + tenant
    aggregates and refresh the ``slo.*`` gauges. One cached-flag branch
    when the monitor is off. ``rec`` carries the cost fields named in
    the tenant table plus ``tenant`` / ``priority`` / ``ttft_ms`` /
    ``tpot_ms`` / ``e2e_ms`` (missing latencies stay None — a
    one-token request has no TPOT and is simply not relevant to that
    objective's window)."""
    if not _FLAG.value:
        return
    rec = dict(rec)
    rec.setdefault("rejected", False)
    rec["unix_time"] = round(time.time(), 3)
    with _MU:
        rec["tenant"] = _tenant_key_locked(
            str(rec.get("tenant") or "default"),
            allow_new=not rec["rejected"])
        _RING.append(rec)
        _TOTAL[0] += 1
        _fold_tenant_locked(rec["tenant"], rec)
    # NO window scan here: the slo.* gauges refresh pull-shaped inside
    # compliance_report() (scrapes, /slo, the healthz provider, bench)
    # — the retirement/rejection hot path stays an append + fold
    _maybe_register_provider()


def record_rejected(tenant: str = "default"):
    """Record a refused submission (availability = non-rejected
    fraction — rejections must enter the window or availability is
    fabricated). The claimed tenant is honored only when it is
    ALREADY tracked; a rejection cannot claim a new label slot (see
    :func:`_tenant_key_locked`) — it lands in ``_other`` instead."""
    record_request({"tenant": tenant, "rejected": True})


def record_shed(tenant: str = "default"):
    """Record an overload shed: a WELL-FORMED submission the engine
    refused by policy (bounded queue, SLO burn, displacement, drain).
    Rides the rejection path for availability — shed work was not
    served — plus the ``shed`` tenant column; the same
    cannot-claim-a-label-slot rule applies (shedding happens under
    overload, where submissions are cheapest for an attacker)."""
    record_request({"tenant": tenant, "rejected": True, "shed": True})


def records(n: Optional[int] = None) -> List[dict]:
    """Buffered records, oldest first (last ``n`` when given)."""
    with _MU:
        out = list(_RING)
    return out[-n:] if n else out


# -- compliance + burn rates ------------------------------------------------

def _relevance(rec: dict, objective: str, value: float):
    """``None`` when the record does not participate in this
    objective's window, else True (good) / False (violating).
    Deadline-expired requests count BAD for availability (the client
    was not served) and are excluded from the latency windows — a
    fast expiry must not score as a good e2e."""
    if objective == "availability":
        return not (rec.get("rejected") or rec.get("expired"))
    if rec.get("rejected") or rec.get("expired"):
        return None
    v = rec.get(_OBJECTIVE_FIELD[objective])
    if v is None:
        return None
    return float(v) <= value


def _burn(n: int, good: int, target: float, min_n: int
          ) -> Optional[float]:
    """Error-budget burn rate over one window: observed bad fraction /
    allowed bad fraction. 1.0 = consuming budget exactly as fast as
    the objective allows; None on thin windows — never fabricated."""
    if n < min_n:
        return None
    budget = 1.0 - target
    if budget <= 0:
        return None
    return ((n - good) / n) / budget


def compliance_report() -> dict:
    """Per-objective windowed compliance + fast/slow burn rates +
    budget remaining over the record ring. Also refreshes the
    ``slo.*`` gauges as a side effect — this is the ONE computation
    path, and every consumer is pull-shaped (`/metrics` and `/slo`
    scrapes, the healthz provider, bench), so the gauges are fresh
    exactly when someone looks and retirements never pay the window
    scan."""
    objs = objectives()
    fast_n = _env_int("PADDLE_TPU_SLO_FAST_WINDOW",
                      _DEFAULT_FAST_WINDOW, 2)
    min_n = _env_int("PADDLE_TPU_SLO_MIN_SAMPLES",
                     _DEFAULT_MIN_SAMPLES, 1)
    warn_thr = _env_float("PADDLE_TPU_SLO_BURN_WARN", _DEFAULT_BURN_WARN)
    with _MU:
        rows = list(_RING)
        total = _TOTAL[0]
    fast_rows = rows[-fast_n:]
    out = {}
    alerting = []
    for name, value in objs.items():
        target = _target_ratio(name, value)
        slow_rel = [r for r in (_relevance(x, name, value) for x in rows)
                    if r is not None]
        fast_rel = [r for r in (_relevance(x, name, value)
                                for x in fast_rows) if r is not None]
        n_slow, good_slow = len(slow_rel), sum(slow_rel)
        n_fast, good_fast = len(fast_rel), sum(fast_rel)
        burn_slow = _burn(n_slow, good_slow, target, min_n)
        burn_fast = _burn(n_fast, good_fast, target, min_n)
        compliance = (good_slow / n_slow) if n_slow >= min_n else None
        over = burn_fast is not None and burn_fast >= warn_thr
        if over:
            alerting.append(name)
        out[name] = {
            "objective": value,
            "target_ratio": target,
            "samples_slow": n_slow,
            "samples_fast": n_fast,
            "compliance": round(compliance, 6)
            if compliance is not None else None,
            "burn_fast": round(burn_fast, 6)
            if burn_fast is not None else None,
            "burn_slow": round(burn_slow, 6)
            if burn_slow is not None else None,
            "budget_remaining": round(1.0 - burn_slow, 6)
            if burn_slow is not None else None,
            "alerting": over,
        }
    rep = {
        "objectives": out,
        "alerting": alerting,
        "burn_warn_threshold": warn_thr,
        "fast_window": fast_n,
        "min_samples": min_n,
        "window": {"capacity": _RING.maxlen, "size": len(rows),
                   "total": total},
    }
    _refresh_slo_gauges(rep)
    return rep


# burn_alerting cache: (monotonic stamp, full verdict, load-only
# verdict). The engine's shed-on-burn policy asks on the SUBMIT path;
# the window scan must not run per submission, so the verdicts are
# cached for a short TTL.
_ALERT_CACHE = [0.0, False, False]


def burn_alerting(max_age_s: float = 0.5, load_only: bool = False
                  ) -> bool:
    """True while an objective's fast-window burn rate is at/over the
    warn threshold — the :func:`compliance_report` ``alerting`` verdict
    behind a ``max_age_s`` cache (pass 0 to force recomputation).

    ``load_only=True`` answers from the LATENCY objectives only,
    ignoring an availability-only burn. The engine's shed-on-burn
    trigger uses this: every shed is itself recorded availability-bad,
    so an availability-fed trigger would be a positive feedback loop —
    retried best-effort traffic keeps the burn alight and stays locked
    out long after the real overload (which shows up as TTFT/TPOT/e2e
    burn) has cleared.

    False with the monitor off: shedding on a signal nobody is
    recording would be acting on fabricated data."""
    if not _FLAG.value:
        return False
    now = time.monotonic()
    if max_age_s <= 0 or now - _ALERT_CACHE[0] > max_age_s:
        alerting = compliance_report()["alerting"]
        _ALERT_CACHE[1] = bool(alerting)
        _ALERT_CACHE[2] = any(n != "availability" for n in alerting)
        _ALERT_CACHE[0] = now
    return _ALERT_CACHE[2] if load_only else _ALERT_CACHE[1]


def _refresh_slo_gauges(rep: dict):
    """``slo.*`` gauges from a computed report. A window that cannot
    answer (None) writes no gauge — the last computed value stays, and
    absence before the first answer is honest, never zero-filled."""
    from . import set_gauge as _set_gauge

    _set_gauge("slo.window.requests", rep["window"]["size"],
               doc="per-request SLO records currently in the bounded "
                   "window ring")
    for name, st in rep["objectives"].items():
        for field in ("compliance", "burn_fast", "burn_slow",
                      "budget_remaining"):
            v = st[field]
            if v is not None:
                _set_gauge(f"slo.{name}.{field}", v)
    _set_gauge("slo.alerting", 1 if rep["alerting"] else 0,
               doc="1 while any objective's fast-window burn rate is "
                   "at or over the warn threshold (pages, never "
                   "restarts: the /healthz provider stays ok)")


def _maybe_register_provider():
    """Register the warn-level ``/healthz`` contributor once, and only
    while some plane could read it (the timeseries/engine gating rule:
    a fully-off process must not grow the provider map)."""
    if _PROVIDER_REGISTERED[0]:
        return
    from . import server as _server
    if not (_FLAG.value or _server.plane_active()):
        return
    _PROVIDER_REGISTERED[0] = True
    _server.register_health_provider("slo_burn", _slo_provider)


def _slo_provider() -> dict:
    """Warn-level: the burn report rides ``/healthz`` but ``ok`` stays
    True — an SLO burning budget is a page for an operator (or a
    signal for a scheduler), never a reason for a liveness probe to
    restart a worker that is serving."""
    rep = compliance_report()
    return {
        "ok": True,
        "level": "warn",
        "alerting": rep["alerting"],
        "burn_fast": {k: v["burn_fast"]
                      for k, v in rep["objectives"].items()},
        "budget_remaining": {k: v["budget_remaining"]
                             for k, v in rep["objectives"].items()},
        "window_requests": rep["window"]["size"],
    }


# -- tenants ----------------------------------------------------------------

def tenants_snapshot() -> dict:
    """Per-tenant aggregates + cardinality-policy evidence."""
    with _MU:
        tenants = {t: dict(agg) for t, agg in _TENANTS.items()}
        overflow = _OVERFLOW_RECORDS[0]
    return {"max_tenants": max_tenants(),
            "overflow_records": overflow,
            "tenants": tenants}


def tenant_compliance() -> dict:
    """Per-tenant windowed compliance over the record ring: for each
    tenant with records in the window, the good-request fraction per
    objective (None below the min-sample floor — same discipline as
    the global windows). The ring keys are already cardinality-
    collapsed, so this view is bounded too."""
    objs = objectives()
    min_n = _env_int("PADDLE_TPU_SLO_MIN_SAMPLES",
                     _DEFAULT_MIN_SAMPLES, 1)
    with _MU:
        rows = list(_RING)
    by_tenant: Dict[str, list] = {}
    for r in rows:
        by_tenant.setdefault(r.get("tenant", "default"), []).append(r)
    out = {}
    for tenant, trows in by_tenant.items():
        ent = {"requests_in_window": len(trows)}
        for name, value in objs.items():
            rel = [r for r in (_relevance(x, name, value)
                               for x in trows) if r is not None]
            ent[name] = round(sum(rel) / len(rel), 6) \
                if len(rel) >= min_n else None
        out[tenant] = ent
    return out


def tenants_for_fleet() -> dict:
    """{tenant: numeric aggregate fields} — the per-host payload the
    fleet gather sums across ranks (``monitor/fleet.py``)."""
    with _MU:
        return {t: dict(agg) for t, agg in _TENANTS.items()}


def tenant_exposition_text() -> str:
    """Per-tenant labeled series appended to ``monitor.expose_text()``:
    one ``slo_tenant_<field>`` counter family per cost column, one
    ``{tenant="..."}`` sample per tenant — label values through the
    exposition escaping, so hostile tenant names round-trip instead of
    corrupting the exposition. Empty string when no tenant has
    recorded (the off-path contract)."""
    from .exposition import escape_help, render_sample, sanitize_name

    with _MU:
        tenants = {t: dict(agg) for t, agg in _TENANTS.items()}
    if not tenants:
        return ""
    lines = []
    for field, _, doc in _TENANT_FIELDS:
        name = f"slo.tenant.{field}"
        pname = sanitize_name(name)
        lines.append(f"# HELP {pname} {escape_help(doc)}")
        lines.append(f"# TYPE {pname} counter")
        for tenant in sorted(tenants):
            lines.append(render_sample(name, {"tenant": tenant},
                                       tenants[tenant][field]))
    return "\n".join(lines) + "\n"


# -- autoscaling signals (observe-only) -------------------------------------

def note_sched_tick(queue_depth: int, live_slots: int, num_slots: int,
                    pages_free_fraction: float):
    """One scheduler tick from the serving engine (monitor-gated; a
    deque append + dict build — the entire hot-path cost)."""
    if not _FLAG.value:
        return
    now = time.monotonic()
    with _MU:
        _TICKS.append((now, int(queue_depth)))
        _LAST_TICK[0] = {
            "t": now,
            "queue_depth": int(queue_depth),
            "live_slots": int(live_slots),
            "num_slots": max(int(num_slots), 1),
            "pages_free_fraction": float(pages_free_fraction),
        }


def demand_model(queue_depth: int, live_slots: int, num_slots: int,
                 pages_free_fraction: float, trend: Optional[float] = None,
                 headroom: Optional[dict] = None) -> dict:
    """The autoscale demand model as a PURE function of one replica's
    scheduler state — shared verbatim by the observe-only
    ``serving.autoscale.*`` gauges, the engine's
    ``ServingEngine.autoscale_payload()`` (which works monitor-off:
    shedding must be able to hint ``retry_after_s`` without the metrics
    plane), and the elastic controller's scale decisions.

    ``utilization`` = max(live-slot fraction, page-pool used fraction,
    HBM-unadmittable fraction when a ``monitor/memory.headroom()``
    payload is given — absent backends contribute nothing);
    ``demand_estimate`` = utilization + queue_depth/num_slots +
    max(queue trend, 0) x horizon / num_slots
    (``PADDLE_TPU_AUTOSCALE_HORIZON_S``, default 30);
    ``desired_capacity_hint`` is its ceiling. ``drain_safe`` = no
    queued and no live requests."""
    num_slots = max(int(num_slots), 1)
    queue_depth = int(queue_depth)
    live_slots = int(live_slots)
    slot_util = live_slots / num_slots
    page_util = max(1.0 - float(pages_free_fraction), 0.0)
    mem_util = None
    est_admittable = None
    if headroom:
        est_admittable = headroom.get("est_admittable_bytes")
        limit = (headroom.get("hbm") or {}).get("totals", {}) \
            .get("bytes_limit")
        if est_admittable is not None and limit:
            mem_util = min(max(1.0 - est_admittable / limit, 0.0), 1.0)
    utilization = max(v for v in (slot_util, page_util, mem_util)
                      if v is not None)
    backlog = queue_depth / num_slots
    horizon = _env_float("PADDLE_TPU_AUTOSCALE_HORIZON_S",
                         _DEFAULT_HORIZON_S)
    growth = max(trend or 0.0, 0.0) * horizon / num_slots
    demand = utilization + backlog + growth
    desired = max(int(math.ceil(demand - 1e-9)), 0)
    return {
        "queue_depth": queue_depth,
        "live_slots": live_slots,
        "num_slots": num_slots,
        "pages_free_fraction": round(float(pages_free_fraction), 4),
        "queue_depth_trend_per_s": round(trend, 4)
        if trend is not None else None,
        "utilization": round(utilization, 4),
        "memory_utilization": round(mem_util, 4)
        if mem_util is not None else None,
        "est_admittable_bytes": est_admittable,
        "backlog_slots": round(backlog, 4),
        "horizon_s": horizon,
        "demand_estimate": round(demand, 4),
        "desired_capacity_hint": desired,
        "drain_safe": queue_depth == 0 and live_slots == 0,
    }


def retry_after_hint(payload: Optional[dict] = None) -> float:
    """Seconds a shed client should wait before retrying, from the
    demand model: the demand in excess of this one replica, spread
    over the autoscale horizon (an overloaded-by-2x replica hints one
    full horizon), clamped to [1, 2 x horizon] so a deep backlog never
    tells a client to go away for hours. ``payload`` is a
    :func:`demand_model` dict (the engine passes its own); without one
    the latest scheduler tick is used, or a flat 1.0 when no engine
    has ticked."""
    if payload is None:
        with _MU:
            last = _LAST_TICK[0]
        if last is None:
            return 1.0
        payload = demand_model(
            last["queue_depth"], last["live_slots"], last["num_slots"],
            last["pages_free_fraction"])
    horizon = payload.get("horizon_s") or _DEFAULT_HORIZON_S
    excess = max(payload["demand_estimate"] - 1.0, 0.0)
    return round(min(max(excess * horizon, 1.0), 2.0 * horizon), 3)


def update_autoscale_gauges(headroom: Optional[dict] = None) -> dict:
    """Turn the tick state into the ``serving.autoscale.*`` gauges and
    return the payload (``/slo``'s ``autoscale`` block). Pull-shaped:
    the ``/metrics`` and ``/slo`` scrapes call it, so the gauges are
    fresh at scrape time and cost nothing between scrapes. The math is
    :func:`demand_model`; ``headroom`` is an optional
    ``monitor/memory.headroom()`` payload feeding its HBM leg."""
    with _MU:
        last = _LAST_TICK[0]
        ticks = list(_TICKS)
    if last is None:
        # no engine has ticked: no signals, no gauges — an autoscaler
        # reading a fabricated zero would scale a fleet to nothing
        return {"available": False}
    from . import set_gauge as _set_gauge

    trend = None
    if len(ticks) >= 2:
        dt = ticks[-1][0] - ticks[0][0]
        if dt > 0:
            trend = (ticks[-1][1] - ticks[0][1]) / dt
    payload = demand_model(last["queue_depth"], last["live_slots"],
                           last["num_slots"],
                           last["pages_free_fraction"], trend=trend,
                           headroom=headroom)
    if trend is not None:
        _set_gauge("serving.autoscale.queue_depth_trend_per_s",
                   payload["queue_depth_trend_per_s"],
                   doc="queue-depth slope over the recent scheduler "
                       "ticks (requests/second; >0 = demand growing)")
    _set_gauge("serving.autoscale.utilization", payload["utilization"],
               doc="max of live-slot, page-pool and HBM-unadmittable "
                   "pressure — the replica's load factor")
    _set_gauge("serving.autoscale.demand_estimate",
               payload["demand_estimate"],
               doc="estimated demand in replicas of this engine's "
                   "size: utilization + queued backlog + queue trend "
                   "x horizon")
    _set_gauge("serving.autoscale.desired_capacity_hint",
               payload["desired_capacity_hint"],
               doc="ceil(demand_estimate) — the replica hint the "
                   "elastic serving controller scales toward")
    _set_gauge("serving.autoscale.drain_safe",
               1 if payload["drain_safe"] else 0,
               doc="1 when no queued and no live requests: this "
                   "replica can drain without dropping work")
    return {"available": True, **payload}


# -- snapshot ---------------------------------------------------------------

def slo_snapshot(headroom: Optional[dict] = None,
                 include_records: bool = False) -> dict:
    """The ``/slo`` payload (and the flight record's ``slo`` block):
    objectives + compliance/burn report + tenant aggregates +
    autoscale signals. ``headroom`` rides into the autoscale block
    (the route passes a fresh ``memory.headroom()``; crash paths pass
    None — a flight dump must not read the device backend)."""
    out = {
        "kind": "paddle_tpu.slo",
        "compliance": compliance_report(),
        "tenants": tenants_snapshot(),
        "tenant_compliance": tenant_compliance(),
        "autoscale": update_autoscale_gauges(headroom=headroom),
        "total_records": total_records(),
    }
    if include_records:
        out["records"] = records()
    return out


def reset():
    """Drop accumulated state (monitor.reset). Objective/window/tenant
    overrides are kept — configuration, not accumulated state (the
    exectime discipline)."""
    with _MU:
        _RING.clear()
        _TOTAL[0] = 0
        _TENANTS.clear()
        _OVERFLOW_RECORDS[0] = 0
        _TICKS.clear()
        _LAST_TICK[0] = None
    _ALERT_CACHE[0] = 0.0
    _ALERT_CACHE[1] = False
    _ALERT_CACHE[2] = False
