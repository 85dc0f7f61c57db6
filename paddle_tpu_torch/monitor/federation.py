"""Fleet SLO federation: per-replica telemetry frames and the federated
burn/compliance view the elastic serving controller scales on (port of
``paddle_tpu/monitor/federation.py``, whole).

- **Frames (replica side).** :class:`FramePublisher`, attached by
  ``ServingEngine.publish_frames``, emits a compact versioned frame on
  the engine's per-scheduler-step host tick: the autoscale payload, the
  ``monitor/slo.py`` burn report, the bounded tenant table, terminal
  state counters and the drain state. These are pure host reads, with
  zero added device synchronizations at any rate. Frames ride the
  name-keyed heartbeat transport (``distributed/heartbeat.publish_named``:
  the frame IS the ``<name>.alive`` beat payload), so publishing frames
  is also beating. The frame on disk is the reference's, byte for byte
  in its schema (``FRAME_KIND``, ``FRAME_VERSION``), so a view of either
  package reads the other's files.

- **Federation (controller side).** :class:`FleetSLOView` folds FRESH
  frames into the fleet verdict. Staleness is measured without trusting
  any publisher's clock: the age of a frame is the time since its
  ``seq`` last CHANGED, on the reader's own clock. A stale or absent
  frame contributes nothing; fleet values are never fabricated.
  :func:`federate` is the pure math: request-weighted per-objective
  compliance and fast/slow burn rates, per-replica attribution ranked
  worst-first, fleet tenant and terminal-state sums, summed demand.

- **Surfaces.** ``/fleet/serving`` on ``monitor/server.py``, the
  ``slo.fleet.*`` gauges plus ``{replica="..."}``-labeled exposition
  (appended to ``monitor.expose_text()``), and the flight record's
  ``federation`` block.

Actuation lives in ``distributed/fleet/elastic.py`` behind
``FLAGS_serving_fleet_burn_scaling`` (default off): ``run_serving``
reads frames instead of blocking on ``signals()``, a fleet
latency-objective fast burn adds scale-out pressure even when demand
is flat, and scale-in is refused while the fleet burn alerts (latency
objectives only: availability-fed triggers lock themselves on).

The key-value leg of the transport takes an explicit ``client=``; the
process-default store (``heartbeat._kv_client()``) is None until the
port has a process group (ROADMAP A9).
"""
from __future__ import annotations

import math
import threading
import time
import weakref
from typing import Dict, List, Optional

from ..core import flags as _flags

__all__ = [
    "FRAME_VERSION", "FRAME_KIND", "build_frame", "FramePublisher",
    "FleetSLOView", "federate", "local_frames",
    "fleet_serving_snapshot", "set_active_view", "active_view",
    "last_report", "exposition_text", "flight_block", "reset",
]

_FLAG = _flags.flag_info("enable_monitor")

FRAME_KIND = "paddle_tpu.slo_frame"
FRAME_VERSION = 1

_DEFAULT_STALENESS_S = 5.0
_DEFAULT_MIN_INTERVAL_S = 0.25
# transport-failure retry backoff: a failed publish retries after
# min(min_interval_s, this) — fast enough that a transient fault
# doesn't cost a long rate-limit window, bounded so a dead disk
# doesn't turn every scheduler step into transport I/O
_FAIL_RETRY_S = 0.25

_MU = threading.Lock()
# Frames this process published, latest per name: a replica's own
# /fleet/serving and the flight recorder read these with no transport.
_LOCAL_FRAMES: Dict[str, dict] = {}
# The controller's registered view (weak — a finished run_serving must
# not pin its view) and the last federated report it computed.
_ACTIVE_VIEW: list = [None]
_LAST_REPORT: list = [None]

# Objective names whose burn participates in the LOAD verdict (the
# shed-on-burn / burn-scaling trigger): availability is excluded —
# sheds and refusals are themselves availability-bad records, so an
# availability-fed actuator locks itself on.
_AVAILABILITY = "availability"


def staleness_window_s() -> float:
    """Frames older than this (seq-change age on the READER's clock)
    contribute nothing (``PADDLE_TPU_FED_STALENESS_S``, default 5)."""
    from . import slo as _slo
    return _slo._env_float("PADDLE_TPU_FED_STALENESS_S",
                           _DEFAULT_STALENESS_S)


def _burn_warn_threshold() -> float:
    """ONE warn threshold for both planes: the per-replica slo plane's
    env/default — the fleet verdict and the replica alerts can never
    silently diverge on what 'burning' means."""
    from . import slo as _slo
    return _slo._env_float("PADDLE_TPU_SLO_BURN_WARN",
                           _slo._DEFAULT_BURN_WARN)


# -- frame construction (replica side) ---------------------------------------

def _slo_block_from_report(rep: dict) -> dict:
    """The compact per-objective slice of a ``slo.compliance_report()``
    a frame carries: compliance + fast/slow burns + the sample counts
    the federation math weights by + the target ratio it needs to turn
    a fleet bad-fraction back into a burn."""
    objectives = {}
    for name, st in (rep.get("objectives") or {}).items():
        objectives[name] = {
            "compliance": st.get("compliance"),
            "burn_fast": st.get("burn_fast"),
            "burn_slow": st.get("burn_slow"),
            "samples_slow": int(st.get("samples_slow") or 0),
            "samples_fast": int(st.get("samples_fast") or 0),
            "target_ratio": st.get("target_ratio"),
        }
    return {"objectives": objectives,
            "alerting": list(rep.get("alerting") or ())}


def build_frame(engine, *, name: str, seq: int,
                slo_report: Optional[dict] = None) -> dict:
    """One compact versioned telemetry frame from an engine's HOST
    state — no device reads, no synchronizations. ``slo_report`` lets
    a caller inject a pre-computed (or synthetic) compliance report;
    default is the process-global ``monitor/slo.compliance_report()``
    (in-process multi-engine tests share that plane, so they inject
    per-replica reports instead)."""
    from . import slo as _slo

    if slo_report is None:
        slo_report = _slo.compliance_report()
    stats = engine.stats
    return {
        "kind": FRAME_KIND,
        "version": FRAME_VERSION,
        "name": str(name),
        "seq": int(seq),
        "t": round(time.time(), 3),
        "autoscale": engine.autoscale_payload(),
        "slo": _slo_block_from_report(slo_report),
        "tenants": _slo.tenants_for_fleet(),
        "requests": {
            "admitted": stats.admitted,
            "completed": stats.completed,
            "preempted": stats.preempted,
            "expired": stats.expired,
            "shed": stats.shed,
            "tokens_generated": stats.tokens_generated,
        },
        "draining": bool(engine.draining),
        "drain_complete": bool(engine.drain_complete),
    }


class FramePublisher:
    """Per-replica frame emitter, driven by the engine's scheduler-step
    host tick (``ServingEngine.publish_frames`` attaches one; ``step``
    calls :meth:`maybe_publish`). Rate-limited to ``min_interval_s``;
    ``force=True`` (attach, ``begin_drain``) bypasses the limit so
    lifecycle transitions propagate promptly. ``slo_fn`` overrides the
    frame's compliance report source (per-replica burns for in-process
    multi-engine fleets). Publishing never raises — telemetry must not
    take down the serving loop."""

    def __init__(self, name: str, dir_path: Optional[str] = None, *,
                 client=None, local_only: bool = False,
                 min_interval_s: float = _DEFAULT_MIN_INTERVAL_S,
                 slo_fn=None, slo_cache_s: float = 0.5,
                 _time_fn=time.monotonic):
        self.name = str(name)
        self.dir_path = dir_path
        self._client = client
        # local_only: frames stay in this process's registry — no
        # transport at all. Without it, dir_path=None still falls back
        # to PADDLE_HEARTBEAT_DIR / the global KV client (the
        # heartbeat conventions), which a bench/diagnostic publisher
        # must not litter with beat files nobody sweeps.
        self.local_only = bool(local_only)
        self.min_interval_s = float(min_interval_s)
        self._slo_fn = slo_fn
        self._slo_cache_s = float(slo_cache_s)
        self._time = _time_fn
        self.seq = 0
        self._last_pub: Optional[float] = None
        self._rep_cache: list = [0.0, None]   # [stamp, report]
        # serializes publishes: the replica's step thread and the
        # controller's begin_drain force-publish race otherwise —
        # interleaved writes to the one pid-keyed temp file can tear
        # the beat payload, and an unsynchronized seq lets the slower
        # thread publish a LOWER-seq (pre-drain) frame last
        self._pub_mu = threading.Lock()

    def _transport_configured(self) -> bool:
        """Whether ``publish_named`` has SOMEWHERE to write — the
        explicit dir/client, or the PADDLE_HEARTBEAT_DIR / global-KV
        fallbacks it actually uses. The failure fast-retry must key on
        the same answer: a replica publishing through the env-dir
        fallback (the launch-CLI worker pattern) deserves the retry
        too, and a publisher with NO transport at all must not burn a
        frame build every ``_FAIL_RETRY_S``."""
        if self.local_only:
            return False
        if self.dir_path or self._client is not None:
            return True
        from ..distributed import heartbeat as _heartbeat
        return (_heartbeat._marker_dir(None) is not None
                or _heartbeat._kv_client() is not None)

    def _slo_report(self) -> dict:
        """The compliance report a frame carries, TTL-cached
        (``slo_cache_s``, default 0.5 s — the burn_alerting cadence):
        the window scan was moved OFF the retirement
        hot path, and frame publication must not push it back onto
        the scheduler step at the frame rate. A frame's slo block may
        therefore lag its autoscale block by up to the TTL."""
        if self._slo_fn is not None:
            return self._slo_fn()
        now = self._time()
        if (self._rep_cache[1] is None
                or now - self._rep_cache[0] >= self._slo_cache_s):
            from . import slo as _slo
            self._rep_cache[:] = [now, _slo.compliance_report()]
        return self._rep_cache[1]

    def maybe_publish(self, engine, force: bool = False
                      ) -> Optional[dict]:
        """Publish a frame unless the rate limit holds it back.
        Returns the frame published, or None. Serialized: concurrent
        callers (the step thread vs a begin_drain force-publish)
        publish whole frames in seq order, never interleaved."""
        with self._pub_mu:
            now = self._time()
            if (not force and self._last_pub is not None
                    and now - self._last_pub < self.min_interval_s):
                return None
            try:
                frame = build_frame(engine, name=self.name,
                                    seq=self.seq + 1,
                                    slo_report=self._slo_report())
            except Exception:
                # a failing build (a raising slo_fn, a malformed
                # report) gets the SAME backoff as a failing
                # transport: without it every scheduler step on the
                # decode hot path would pay a full build attempt +
                # swallowed exception, forever and silently — and
                # since the frame is the liveness beat, the replica
                # would be stale-killed with no diagnostic of the
                # root cause
                self._last_pub = now - max(
                    self.min_interval_s - _FAIL_RETRY_S, 0.0)
                from . import inc as _inc
                _inc("federation.frames.build_errors",
                     doc="telemetry frames that failed to BUILD "
                         "(raising slo_fn / malformed report) — "
                         "retried on the failure backoff, never per "
                         "scheduler step")
                return None
            self.seq += 1
            self._last_pub = now
            with _MU:
                _LOCAL_FRAMES[self.name] = frame
            ok = False
            if not self.local_only:
                from ..distributed import heartbeat as _heartbeat
                try:
                    ok = _heartbeat.publish_named(
                        frame["name"], frame, dir_path=self.dir_path,
                        client=self._client)
                except Exception:
                    # belt over publish_named's own never-raises
                    # promise: publishing must not take down the
                    # serving loop
                    ok = False
            if not ok and self._transport_configured():
                # a configured transport took nothing (disk full, KV
                # error): retry SOON instead of waiting out a long
                # rate limit — but behind a short backoff, never
                # per-step: a persistently failing transport must not
                # turn every scheduler tick on the decode hot path
                # into makedirs + temp write + KV set I/O. The local
                # registry above has the frame either way.
                self._last_pub = now - max(
                    self.min_interval_s - _FAIL_RETRY_S, 0.0)
        from . import inc as _inc
        _inc("federation.frames.published",
             doc="per-replica SLO telemetry frames published (latest "
                 "kept in the local registry; file + KV transports "
                 "best-effort)")
        return frame


def local_frames() -> Dict[str, dict]:
    """Frames THIS process published (latest per name)."""
    with _MU:
        return dict(_LOCAL_FRAMES)


# -- federation math (pure) --------------------------------------------------

def _num(v) -> Optional[float]:
    """A finite number, or None. Frame fields are remote input — a
    malformed value (a string, NaN, a list) from ONE buggy publisher
    must degrade to "contributes nothing", never crash federation for
    the whole fleet."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    v = float(v)
    return v if math.isfinite(v) else None


def _dict(v) -> dict:
    """A dict, or {}. Frame SUB-BLOCKS are remote input too: a truthy
    non-dict where a dict is expected (``"slo": "x"``) bypasses the
    ``or {}`` guards and must degrade like an absent block — never
    raise through the fold."""
    return v if isinstance(v, dict) else {}


def _weighted(pairs: List[tuple]) -> Optional[float]:
    """Request-weighted mean over (value, weight) pairs; None when no
    pair carries both a numeric value and a positive numeric weight —
    a fleet window that cannot answer stays None, never fabricated."""
    num = den = 0.0
    for value, weight in pairs:
        value, weight = _num(value), _num(weight)
        if value is None or weight is None or weight <= 0:
            continue
        num += value * weight
        den += weight
    return num / den if den > 0 else None


def federate(frames: Dict[str, dict],
             warn_threshold: Optional[float] = None) -> dict:
    """Fold per-replica frames into the fleet verdict: per objective,
    request-weighted compliance and fast/slow burn rates (weights =
    each replica's sample counts — a replica serving 10x the traffic
    moves the fleet number 10x as much); ``alerting`` objectives whose
    fleet fast burn is at/over the warn threshold (``alerting_load``
    excludes availability — the actuation view); per-replica
    ``attribution`` ranked worst-first; fleet tenant and
    terminal-state sums; summed demand. Pure — no transport, no
    clock."""
    if warn_threshold is None:
        warn_threshold = _burn_warn_threshold()
    names = sorted(frames)
    obj_names: List[str] = []
    for name in names:
        for obj in _dict(_dict(frames[name].get("slo"))
                         .get("objectives")):
            if obj not in obj_names:
                obj_names.append(obj)
    objectives = {}
    alerting: List[str] = []
    for obj in obj_names:
        rows = [_dict(_dict(_dict(frames[n].get("slo"))
                             .get("objectives")).get(obj))
                for n in names]
        compliance = _weighted([(r.get("compliance"),
                                 r.get("samples_slow")) for r in rows])
        burn_fast = _weighted([(r.get("burn_fast"),
                                r.get("samples_fast")) for r in rows])
        burn_slow = _weighted([(r.get("burn_slow"),
                                r.get("samples_slow")) for r in rows])
        over = burn_fast is not None and burn_fast >= warn_threshold
        if over:
            alerting.append(obj)
        objectives[obj] = {
            "compliance": round(compliance, 6)
            if compliance is not None else None,
            "burn_fast": round(burn_fast, 6)
            if burn_fast is not None else None,
            "burn_slow": round(burn_slow, 6)
            if burn_slow is not None else None,
            "samples_slow": int(sum(_num(r.get("samples_slow")) or 0
                                    for r in rows)),
            "samples_fast": int(sum(_num(r.get("samples_fast")) or 0
                                    for r in rows)),
            "replicas_reporting": sum(
                1 for r in rows
                if _num(r.get("compliance")) is not None
                or _num(r.get("burn_fast")) is not None),
            "alerting": over,
        }

    # per-replica attribution, worst burner first (a divergence-report
    # shape): each replica's row carries its worst
    # objective by fast burn; alerting replicas sort above all, then
    # fast burn descending (no data sorts last, never fabricated as 0)
    attribution = []
    for name in names:
        frame = frames[name]
        worst_obj = None
        worst = None
        for obj, r in _dict(_dict(frame.get("slo"))
                            .get("objectives")).items():
            bf = _num(_dict(r).get("burn_fast"))
            if bf is not None and (worst is None or bf > worst):
                worst, worst_obj = bf, obj
        row_obj = _dict(_dict(_dict(frame.get("slo"))
                              .get("objectives")).get(worst_obj))
        att = {
            "replica": name,
            "objective": worst_obj,
            "burn_fast": worst,
            "burn_slow": _num(row_obj.get("burn_slow")),
            "compliance": _num(row_obj.get("compliance")),
            "alerting": worst is not None and worst >= warn_threshold,
            "demand_estimate": _num(_dict(frame.get("autoscale"))
                                    .get("demand_estimate")),
            "draining": bool(frame.get("draining")),
        }
        attribution.append(att)
    attribution.sort(key=lambda a: (
        not a["alerting"],
        -(a["burn_fast"] if a["burn_fast"] is not None
          else -math.inf),
        a["replica"]))

    tenants: Dict[str, dict] = {}
    for name in names:
        for t, fields in _dict(frames[name].get("tenants")).items():
            if not isinstance(fields, dict):
                continue
            agg = tenants.setdefault(t, {})
            for k, v in fields.items():
                if _num(v) is not None:
                    agg[k] = agg.get(k, 0) + v

    requests: Dict[str, float] = {}
    for name in names:
        for k, v in _dict(frames[name].get("requests")).items():
            if _num(v) is not None:
                requests[k] = requests.get(k, 0) + v

    demands = [_num(_dict(frames[n].get("autoscale"))
                    .get("demand_estimate")) for n in names]
    present = [d for d in demands if d is not None]
    demand_sum = round(sum(present), 4) if present else None
    return {
        "replicas": names,
        "objectives": objectives,
        "alerting": alerting,
        "alerting_load": [o for o in alerting if o != _AVAILABILITY],
        "burn_warn_threshold": warn_threshold,
        "attribution": attribution,
        "tenants": tenants,
        "requests": requests,
        "demand": {
            "demand_estimate_sum": demand_sum,
            "desired_capacity_hint":
                max(int(math.ceil(demand_sum - 1e-9)), 0)
                if demand_sum is not None else None,
            "replicas_reporting": len(present),
        },
        "draining": [n for n in names if frames[n].get("draining")],
    }


# -- the controller-side view ------------------------------------------------

class FleetSLOView:
    """Fresh-frame tracker + federation over the heartbeat transport.

    Staleness is clock-skew-free: a frame's age is the time since its
    ``seq`` last CHANGED, measured on THIS process's clock — publisher
    timestamps are never compared across hosts. A frame whose age
    exceeds the
    staleness window — or a replica that never published — contributes
    nothing to the fleet verdict; nothing is fabricated. Frames with a
    version newer than this reader understands are dropped (counted),
    not half-parsed."""

    def __init__(self, dir_path: Optional[str] = None, *, client=None,
                 staleness_s: Optional[float] = None,
                 read_interval_s: float = 0.25,
                 absent_backoff_s: float = 1.0,
                 _time_fn=time.monotonic):
        self.dir_path = dir_path
        self._client = client
        self.staleness_s = (float(staleness_s) if staleness_s is not None
                            else staleness_window_s())
        # per-name transport-read throttle: frames publish at most
        # every ~0.25s (the publisher default), but run_serving polls
        # every tick (50ms) — and on some KV stores an ABSENT pt_named
        # key costs a blocking ~10ms KV probe per name, which at
        # per-tick rate would eat the control loop. Reads are capped
        # at read_interval_s per name (absent_backoff_s after a read
        # that found nothing on either transport); both stay far
        # inside the staleness window, so freshness is unaffected.
        self.read_interval_s = float(read_interval_s)
        self.absent_backoff_s = float(absent_backoff_s)
        self._time = _time_fn
        # name -> [seq, t_seq_changed_local, frame]
        self._seen: Dict[str, list] = {}
        self._next_read: Dict[str, float] = {}
        self._mu = threading.Lock()

    def ingest(self, name: str, frame: dict) -> bool:
        """Track one frame (transport reads land here; tests inject
        directly). Returns False for non-frames and for versions newer
        than FRAME_VERSION — those contribute nothing."""
        if not isinstance(frame, dict) or frame.get("kind") != FRAME_KIND:
            return False
        try:
            version = int(frame.get("version"))
        except (TypeError, ValueError):
            return False
        if version > FRAME_VERSION or version < 1:
            from . import inc as _inc
            _inc("federation.frames.dropped",
                 doc="frames ignored by the reader (unknown newer "
                     "version — a half-parsed frame could fabricate "
                     "fleet values)")
            return False
        now = self._time()
        seq = frame.get("seq")
        if isinstance(seq, bool) or not isinstance(seq, (int, float)) \
                or seq != seq:
            # a frame that cannot prove publication order cannot prove
            # freshness either (a NaN seq would re-stamp the age every
            # poll — fabricated liveness): contributes nothing
            return False
        with self._mu:
            entry = self._seen.get(name)
            if entry is None or entry[0] != seq:
                self._seen[name] = [seq, now, frame]
            else:
                entry[2] = frame      # same seq: content kept, age not
                #                       reset — no new publication
        return True

    def forget(self, name: str):
        """Drop a replaced/stopped replica's tracking state (the
        controller sweeps alongside the beat-file GC). Also clears
        the name's read throttle, so a respawned name is read
        immediately."""
        with self._mu:
            self._seen.pop(name, None)
        self._next_read.pop(name, None)

    def sweep(self, name: str):
        """Spawn-time name sweep: drop a name's published payload from
        this view's OWN transport (beat file + KV key). Controllers
        restart replica numbering at ``replica0`` every run, and a run
        that exits with replicas still live never sweeps their names —
        the leftover frame carries a HIGHER seq than a fresh
        incarnation's restart-at-1 publisher, so ``read_named`` would
        keep preferring the dead payload (stamped fresh for a full
        staleness window on first poll, then masking the live
        replica's frames until its seq caught up). Transport only:
        in-memory tracking is deliberately kept — frames ingested
        directly for a name about to spawn are the in-process fleet
        seeding pattern, and stale ones age out on their own. A view
        with NO configured transport sweeps nothing: falling back to
        PADDLE_HEARTBEAT_DIR / the global KV client (the
        ``remove_named`` defaults) would let an in-process seeded
        view delete an unrelated live fleet's generic ``replicaN``
        beat files (the ``local_only`` publisher lesson). Never
        raises."""
        if self.dir_path is None and self._client is None:
            return
        from ..distributed import heartbeat as _heartbeat
        try:
            # env_fallback=False: a KV-only view's file leg must not
            # resolve through PADDLE_HEARTBEAT_DIR (the launcher
            # exports it to every worker) and delete an unrelated
            # fleet's generic replicaN beat files — the exact hazard
            # the transportless guard above exists to prevent
            _heartbeat.remove_named(self.dir_path, name,
                                    client=self._client,
                                    env_fallback=False)
        except Exception:
            pass

    def poll(self, names) -> int:
        """Read the transport for ``names`` (throttled per name, see
        ``read_interval_s``) and ingest what it finds. Returns how
        many frames were ingested. Never raises — an unreadable
        transport leaves staleness to do its job."""
        from ..distributed import heartbeat as _heartbeat
        got = 0
        now = self._time()
        for name in names:
            if now < self._next_read.get(name, -math.inf):
                continue
            try:
                # env_fallback=False: this view reads exactly the
                # transport it was built over — a KV-only view in a
                # launcher-spawned process (PADDLE_HEARTBEAT_DIR
                # exported) must not ingest an unrelated fleet's
                # higher-seq replicaN frames off the env dir and
                # federate the wrong fleet's demand/burn
                payload = _heartbeat.read_named(
                    name, dir_path=self.dir_path, client=self._client,
                    env_fallback=False)
            except Exception:
                payload = None
            if payload is None:
                # nothing on either transport: back off this name —
                # the absent-key KV probe is the expensive path
                self._next_read[name] = now + self.absent_backoff_s
                continue
            self._next_read[name] = now + self.read_interval_s
            if self.ingest(name, payload):
                got += 1
        return got

    def frames(self, names=None) -> tuple:
        """``(fresh, stale)``: {name: frame} for frames within the
        staleness window, {name: age_s} for tracked-but-stale ones.
        ``names`` filters (absent names simply don't appear — they
        never contribute)."""
        now = self._time()
        fresh: Dict[str, dict] = {}
        stale: Dict[str, float] = {}
        with self._mu:
            items = list(self._seen.items())
        allow = set(names) if names is not None else None
        for name, (seq, t_changed, frame) in items:
            if allow is not None and name not in allow:
                continue
            age = now - t_changed
            if age <= self.staleness_s:
                fresh[name] = frame
            else:
                stale[name] = round(age, 3)
        return fresh, stale

    def fresh_frames(self, names=None) -> Dict[str, dict]:
        return self.frames(names)[0]

    def fleet_report(self, names=None, poll: bool = True) -> dict:
        """Poll (optionally; ``names`` defaults to every tracked
        name), federate the fresh frames, refresh the ``slo.fleet.*``
        gauges, and cache the report for the exposition/flight
        surfaces."""
        if poll:
            with self._mu:
                targets = list(names) if names is not None \
                    else list(self._seen)
            self.poll(targets)
        fresh, stale = self.frames(names)
        report = federate(fresh)
        report["staleness"] = {
            "window_s": self.staleness_s,
            "fresh": sorted(fresh),
            "stale": stale,
        }
        _LAST_REPORT[0] = report
        _update_fleet_gauges(report)
        return report

    def burn_alerting(self, names=None, load_only: bool = True,
                      poll: bool = False) -> bool:
        """True while a federated objective's fast burn is at/over the
        warn threshold. ``load_only`` (the actuation default) reads the
        latency objectives only: an availability-fed
        actuator's own sheds/refusals keep its trigger alight."""
        rep = self.fleet_report(names, poll=poll)
        return bool(rep["alerting_load"] if load_only
                    else rep["alerting"])


def _update_fleet_gauges(report: dict):
    """``slo.fleet.*`` gauges from a federated report (monitor-gated;
    a window that cannot answer writes no gauge — never zero-filled)."""
    if not _FLAG.value:
        return
    from . import set_gauge as _set_gauge

    st = report.get("staleness") or {}
    _set_gauge("slo.fleet.replicas_fresh", len(st.get("fresh") or ()),
               doc="replicas whose telemetry frame is inside the "
                   "staleness window (federation)")
    _set_gauge("slo.fleet.replicas_stale", len(st.get("stale") or ()),
               doc="tracked replicas whose last frame aged out — they "
                   "contribute nothing to the fleet verdict")
    _set_gauge("slo.fleet.alerting",
               1 if report.get("alerting") else 0,
               doc="1 while any federated objective's request-weighted "
                   "fast burn is at/over the warn threshold")
    demand = report.get("demand") or {}
    if demand.get("demand_estimate_sum") is not None:
        _set_gauge("slo.fleet.demand_estimate",
                   demand["demand_estimate_sum"],
                   doc="summed per-replica demand estimates over fresh "
                       "frames")
        _set_gauge("slo.fleet.desired_capacity_hint",
                   demand["desired_capacity_hint"],
                   doc="ceil of the fleet demand sum — the replica "
                       "count the federated controller scales toward")
    # gauge NAMES are process-global and permanent: mint them only for
    # the slo plane's closed objective set — objective names inside a
    # frame are remote input, and a buggy publisher varying them per
    # publish would otherwise grow the registry (and the /metrics
    # exposition) without bound. Unknown objectives still ride the
    # report/route JSON, which is bounded per report.
    from . import slo as _slo
    known = _slo._DEFAULT_OBJECTIVES
    for obj, stt in (report.get("objectives") or {}).items():
        if obj not in known:
            continue
        for field in ("compliance", "burn_fast", "burn_slow"):
            v = stt.get(field)
            if v is not None:
                _set_gauge(f"slo.fleet.{obj}.{field}", v)


# -- process-global surfaces -------------------------------------------------

def set_active_view(view: Optional[FleetSLOView]):
    """Register the controller's view for the ``/fleet/serving`` route
    and the exposition/flight surfaces (weakly held — a finished
    controller's view prunes itself)."""
    _ACTIVE_VIEW[0] = weakref.ref(view) if view is not None else None


def active_view() -> Optional[FleetSLOView]:
    ref = _ACTIVE_VIEW[0]
    return ref() if ref is not None else None


def last_report() -> Optional[dict]:
    """The most recent federated report (a controller tick or a
    ``/fleet/serving`` scrape computed it), or None."""
    return _LAST_REPORT[0]


def fleet_serving_snapshot() -> dict:
    """The ``/fleet/serving`` payload. With a controller view active:
    its fresh/stale frames + a freshly federated verdict. Without one
    (a replica process): the locally-published frames federated as an
    all-fresh single-host view — a replica's own scrape answers for
    itself, never for peers it cannot see."""
    view = active_view()
    if view is not None:
        report = view.fleet_report(poll=True, names=None)
        fresh, _stale = view.frames()
        source = "controller"
    else:
        fresh = local_frames()
        report = federate(fresh) if fresh else None
        if report is not None:
            report["staleness"] = {"window_s": None,
                                   "fresh": sorted(fresh), "stale": {}}
            _LAST_REPORT[0] = report
            _update_fleet_gauges(report)
        source = "local"
    snap = {
        "kind": "paddle_tpu.fleet_serving",
        "source": source,
        "unix_time": round(time.time(), 3),
        "frames": fresh,
        "report": report,
    }
    try:
        from ..inference import failover as _fo
        coord = _fo.active_coordinator()
    except Exception:
        coord = None
    if coord is not None:
        # the failover block rides only while a coordinator is live
        # (FLAGS_serving_failover on, controller running) — absent
        # otherwise, so flags-off payloads are byte-identical
        snap["failover"] = coord.snapshot()
    return snap


def exposition_text() -> str:
    """Per-replica labeled series appended to
    ``monitor.expose_text()``: the last federated report's attribution
    as ``slo_fleet_replica_*{replica="..."}`` gauges (label values
    through the exposition escaping — replica names are operator input, not
    trusted bytes). Empty until a report exists (the off-path
    contract)."""
    report = _LAST_REPORT[0]
    if not report:
        return ""
    from .exposition import escape_help, render_sample, sanitize_name

    rows = report.get("attribution") or []
    fields = (
        ("burn_fast", "worst-objective fast-window burn rate of this "
                      "replica (federation attribution)"),
        ("demand_estimate", "this replica's demand estimate from its "
                            "latest fresh frame"),
        ("alerting", "1 while this replica's worst fast burn is "
                     "at/over the warn threshold"),
    )
    lines = []
    for field, doc in fields:
        name = f"slo.fleet.replica.{field}"
        pname = sanitize_name(name)
        emitted = []
        for row in rows:
            v = row.get(field)
            if field == "alerting":
                v = 1 if v else 0
            if v is None:
                continue
            emitted.append(render_sample(
                name, {"replica": row["replica"]}, v))
        if emitted:
            lines.append(f"# HELP {pname} {escape_help(doc)}")
            lines.append(f"# TYPE {pname} gauge")
            lines.extend(emitted)
    return "\n".join(lines) + "\n" if lines else ""


def flight_block() -> Optional[dict]:
    """The flight record's ``federation`` block: cached state only —
    locally-published frame summaries + the last federated report. No
    transport reads, no backend reads (crash-path discipline)."""
    frames = local_frames()
    report = _LAST_REPORT[0]
    if not frames and report is None:
        return None
    return {
        "local_frames": {
            name: {"seq": f.get("seq"), "t": f.get("t"),
                   "draining": f.get("draining"),
                   "alerting": (f.get("slo") or {}).get("alerting"),
                   "demand_estimate": (f.get("autoscale") or {})
                   .get("demand_estimate")}
            for name, f in frames.items()},
        "last_report": report,
    }


def reset():
    """Drop accumulated state (monitor.reset)."""
    with _MU:
        _LOCAL_FRAMES.clear()
    _ACTIVE_VIEW[0] = None
    _LAST_REPORT[0] = None
