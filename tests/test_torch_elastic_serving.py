"""Port parity: the elastic serving controller
(``paddle_tpu_torch/distributed/fleet/elastic.py`` ``run_serving``
against ``paddle_tpu/distributed/fleet/elastic.py``), over the scripted
fake replicas of ``tests/test_elastic.py``'s ``TestServingElasticity``
and ``tests/test_federation.py``'s ``TestControllerActuation`` /
``TestControlLoopIsolation`` / ``TestBeatFileGC``.

The reference's suites move demand, burn and drain state from a test
thread on the wall clock. Here each script moves them at fixed ticks,
through ``run_serving``'s ``on_tick`` hook, and the controller runs
``max_ticks`` ticks on the test's own thread, so that both controllers
see the same inputs at the same ticks: the decision sequence (status,
reason, replica, in order), the final replica set, the stopped replicas
and the replicas told to drain are equal to the JAX controller's. The
cases that read wall time (heartbeat staleness) compare the decision
sequence without tick numbers. The bounded ``signals`` worker is a
thread by design; its cases run the port alone, with the reference's
bounds. The drain checkpoint and the worker's checkpointed state
(``save_state`` / ``finish_saves`` / ``load_state`` with the legacy
layout, ``elastic_run_index``) match the reference's; the training
restart loops (``run``, ``run_elastic``, ``run_adaptive``) raise, naming
ROADMAP A10.
"""
import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import heartbeat as jhb
from paddle_tpu.distributed.fleet import elastic as JE
from paddle_tpu.inference import failover as jfo
from paddle_tpu.monitor import federation as jfed
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.distributed import heartbeat as thb
from paddle_tpu_torch.distributed.fleet import elastic as TE
from paddle_tpu_torch.inference import failover as tfo
from paddle_tpu_torch.monitor import federation as tfed

SIDES = {"jax": (JE, jfed, jhb, jfo), "torch": (TE, tfed, thb, tfo)}


@pytest.fixture(autouse=True)
def _clean():
    for fed in (jfed, tfed):
        fed.reset()
    yield
    for fed in (jfed, tfed):
        fed.reset()
    for fo in (jfo, tfo):
        fo.set_active_coordinator(None)


class FakeReplica:
    """Controllable demand source with the engine's signal surface."""

    def __init__(self, demand=0.0, drain_safe=True):
        self.demand = demand
        self._drain_safe = drain_safe
        self.draining = False

    def autoscale_payload(self):
        return {"demand_estimate": self.demand,
                "desired_capacity_hint": int(np.ceil(self.demand)),
                "drain_safe": self._drain_safe}

    def begin_drain(self):
        self.draining = True


def mk_frame(fed, name, seq=1, *, demand=0.5, burn_fast=None,
             compliance=None, samples=64):
    objectives = {}
    if burn_fast is not None:
        objectives["ttft_p99_ms"] = {
            "compliance": compliance, "burn_fast": burn_fast,
            "burn_slow": burn_fast, "samples_slow": samples,
            "samples_fast": samples, "target_ratio": 0.99}
    return {"kind": fed.FRAME_KIND, "version": fed.FRAME_VERSION,
            "name": name, "seq": seq, "t": 1.7e9,
            "autoscale": {"demand_estimate": demand,
                          "desired_capacity_hint": int(np.ceil(demand)),
                          "drain_safe": True},
            "slo": {"objectives": objectives, "alerting": []},
            "tenants": {}, "requests": {"completed": samples},
            "draining": False, "drain_complete": True}


def drive(side, scenario, tmp_path=None):
    """Run one scenario (a ``SCENARIOS`` name or function) on one
    package: ``{"decisions", "replicas", "stopped", "drained", "out",
    "mgr", "ctx"}``."""
    E, fed, hb, fo = SIDES[side]
    ctx = {"E": E, "fed": fed, "hb": hb, "fo": fo, "replicas": {},
           "stopped": [], "tmp": tmp_path}
    sc = SCENARIOS[scenario] if isinstance(scenario, str) else scenario
    kw, spawn_fn, script = sc(ctx)

    def spawn(name):
        r = spawn_fn(name, ctx)
        ctx["replicas"][name] = r
        return r

    def stop(name, h):
        ctx["stopped"].append(name)

    def on_tick(t, live):
        step = script.get(t) if isinstance(script, dict) else script
        if step is not None:
            step(t, live, ctx)

    mgr = E.AdaptiveElasticManager(**ctx.get("mgr_kw", {}))
    ctx["mgr"] = mgr
    kw.setdefault("poll_interval", 0.0001)
    out = mgr.run_serving(spawn, stop, on_tick=on_tick, **kw)
    return {"decisions": [(s, d.get("reason"), d.get("replica"))
                          for _, s, d in mgr.events],
            "replicas": out["replicas"], "stopped": ctx["stopped"],
            "drained": sorted(n for n, r in ctx["replicas"].items()
                              if getattr(r, "draining", False)),
            "out": out, "mgr": mgr, "ctx": ctx}


def _set_demand(name, value):
    def step(t, live, ctx):
        ctx["replicas"][name].demand = value
    return step


def _scales_toward_hint(ctx):
    """replica0 carries the fleet's demand 2.6, then 0.2 from tick 10."""
    def spawn(name, ctx):
        return FakeReplica(demand=2.6 if name == "replica0" else 0.0)
    return (dict(min_replicas=1, max_replicas=3, max_ticks=20), spawn,
            {10: _set_demand("replica0", 0.2)})


def _recorded_signals(ctx):
    """The reference's recorded trace: 5 ticks at fleet demand 2.6, then
    0.2, through a user ``signals`` callable (bounded on a worker)."""
    demand_by_tick = [2.6] * 5 + [0.2] * 200
    tick = [0]

    def signals(name, h):
        if name == "replica0":
            t = min(tick[0], len(demand_by_tick) - 1)
            tick[0] += 1
            return {"demand_estimate": demand_by_tick[t],
                    "drain_safe": True}
        return {"demand_estimate": 0.0, "drain_safe": True}

    return (dict(signals=signals, min_replicas=1, max_replicas=4,
                 drain_timeout=5.0, max_ticks=40),
            lambda name, ctx: FakeReplica(), {})


def _burn_flat_demand(ctx):
    """A fleet latency fast burn at flat demand: +1 replica, stable."""
    view = ctx["fed"].FleetSLOView(staleness_s=120.0)
    view.ingest("replica0", mk_frame(ctx["fed"], "replica0", demand=0.2,
                                     burn_fast=30.0, compliance=0.5))
    return (dict(min_replicas=1, max_replicas=4, federation=view,
                 fleet_burn_scaling=True, max_ticks=30),
            lambda name, ctx: FakeReplica(), {})


def _burn_refuses_scale_in(ctx):
    """Demand scales the fleet to 3; demand falls while the fleet burns
    (scale-in refused); the burn clears (newest drained first)."""
    fed = ctx["fed"]
    view = fed.FleetSLOView(staleness_s=120.0)

    def ingest(seq, burn, demand0):
        def step(t, live, ctx):
            for n in ("replica0", "replica1", "replica2"):
                view.ingest(n, mk_frame(
                    fed, n, seq=seq,
                    demand=demand0 if n == "replica0" else 0.2,
                    burn_fast=burn, compliance=0.5 if burn else 1.0))
        return step

    ingest(1, 0.0, 2.5)(0, [], ctx)
    return (dict(min_replicas=1, max_replicas=4, federation=view,
                 fleet_burn_scaling=True, max_ticks=40),
            lambda name, ctx: FakeReplica(),
            {10: ingest(2, 30.0, 0.2), 25: ingest(3, 0.0, 0.2)})


def _frames_replace_signals(ctx):
    """replica0's fresh frame (demand 2.4) answers for it; the frameless
    replicas use the ``signals`` fallback."""
    view = ctx["fed"].FleetSLOView(staleness_s=120.0)
    view.ingest("replica0", mk_frame(ctx["fed"], "replica0", demand=2.4))
    calls = ctx.setdefault("calls", [])

    def signals(name, h):
        calls.append(name)
        return {"demand_estimate": 0.0, "drain_safe": True}

    return (dict(signals=signals, min_replicas=1, max_replicas=3,
                 federation=view, max_ticks=10),
            lambda name, ctx: FakeReplica(), {})


def _stuck_drain(max_replicas):
    def scenario(ctx):
        """replica1's drain hangs (drain_safe False): committed, it stops
        counting as capacity; it lands once its work finished."""
        feeder = FakeReplica(demand=1.6)

        def spawn(name, ctx):
            if name == "replica1":
                return FakeReplica(demand=0.0, drain_safe=False)
            return feeder if name == "replica0" else FakeReplica()

        def feed(v):
            def step(t, live, ctx):
                feeder.demand = v
            return step

        def unstick(t, live, ctx):
            ctx["replicas"]["replica1"]._drain_safe = True

        return (dict(min_replicas=1, max_replicas=max_replicas,
                     drain_timeout=0.0, max_ticks=40), spawn,
                {5: feed(0.2), 12: feed(1.6), 25: unstick})
    return scenario


def _stale_budget(ctx):
    """Replicas that never beat: replaced until the budget (2) is
    spent."""
    hb_dir = ctx["tmp"] / "hb"
    os.makedirs(hb_dir, exist_ok=True)
    ctx["mgr_kw"] = {"max_restarts": 2}
    return (dict(min_replicas=1, max_replicas=2, heartbeat_dir=str(hb_dir),
                 heartbeat_timeout=0.05, max_ticks=100_000),
            lambda name, ctx: FakeReplica(),
            lambda t, live, ctx: time.sleep(0.001))


def _stale_replaced(failover):
    def scenario(ctx):
        """Every replica beats each tick except replica1, which is
        force-stopped and replaced once its 1 s startup grace is spent
        (the healthy ones beat every few ms, far inside the timeout)."""
        hb_dir = str(ctx["tmp"] / "hb")
        os.makedirs(hb_dir, exist_ok=True)
        ctx["mgr_kw"] = {"max_restarts": 5}
        done = threading.Event()
        ctx["done"] = done

        def beat(t, live, ctx):
            for n in live:
                if n != "replica1":
                    ctx["hb"].touch_named(hb_dir, n)
            if "replica1" in ctx["stopped"] and len(ctx["replicas"]) >= 3:
                done.set()
            time.sleep(0.002)

        return (dict(min_replicas=2, max_replicas=3, heartbeat_dir=hb_dir,
                     heartbeat_timeout=1.0, max_ticks=100_000,
                     stop_event=done, failover=failover),
                lambda name, ctx: FakeReplica(), beat)
    return scenario


def _scale_in_sweeps_beats(ctx):
    """Scale-in retirement sweeps the retired replicas' beat files."""
    hb_dir = str(ctx["tmp"] / "hb")

    def spawn(name, ctx):
        ctx["hb"].touch_named(hb_dir, name)
        return FakeReplica(demand=2.2 if name == "replica0" else 0.0)

    def beat(t, live, ctx):
        for n in live:
            ctx["hb"].touch_named(hb_dir, n)
        if t == 10:
            ctx["replicas"]["replica0"].demand = 0.2

    return (dict(min_replicas=1, max_replicas=3, heartbeat_dir=hb_dir,
                 heartbeat_timeout=30.0, max_ticks=20), spawn, beat)


def _spawn_sweeps_prior_frame(ctx):
    """A prior incarnation's high-seq replica0 frame (demand 3.9) is
    swept at spawn and never feeds the controller."""
    hb_dir = str(ctx["tmp"] / "hb")
    kv = ctx["kv"] = FakeKV()
    ctx["hb"].publish_named("replica0", mk_frame(
        ctx["fed"], "replica0", seq=500, demand=3.9), dir_path=hb_dir,
        client=kv)
    view = ctx["fed"].FleetSLOView(hb_dir, client=kv, staleness_s=120.0)
    return (dict(min_replicas=1, max_replicas=4, heartbeat_dir=hb_dir,
                 federation=view, max_ticks=30),
            lambda name, ctx: FakeReplica(), {})


def _no_telemetry(ctx):
    return (dict(min_replicas=1, max_replicas=2, fleet_burn_scaling=True,
                 max_ticks=3), lambda name, ctx: FakeReplica(), {})


class FakeKV:
    def __init__(self):
        self.d = {}

    def key_value_set(self, k, v, allow_overwrite=False):
        self.d[k] = v

    def key_value_try_get(self, k):
        if k not in self.d:
            raise KeyError(k)
        return self.d[k]

    def key_value_delete(self, k):
        self.d.pop(k, None)


SCENARIOS = {
    "scales_toward_hint": _scales_toward_hint,
    "recorded_signals": _recorded_signals,
    "burn_flat_demand": _burn_flat_demand,
    "burn_refuses_scale_in": _burn_refuses_scale_in,
    "frames_replace_signals": _frames_replace_signals,
    "stuck_drain_excluded_from_capacity": _stuck_drain(3),
    "stuck_drain_total_fleet_bounded": _stuck_drain(2),
    "stale_budget": _stale_budget,
    "stale_replaced": _stale_replaced(False),
    "stale_replaced_failover": _stale_replaced(True),
    "scale_in_sweeps_beats": _scale_in_sweeps_beats,
    "spawn_sweeps_prior_frame": _spawn_sweeps_prior_frame,
    "burn_scaling_without_telemetry": _no_telemetry,
}

# what each scenario must decide (the reference's pins)
EXPECTED = {
    "scales_toward_hint": [
        ("restart", "spawn", "replica0"),
        ("restart", "scale-out", "replica1"),
        ("restart", "scale-out", "replica2"),
        ("restart", "scale-in", "replica2"),
        ("restart", "scale-in", "replica1"),
        ("exit", "max_ticks", None)],
    "recorded_signals": [
        ("restart", "spawn", "replica0"),
        ("restart", "scale-out", "replica1"),
        ("restart", "scale-out", "replica2"),
        ("restart", "scale-in", "replica2"),
        ("restart", "scale-in", "replica1"),
        ("exit", "max_ticks", None)],
    "burn_flat_demand": [
        ("restart", "spawn", "replica0"),
        ("restart", "burn-pressure", None),
        ("restart", "scale-out", "replica1"),
        ("exit", "max_ticks", None)],
    "burn_refuses_scale_in": [
        ("restart", "spawn", "replica0"),
        ("restart", "scale-out", "replica1"),
        ("restart", "scale-out", "replica2"),
        ("restart", "burn-pressure", None),
        ("restart", "burn-scale-in-refused", None),
        ("restart", "scale-in", "replica2"),
        ("restart", "scale-in", "replica1"),
        ("exit", "max_ticks", None)],
    "stuck_drain_excluded_from_capacity": [
        ("restart", "spawn", "replica0"),
        ("restart", "scale-out", "replica1"),
        ("restart", "drain-timeout", "replica1"),
        ("restart", "scale-out", "replica2"),
        ("restart", "scale-in", "replica1"),
        ("exit", "max_ticks", None)],
    "stuck_drain_total_fleet_bounded": [
        ("restart", "spawn", "replica0"),
        ("restart", "scale-out", "replica1"),
        ("restart", "drain-timeout", "replica1"),
        ("restart", "scale-in", "replica1"),
        ("restart", "scale-out", "replica2"),
        ("exit", "max_ticks", None)],
    "stale_budget": [
        ("restart", "spawn", "replica0"),
        ("restart", "stale-replace", "replica0"),
        ("restart", "scale-out", "replica1"),
        ("restart", "stale-replace", "replica1"),
        ("error", "restart budget exhausted", None)],
    "stale_replaced": [
        ("restart", "spawn", "replica0"),
        ("restart", "spawn", "replica1"),
        ("restart", "stale-replace", "replica1"),
        ("restart", "scale-out", "replica2"),
        ("exit", "stopped", None)],
    "scale_in_sweeps_beats": [
        ("restart", "spawn", "replica0"),
        ("restart", "scale-out", "replica1"),
        ("restart", "scale-out", "replica2"),
        ("restart", "scale-in", "replica2"),
        ("restart", "scale-in", "replica1"),
        ("exit", "max_ticks", None)],
    "spawn_sweeps_prior_frame": [
        ("restart", "spawn", "replica0"),
        ("exit", "max_ticks", None)],
    "burn_scaling_without_telemetry": [
        ("restart", "burn-scaling-no-telemetry", None),
        ("restart", "spawn", "replica0"),
        ("exit", "max_ticks", None)],
}
EXPECTED["stale_replaced_failover"] = EXPECTED["stale_replaced"]
EXPECTED["frames_replace_signals"] = EXPECTED["scales_toward_hint"][:3] + [
    ("exit", "max_ticks", None)]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decisions_match_the_reference(scenario, tmp_path):
    runs = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        d.mkdir()
        runs[side] = drive(side, scenario, d)
    t, j = runs["torch"], runs["jax"]
    for key in ("decisions", "replicas", "stopped", "drained"):
        assert t[key] == j[key], (key, t[key], j[key])
    assert t["decisions"] == EXPECTED[scenario]
    assert t["mgr"].restarts == j["mgr"].restarts


def test_scale_toward_hint_drains_before_stopping(tmp_path):
    r = drive("torch", "scales_toward_hint", tmp_path)
    assert r["stopped"] == ["replica2", "replica1"]
    assert r["replicas"] == ["replica0"]
    assert r["drained"] == ["replica1", "replica2"]


def test_frames_answer_for_their_replica(tmp_path):
    r = drive("torch", "frames_replace_signals", tmp_path)
    calls = r["ctx"]["calls"]
    assert "replica0" not in calls and "replica1" in calls


def test_burn_refusal_drains_nothing_while_burning(tmp_path):
    r = drive("torch", "burn_refuses_scale_in", tmp_path)
    # the refusal came at the burn; the scale-in only after it cleared
    reasons = [d[1] for d in r["decisions"]]
    assert reasons.index("burn-scale-in-refused") < reasons.index(
        "scale-in")
    assert r["stopped"] == ["replica2", "replica1"]


def test_beat_files_swept_on_scale_in_and_replace(tmp_path):
    r = drive("torch", "scale_in_sweeps_beats", tmp_path / "a")
    hb_dir = r["ctx"]["tmp"] / "hb"
    assert sorted(os.listdir(hb_dir)) == ["replica0.alive"]
    for name in r["stopped"]:
        assert thb.stale_names(str(hb_dir), [name], timeout=0.001) == {}
    r = drive("torch", "stale_replaced", tmp_path / "b")
    assert "replica0.alive" in os.listdir(r["ctx"]["tmp"] / "hb")
    assert "replica1.alive" not in os.listdir(r["ctx"]["tmp"] / "hb")


def test_spawn_sweeps_a_prior_incarnations_frame(tmp_path):
    r = drive("torch", "spawn_sweeps_prior_frame", tmp_path)
    assert not (r["ctx"]["tmp"] / "hb" / "replica0.alive").exists()
    assert "pt_named/replica0" not in r["ctx"]["kv"].d
    assert r["replicas"] == ["replica0"]


def test_failover_ownership_matches_the_reference(tmp_path):
    """With failover on the controller owns a coordinator, registers it
    for the ``/fleet/serving`` failover block, consumes the stale
    replica's journal and reports the coordinator's snapshot."""
    snaps = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        d.mkdir()
        r = drive(side, "stale_replaced_failover", d)
        coord = r["mgr"].failover_coordinator
        assert SIDES[side][3].active_coordinator() is coord
        assert r["out"]["failover"] == coord.snapshot()
        snaps[side] = r["out"]["failover"]
        view = SIDES[side][1].fleet_serving_snapshot()
        assert view["failover"] == coord.snapshot()
    assert snaps["torch"] == snaps["jax"]


def test_drain_wait_never_stops_an_undrainable_replica():
    stuck = FakeReplica(drain_safe=False)
    stopped = []
    ok = TE.AdaptiveElasticManager()._drain_and_stop(
        "r", stuck, signals=lambda n, h: h.autoscale_payload(),
        drain=lambda n, h: h.begin_drain(),
        stop=lambda n, h: stopped.append(n),
        drain_timeout=0.05, poll_interval=0.01)
    assert ok is False and stopped == [] and stuck.draining


def test_stop_event_interrupts_the_drain_wait():
    stuck = FakeReplica(drain_safe=False)
    ev = threading.Event()
    out = []

    def run():
        out.append(TE.AdaptiveElasticManager()._drain_and_stop(
            "r", stuck, signals=lambda n, h: h.autoscale_payload(),
            drain=lambda n, h: h.begin_drain(), stop=lambda n, h: None,
            drain_timeout=60.0, poll_interval=0.01, stop_event=ev))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    time.sleep(0.1)
    assert th.is_alive()
    ev.set()
    th.join(timeout=2)
    assert not th.is_alive() and out == [False]


def test_pre_drain_frame_never_authorizes_the_stop():
    """A fresh frame that does not yet reflect the drain must not stand
    in for ``drain_safe``: the signals fallback decides."""
    view = tfed.FleetSLOView(staleness_s=60.0)
    view.ingest("r", mk_frame(tfed, "r", demand=0.0))   # draining False
    stuck = FakeReplica(drain_safe=False)
    ok = TE.AdaptiveElasticManager()._drain_and_stop(
        "r", stuck, signals=lambda n, h: h.autoscale_payload(),
        drain=lambda n, h: h.begin_drain(), stop=lambda n, h: None,
        drain_timeout=0.05, poll_interval=0.01, view=view)
    assert ok is False


# ---------------------------------------------------------------------------
# the bounded signals worker (threads; the port alone)
# ---------------------------------------------------------------------------

def test_bounded_signals_frozen_call_skipped_next_time():
    frozen = threading.Event()
    calls = []

    def signals(name, h):
        calls.append(name)
        if name == "stuck":
            frozen.wait()
        return {"demand_estimate": 1.0}

    b = TE._BoundedSignals(signals, timeout=0.2)
    t0 = time.monotonic()
    assert b("stuck", None) is None
    assert 0.15 <= time.monotonic() - t0 < 2.0
    t0 = time.monotonic()
    assert b("stuck", None) is None           # skipped instantly
    assert time.monotonic() - t0 < 0.05
    assert b("ok", None) == {"demand_estimate": 1.0}
    assert calls.count("stuck") == 1
    frozen.set()


def test_bounded_signals_late_result_and_passthrough():
    gate = threading.Event()
    b = TE._BoundedSignals(lambda n, h: gate.wait(0.4) and None
                           or {"demand_estimate": 2.0}, timeout=0.1)
    assert b("r", None) is None
    gate.set()
    time.sleep(0.5)
    assert b("r", None) == {"demand_estimate": 2.0}
    assert TE._BoundedSignals(lambda n, h: {"x": 1}, None)("r", None) == {
        "x": 1}


def test_bounded_signals_reuses_one_worker_and_retires():
    idents = []

    def signals(name, h):
        idents.append(threading.get_ident())
        return {"demand_estimate": 1.0}

    b = TE._BoundedSignals(signals, timeout=1.0)
    for _ in range(5):
        assert b("r", None) == {"demand_estimate": 1.0}
    assert len(set(idents)) == 1 and idents[0] != threading.get_ident()
    th = b._workers["r"][0]
    b.retire("r")
    th.join(timeout=2)
    assert not th.is_alive() and "r" not in b._workers


def test_default_signals_inline_user_signals_bounded(monkeypatch):
    timeouts = []
    real = TE._BoundedSignals

    class Spy(real):
        def __init__(self, fn, timeout):
            timeouts.append(timeout)
            super().__init__(fn, timeout)

    monkeypatch.setattr(TE, "_BoundedSignals", Spy)
    for signals in (None, lambda n, h: {"demand_estimate": 0.0,
                                        "drain_safe": True}):
        TE.AdaptiveElasticManager().run_serving(
            lambda n: FakeReplica(), lambda n, h: None, signals=signals,
            min_replicas=1, max_replicas=1, poll_interval=0.001,
            max_ticks=3)
    assert timeouts == [None, 5.0]


def test_frozen_replica_does_not_stall_the_fleet():
    """One replica whose signals hang delays a tick by the bound once;
    the demand rise on replica0 still scales the fleet out."""
    frozen = threading.Event()
    demand0 = [1.2]

    def signals(name, h):
        if name == "replica1":
            frozen.wait()
            return None
        return {"demand_estimate": demand0[0], "drain_safe": True}

    replicas = {}

    def spawn(name):
        replicas[name] = FakeReplica()
        return replicas[name]

    def on_tick(t, live):
        if t == 5:
            demand0[0] = 2.5
        if len(replicas) >= 3:
            done.set()

    done = threading.Event()
    t0 = time.monotonic()
    TE.AdaptiveElasticManager().run_serving(
        spawn, lambda n, h: None, signals=signals, min_replicas=2,
        max_replicas=3, poll_interval=0.01, signal_timeout=0.2,
        max_ticks=500, stop_event=done, on_tick=on_tick)
    frozen.set()
    assert len(replicas) == 3
    assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# validation and the training loops' entry points
# ---------------------------------------------------------------------------

def test_bounds_and_protocol_codes():
    with pytest.raises(ValueError, match="min_replicas"):
        TE.AdaptiveElasticManager().run_serving(
            lambda n: None, lambda n, h: None, min_replicas=3,
            max_replicas=2)
    assert (TE.RESCALE_RC, TE.PEER_FAILURE_RC) == (JE.RESCALE_RC,
                                                   JE.PEER_FAILURE_RC)
    assert {k: getattr(TE.ElasticStatus, k) for k in
            ("COMPLETED", "RESTART", "ERROR", "EXIT")} == \
        {k: getattr(JE.ElasticStatus, k) for k in
         ("COMPLETED", "RESTART", "ERROR", "EXIT")}


def _completing_launcher(calls):
    def launch(script, script_args=(), nproc_per_node=1, extra_env=None,
               **kw):
        calls.append((script, nproc_per_node,
                      (extra_env or {}).get("PADDLE_ELASTIC_RUN")))
        return 0
    return launch


@pytest.mark.parametrize("call", ["run", "run_elastic", "run_adaptive"])
def test_training_paths_raise_naming_a10(call, monkeypatch):
    """Once the pin on the unported training loops (ROADMAP A10), now
    ported (``tests/test_torch_elastic_launch.py`` holds them to the
    reference): each entry point launches the world once through the
    launcher (``run_elastic`` through the default one, the port's
    ``distributed.launch``), exporting run index 0, and returns 0 with
    the reference's COMPLETED event when the world completes."""
    import importlib
    calls = []
    launcher = _completing_launcher(calls)
    if call == "run":
        mgr = TE.ElasticManager(launcher=launcher)
        assert mgr.run("train.py", nproc_per_node=2) == 0
    elif call == "run_adaptive":
        mgr = TE.AdaptiveElasticManager(launcher=launcher)
        assert mgr.run_adaptive("train.py", nproc_per_node=2) == 0
    else:
        main = importlib.import_module(
            "paddle_tpu_torch.distributed.launch.main")
        monkeypatch.setattr(main, "launch", launcher)
        assert TE.run_elastic("train.py", nproc_per_node=2) == 0
        mgr = None
    assert calls == [("train.py", 2, "0")]
    if mgr is not None:
        assert [s for _, s, _ in mgr.events] == [
            JE.ElasticStatus.COMPLETED]


# ---------------------------------------------------------------------------
# the elastic worker's checkpointed state and the drain checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture
def ckpt_env(tmp_path, monkeypatch):
    """``PADDLE_ELASTIC_CKPT_DIR`` per package; each package's per-root
    managers (each with a SIGTERM hook) dropped after the test."""
    roots = {side: tmp_path / f"ck_{side}" for side in SIDES}
    for E, *_ in SIDES.values():
        E._MANAGERS.clear()
    yield roots, monkeypatch
    for E, *_ in SIDES.values():
        for mgr in E._MANAGERS.values():
            mgr.remove_preemption_hook()
        E._MANAGERS.clear()


def _w(side, value):
    import jax.numpy as jnp
    import torch
    return jnp.full((4,), value) if side == "jax" else \
        torch.full((4,), value)


def _values(x):
    return np.asarray(x).tolist()


def test_elastic_run_index_reads_the_run(monkeypatch):
    monkeypatch.delenv("PADDLE_ELASTIC_RUN", raising=False)
    assert TE.elastic_run_index() == JE.elastic_run_index() == 0
    monkeypatch.setenv("PADDLE_ELASTIC_RUN", "3")
    assert TE.elastic_run_index() == JE.elastic_run_index() == 3


def test_save_state_load_state_match_the_reference(ckpt_env):
    """Four async saves with ``PADDLE_ELASTIC_KEEP_CKPTS=2``, joined by
    ``finish_saves``: the same retained steps and the same resume point
    as the reference's."""
    roots, mp = ckpt_env
    mp.setenv("PADDLE_ELASTIC_KEEP_CKPTS", "2")
    out = {}
    for side, (E, *_) in SIDES.items():
        mp.setenv("PADDLE_ELASTIC_CKPT_DIR", str(roots[side]))
        pending = None
        for step in range(4):
            pending = E.save_state(step + 1, {"w": _w(side, float(step)),
                                              "step": step + 1},
                                   prev_handle=pending)
        assert E.finish_saves(pending)
        start, state = E.load_state({"w": _w(side, 0.0), "step": 0})
        out[side] = (start, _values(state["w"]), state["step"],
                     sorted(os.listdir(roots[side])))
    assert out["torch"] == out["jax"] == (4, [3.0] * 4, 4,
                                          ["step_3", "step_4"])


def test_finish_saves_and_a_fresh_start(ckpt_env, monkeypatch):
    roots, mp = ckpt_env
    mp.delenv("PADDLE_ELASTIC_CKPT_DIR", raising=False)
    import torch
    tmpl = {"w": torch.zeros(4)}
    # no checkpoint root: nothing saved, a fresh start
    assert TE.save_state(1, tmpl) is None
    assert TE.load_state(tmpl) == (0, tmpl)
    assert not TE.finish_saves(None)
    mp.setenv("PADDLE_ELASTIC_CKPT_DIR", str(roots["torch"]))
    assert TE.load_state(tmpl) == (0, tmpl)         # no dir yet
    mgr = TE.save_state(5, {"w": torch.full((4,), 5.0)})
    assert mgr is TE._MANAGERS[str(roots["torch"])]
    assert TE.finish_saves(mgr) and mgr.latest_step() == 5
    assert TE.save_state(6, {"w": torch.full((4,), 6.0)},
                         blocking=True) is None
    start, state = TE.load_state({"w": torch.zeros(4)})
    assert start == 6 and _values(state["w"]) == [6.0] * 4


def test_load_state_legacy_layout_and_uncommitted_newest(ckpt_env):
    """The pre-commit layout (``latest`` naming a markerless ``step<N>``
    dir) still resumes; an uncommitted newest step is skipped. Both as
    the reference."""
    roots, mp = ckpt_env
    from paddle_tpu.distributed import checkpoint as JC
    from paddle_tpu_torch.distributed import checkpoint as TC
    out = {}
    for side, (E, *_) in SIDES.items():
        C = JC if side == "jax" else TC
        root = roots[side]
        mp.setenv("PADDLE_ELASTIC_CKPT_DIR", str(root))
        C.save_state_dict({"w": _w(side, 9.0)}, str(root / "step9"))
        for marker in ("COMMIT", "checkpoint.manifest"):
            os.remove(str(root / "step9" / marker))
        (root / "latest").write_text("9")
        legacy = E.load_state({"w": _w(side, 0.0)})
        mp.setenv("PADDLE_ELASTIC_KEEP_CKPTS", "3")
        E._MANAGERS.clear()
        root2 = root.parent / f"new_{side}"
        mp.setenv("PADDLE_ELASTIC_CKPT_DIR", str(root2))
        for step in (1, 2):
            E.save_state(step, {"w": _w(side, float(step))}, blocking=True)
        os.remove(str(root2 / "step_2" / "COMMIT"))
        newest = E.load_state({"w": _w(side, 0.0)})
        out[side] = [(s, _values(st["w"])) for s, st in (legacy, newest)]
    assert out["torch"] == out["jax"] == [(9, [9.0] * 4), (1, [1.0] * 4)]


def _scale_in_with_checkpoint(ctx):
    """``_scales_toward_hint`` with a drain checkpoint of the replica's
    state under ``ckpt_dir``."""
    kw, spawn, script = _scales_toward_hint(ctx)
    side = "jax" if ctx["E"] is JE else "torch"
    kw.update(state_fn=lambda: {"w": _w(side, 7.0), "step": 7},
              ckpt_dir=str(ctx["tmp"] / f"drain_{side}"))
    return kw, spawn, script


def test_drain_checkpoint_commits_before_the_stop(ckpt_env, tmp_path):
    """A scale-in checkpoints ``state_fn()`` (one committed step a
    drained replica) before the drain: the decisions, the stops and the
    committed checkpoints are the reference's."""
    runs = {side: drive(side, _scale_in_with_checkpoint, tmp_path)
            for side in SIDES}
    t, j = runs["torch"], runs["jax"]
    assert (t["decisions"], t["stopped"], t["drained"]) == \
        (j["decisions"], j["stopped"], j["drained"])
    assert t["stopped"]
    import jax.numpy as jnp
    import torch
    from paddle_tpu.distributed.checkpoint import CheckpointManager as JCM
    from paddle_tpu_torch.distributed.checkpoint import \
        CheckpointManager as TCM
    got = {}
    for side, Mgr, tmpl in (("jax", JCM, {"w": jnp.zeros(4), "step": 0}),
                            ("torch", TCM, {"w": torch.zeros(4),
                                            "step": 0})):
        mgr = Mgr(str(tmp_path / f"drain_{side}"))
        got[side] = (mgr.all_steps(), mgr.restore_latest(tmpl),
                     _values(tmpl["w"]), tmpl["step"])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == list(range(1, len(t["stopped"]) + 1))
    assert got["torch"][2:] == ([7.0] * 4, 7)


def test_kill_after_the_drain_checkpoint_leaves_it_committed(tmp_path):
    """A kill between the drain checkpoint's commit and the replica's
    stop (``drain.stop``): exactly the committed step, restorable."""
    import subprocess
    import sys
    import torch
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.testing import faults
    root = str(tmp_path / "ckpt")
    child = (
        "import sys, torch\n"
        "from paddle_tpu_torch.distributed.fleet.elastic import (\n"
        "    AdaptiveElasticManager)\n"
        "class H:\n"
        "    def autoscale_payload(self):\n"
        "        return {'drain_safe': True, 'demand_estimate': 0.0}\n"
        "    def begin_drain(self):\n"
        "        pass\n"
        "state = {'w': torch.arange(6, dtype=torch.float32), 'step': 7}\n"
        "AdaptiveElasticManager()._drain_and_stop('replica0', H(),\n"
        "    signals=lambda n, x: x.autoscale_payload(),\n"
        "    drain=lambda n, x: x.begin_drain(),\n"
        "    stop=lambda n, x: None, drain_timeout=5,\n"
        "    poll_interval=0.01, state_fn=lambda: state,\n"
        "    ckpt_dir=sys.argv[1])\n"
        "print('SURVIVED')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", child, root], capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
                 FLAGS_fault_injection="drain.stop:kill:1"))
    assert r.returncode == faults.KILL_EXIT_CODE, (r.returncode,
                                                   r.stderr[-800:])
    assert "SURVIVED" not in r.stdout
    mgr = CheckpointManager(root)
    assert mgr.latest_step() == 1
    target = {"w": torch.zeros(6), "step": 0}
    assert mgr.restore_latest(target) == 1
    assert torch.equal(target["w"], torch.arange(6, dtype=torch.float32))
    assert target["step"] == 7


def test_burn_scaling_flag_is_the_controllers_default(tmp_path):
    """``FLAGS_serving_fleet_burn_scaling`` is ``run_serving``'s
    ``fleet_burn_scaling`` default: on, with a heartbeat directory, the
    controller builds its own view over the frames there and acts on
    their burn."""
    d = str(tmp_path)

    seen = []

    def publish(t, live):
        # replica0 publishes a burning frame each tick (spawn swept any
        # earlier one); the controller's view is registered while it runs
        thb.publish_named("replica0", mk_frame(
            tfed, "replica0", seq=t, demand=0.2, burn_fast=30.0,
            compliance=0.5), dir_path=d)
        seen.append(tfed.active_view() is not None)

    saved = TF.flag_value("serving_fleet_burn_scaling")
    try:
        for on in (False, True):
            TF.set_flags({"FLAGS_serving_fleet_burn_scaling": on})
            mgr = TE.AdaptiveElasticManager()
            out = mgr.run_serving(
                lambda n: FakeReplica(), lambda n, h: None,
                min_replicas=1, max_replicas=3, heartbeat_dir=d,
                poll_interval=0.0001, max_ticks=5, on_tick=publish)
            reasons = [x[2].get("reason") for x in mgr.events]
            assert ("burn-pressure" in reasons) is on
            assert len(out["replicas"]) == (2 if on else 1)
            assert set(seen) == {on}
            seen.clear()
            tfed.reset()
    finally:
        TF.set_flags({"FLAGS_serving_fleet_burn_scaling": saved})
