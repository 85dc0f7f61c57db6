"""Port parity: fleet SLO federation (``paddle_tpu_torch/monitor/
federation.py`` against ``paddle_tpu/monitor/federation.py``), mirroring
``tests/test_federation.py``'s ``TestFrameSchema`` / ``TestStaleness`` /
``TestFederateMath`` / ``TestSurfaces``.

Host bookkeeping, so every comparison is exact (``==`` on the JSON-safe
payloads):

- ``build_frame`` of both engines after one shared serve (``llama_tiny``
  float32, weights carried across, one fake clock, monitor on, each
  program's FLOPs set equal) is equal, its timestamp ``t`` excepted;
- ``federate`` and ``FleetSLOView`` (ingest, staleness by seq change,
  version gating, forget, poll) give equal reports on the same synthetic
  frames and the same reader clock;
- frames that the JAX ``FramePublisher`` writes into a directory, read by
  the port's ``FleetSLOView``, and the reverse, give equal
  ``fleet_report``s; under one fake clock the two publishers' beat files
  are byte-identical;
- ``exposition_text`` and ``flight_block`` are equal; ``sweep`` and
  ``forget`` leave nothing behind, on the file and the key-value legs
  (``FakeKV``, an explicit ``client=``);
- the engine hook: ``publish_frames`` publishes on the step tick (the
  frame is the liveness beat), ``begin_drain`` force-publishes, and with
  the monitor off the opt-in still publishes and registers nothing.
"""
import json
import os
import time

import numpy as np
import pytest

from _torch_monitor_common import (FakeClock, JM, TM, equal_flops,
                                   patch_clock, reset_both, set_monitor,
                                   tiny_pair)
from paddle_tpu.distributed import heartbeat as jhb
from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.inference.engine import EngineStats as JStats
from paddle_tpu.models import llama as JL
from paddle_tpu.monitor import federation as jfed
from paddle_tpu_torch.distributed import heartbeat as thb
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.inference.engine import EngineStats as TStats
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.monitor import federation as tfed

SIDES = {"jax": (jfed, jhb), "torch": (tfed, thb)}


@pytest.fixture(autouse=True)
def _clean():
    jfed.reset()
    tfed.reset()
    yield
    jfed.reset()
    tfed.reset()


@pytest.fixture
def mon():
    reset_both()
    set_monitor(True)
    yield
    set_monitor(False)
    reset_both()


class FakeKV:
    def __init__(self):
        self.d = {}

    def key_value_set(self, k, v, allow_overwrite=False):
        if not allow_overwrite and k in self.d:
            raise RuntimeError(f"key exists: {k}")
        self.d[k] = v

    def key_value_try_get(self, k):
        if k not in self.d:
            raise KeyError(k)
        return self.d[k]

    def key_value_delete(self, k):
        self.d.pop(k, None)


def mk_frame(name, seq=1, *, demand=0.5, burn_fast=None, compliance=None,
             samples=32, objective="ttft_p99_ms", draining=False,
             drain_safe=True, tenants=None, requests=None,
             version=jfed.FRAME_VERSION):
    """A synthetic frame with one objective's slo row (the JAX suite's
    ``_mk_frame``)."""
    objectives = {}
    if burn_fast is not None or compliance is not None:
        objectives[objective] = {
            "compliance": compliance, "burn_fast": burn_fast,
            "burn_slow": burn_fast, "samples_slow": samples,
            "samples_fast": samples, "target_ratio": 0.99}
    return {
        "kind": jfed.FRAME_KIND, "version": version, "name": name,
        "seq": seq, "t": 1.7e9,
        "autoscale": {"demand_estimate": demand,
                      "desired_capacity_hint": int(np.ceil(demand)),
                      "queue_depth": 0, "live_slots": 0,
                      "drain_safe": drain_safe},
        "slo": {"objectives": objectives,
                "alerting": [objective] if (burn_fast or 0) >= 14.4
                else []},
        "tenants": tenants or {},
        "requests": requests or {"completed": samples},
        "draining": draining, "drain_complete": drain_safe,
    }


class StubEngine:
    """Engine-shaped stand-in for the publisher and surface cases."""

    def __init__(self, stats_cls, demand=0.4, draining=False):
        self.stats = stats_cls()
        self.stats.admitted = self.stats.completed = 2
        self.draining = draining
        self.drain_complete = not draining
        self._demand = demand

    def autoscale_payload(self):
        return {"demand_estimate": self._demand,
                "desired_capacity_hint": int(np.ceil(self._demand)),
                "queue_depth": 0, "live_slots": 0, "drain_safe": True}


STATS = {"jax": JStats, "torch": TStats}


def test_constants_are_the_references():
    assert (tfed.FRAME_KIND, tfed.FRAME_VERSION) == \
        (jfed.FRAME_KIND, jfed.FRAME_VERSION)
    assert sorted(tfed.__all__) == sorted(jfed.__all__)


# ---------------------------------------------------------------------------
# frames of real engines
# ---------------------------------------------------------------------------

def _serve(eng, req_cls, clock):
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(req_cls(rid=i, prompt=rng.integers(0, 256, (5 + i,))
                           .astype(np.int32), max_new_tokens=4,
                           tenant="a" if i % 2 else "b"))
    while eng.step():
        clock.advance(0.01)


def test_build_frame_equal_after_one_shared_serve(mon, monkeypatch):
    clock = patch_clock(monkeypatch, FakeClock())
    for m in (jfed, tfed):
        monkeypatch.setattr(m, "time", clock)
    # the tenants' model FLOPs: each program's FLOPs set equal on both
    # sides (ROADMAP C, the reference counts a scan body once)
    equal_flops(monkeypatch)
    jcfg, jp, tcfg, tp = tiny_pair(2)
    kw = dict(num_slots=2, max_len=32, page_size=4, decode_chunk=3)
    frames = {}
    for side in ("torch", "jax"):
        JM.reset()
        TM.reset()
        clock.now = 1000.0
        if side == "torch":
            eng = ServingEngine(TL, tp, tcfg, device="cpu", **kw)
            _serve(eng, Request, clock)
        else:
            eng = JEngine(JL, jp, jcfg, **kw)
            _serve(eng, JRequest, clock)
        frames[side] = SIDES[side][0].build_frame(eng, name="r0", seq=3)
        json.dumps(frames[side])
    for f in frames.values():
        f.pop("t")
    assert frames["torch"] == frames["jax"]
    f = frames["torch"]
    assert f["requests"]["completed"] == 3 and f["draining"] is False
    assert f["autoscale"]["drain_safe"] is True
    assert {"ttft_p99_ms", "availability"} <= set(f["slo"]["objectives"])
    assert set(f["tenants"]) >= {"a", "b"}


def test_engine_hook_publishes_and_frame_is_the_beat(mon, tmp_path):
    d = str(tmp_path)
    cfg = TL.llama_tiny()
    eng = ServingEngine(TL, TL.init_params(cfg, device="cpu"), cfg,
                        device="cpu", num_slots=2, max_len=32, page_size=4,
                        decode_chunk=3)
    pub = eng.publish_frames("replica0", d, min_interval_s=0.0)
    assert pub is eng._frame_pub and pub.seq == 1      # attach publishes
    eng.run([Request(rid=i, prompt=np.arange(5, dtype=np.int32) + i,
                     max_new_tokens=4) for i in range(2)])
    frame = thb.read_named("replica0", dir_path=d)
    assert frame is not None and frame["seq"] >= 2
    assert frame["requests"]["completed"] == 2
    # the frame IS the liveness beat
    assert thb.stale_names(d, ["replica0"], timeout=30.0) == {}
    assert TM.snapshot()["counters"]["federation.frames.published"] >= 2
    # a JAX view reads the port replica's frame
    view = jfed.FleetSLOView(d, staleness_s=60.0)
    assert view.poll(["replica0"]) == 1
    assert view.fleet_report(["replica0"])["requests"]["completed"] == 2


def test_begin_drain_force_publishes(tmp_path):
    d = str(tmp_path)
    cfg = TL.llama_tiny()
    eng = ServingEngine(TL, TL.init_params(cfg, device="cpu"), cfg,
                        device="cpu", num_slots=2, max_len=32, page_size=4)
    eng.publish_frames("replica0", d, min_interval_s=1e9)
    assert thb.read_named("replica0", dir_path=d)["draining"] is False
    eng.begin_drain()
    assert thb.read_named("replica0", dir_path=d)["draining"] is True
    seq = eng._frame_pub.seq
    eng.begin_drain()                   # no transition: rate-limited
    assert eng._frame_pub.seq == seq


@pytest.mark.parametrize("side", sorted(SIDES))
def test_monitor_off_publishes_but_registers_nothing(side, tmp_path):
    fed, hb = SIDES[side]
    reset_both()
    set_monitor(False)
    d = str(tmp_path)
    pub = fed.FramePublisher("replica0", d, min_interval_s=0.0)
    assert pub.maybe_publish(StubEngine(STATS[side])) is not None
    assert hb.read_named("replica0", dir_path=d) is not None
    fed.FleetSLOView(d, staleness_s=60.0).fleet_report(["replica0"])
    assert (TM if side == "torch" else JM).snapshot() == {}


@pytest.mark.parametrize("side", sorted(SIDES))
def test_publisher_seq_rate_limit_and_force(side):
    fed, _ = SIDES[side]
    clock = [0.0]
    pub = fed.FramePublisher("r0", min_interval_s=1.0, local_only=True,
                             _time_fn=lambda: clock[0])
    eng = StubEngine(STATS[side])
    assert pub.maybe_publish(eng)["seq"] == 1
    assert pub.maybe_publish(eng) is None          # rate-limited
    assert pub.maybe_publish(eng, force=True)["seq"] == 2
    clock[0] = 5.0
    assert pub.maybe_publish(eng)["seq"] == 3
    assert fed.local_frames()["r0"]["seq"] == 3


# ---------------------------------------------------------------------------
# federation math and the view, on the same frames
# ---------------------------------------------------------------------------

FRAME_SETS = {
    "weighted": {
        "a": mk_frame("a", compliance=0.9, burn_fast=10.0, samples=100),
        "b": mk_frame("b", compliance=0.99, burn_fast=1.0, samples=50)},
    "none_windows": {
        "a": mk_frame("a"),
        "b": mk_frame("b", compliance=None, burn_fast=None, samples=0)},
    "alerting": {
        "a": mk_frame("a", burn_fast=20.0, compliance=0.5, samples=64)},
    "availability_only": {
        "a": mk_frame("a", burn_fast=20.0, compliance=0.5, samples=64,
                      objective="availability")},
    "attribution": {
        "healthy": mk_frame("healthy", compliance=1.0, burn_fast=0.0,
                            samples=64),
        "burning": mk_frame("burning", compliance=0.5, burn_fast=50.0,
                            samples=64),
        "quiet": mk_frame("quiet")},
    "sums": {
        "a": mk_frame("a", demand=0.6,
                      tenants={"t1": {"requests": 3, "decode_tokens": 10}},
                      requests={"completed": 5, "shed": 1}),
        "b": mk_frame("b", demand=0.7,
                      tenants={"t1": {"requests": 2},
                               "t2": {"requests": 9}},
                      requests={"completed": 7, "expired": 2})},
    "malformed": {
        "a": dict(mk_frame("a", burn_fast=3.0, compliance=0.9),
                  autoscale={"demand_estimate": "x"}, tenants="junk"),
        "b": dict(mk_frame("b"), slo="x", requests={"completed": float(
            "nan")})},
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(FRAME_SETS))
def test_federate_matches_the_reference(name):
    frames = FRAME_SETS[name]
    t, j = tfed.federate(frames), jfed.federate(frames)
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)


def test_federate_math_pins():
    obj = tfed.federate(FRAME_SETS["weighted"])["objectives"]["ttft_p99_ms"]
    assert obj["compliance"] == pytest.approx(0.93)
    assert obj["burn_slow"] == pytest.approx(7.0)
    assert (obj["samples_slow"], obj["replicas_reporting"]) == (150, 2)
    rep = tfed.federate(FRAME_SETS["availability_only"])
    assert rep["alerting"] == ["availability"] and rep["alerting_load"] == []
    att = tfed.federate(FRAME_SETS["attribution"])["attribution"]
    assert [a["replica"] for a in att] == ["burning", "healthy", "quiet"]
    rep = tfed.federate(FRAME_SETS["sums"])
    assert rep["tenants"]["t1"] == {"requests": 5, "decode_tokens": 10}
    assert rep["demand"]["desired_capacity_hint"] == 2


def _view_script(fed, clock):
    """Ingest, age, re-ingest and forget on one view; the report after
    each step."""
    view = fed.FleetSLOView(staleness_s=5.0, _time_fn=lambda: clock[0])
    out = []
    view.ingest("a", mk_frame("a", seq=1, burn_fast=20.0, compliance=0.5,
                              demand=0.8))
    view.ingest("b", mk_frame("b", seq=1, burn_fast=1.0, compliance=1.0))
    out.append(view.fleet_report(poll=False))
    clock[0] = 4.0
    view.ingest("a", mk_frame("a", seq=1))        # same seq: age kept
    view.ingest("b", mk_frame("b", seq=2, demand=1.4))
    out.append(view.fleet_report(poll=False))
    clock[0] = 6.0                                # a is stale now
    out.append(view.fleet_report(poll=False))
    out.append(view.frames(names=["b", "absent"]))
    out.append([view.ingest("c", mk_frame("c", version=9)),
                view.ingest("c", {"kind": "other"}),
                view.ingest("c", mk_frame("c", version="junk")),
                view.ingest("c", dict(mk_frame("c"), seq=float("nan")))])
    view.forget("b")
    out.append(view.fleet_report(poll=False))
    out.append(view.burn_alerting())
    return out


def test_view_staleness_and_gating_match_the_reference():
    t = _view_script(tfed, [0.0])
    j = _view_script(jfed, [0.0])
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert t[2]["staleness"]["stale"] == {"a": 6.0}
    assert t[4] == [False, False, False, False]
    assert t[5]["replicas"] == [] and t[5]["staleness"]["stale"] == {
        "a": 6.0}


# ---------------------------------------------------------------------------
# the transport, both ways
# ---------------------------------------------------------------------------

def _slo_fn(burn, compliance):
    def fn():
        return {"objectives": {"ttft_p99_ms": {
            "compliance": compliance, "burn_fast": burn, "burn_slow": burn,
            "samples_slow": 40, "samples_fast": 16, "target_ratio": 0.99}},
            "alerting": ["ttft_p99_ms"] if burn >= 14.4 else []}
    return fn


REPLICAS = {"replica0": (0.6, 20.0, 0.5), "replica1": (1.3, 10.0, 0.98)}


def _publish(side, d, client=None):
    fed, _ = SIDES[side]
    for name, (demand, burn, comp) in REPLICAS.items():
        pub = fed.FramePublisher(name, d, client=client,
                                 min_interval_s=0.0,
                                 slo_fn=_slo_fn(burn, comp))
        eng = StubEngine(STATS[side], demand=demand)
        pub.maybe_publish(eng)
        pub.maybe_publish(eng)                  # seq 2


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_views_read_the_other_packages_frames(writer, reader, tmp_path):
    d = str(tmp_path)
    _publish(writer, d)
    reports = {}
    for side in ("jax", "torch"):
        view = SIDES[side][0].FleetSLOView(d, staleness_s=60.0)
        reports[side] = view.fleet_report(sorted(REPLICAS))
    assert json.dumps(reports[reader], sort_keys=True) == \
        json.dumps(reports[writer], sort_keys=True)
    rep = reports[reader]
    assert rep["replicas"] == sorted(REPLICAS)
    assert rep["alerting"] == ["ttft_p99_ms"]
    assert rep["attribution"][0]["replica"] == "replica0"
    assert rep["demand"]["demand_estimate_sum"] == pytest.approx(1.9)


def test_beat_files_are_byte_identical_under_one_clock(tmp_path,
                                                       monkeypatch):
    clock = FakeClock()
    for m in (jfed, tfed):
        monkeypatch.setattr(m, "time", clock)
    blobs = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        _publish(side, str(d))
        blobs[side] = {f: (d / f).read_bytes() for f in os.listdir(d)}
    assert sorted(blobs["torch"]) == ["replica0.alive", "replica1.alive"]
    assert blobs["torch"] == blobs["jax"]


def test_kv_client_carries_frames_both_ways():
    kv = FakeKV()
    _publish("jax", None, client=kv)
    assert sorted(kv.d) == ["pt_named/replica0", "pt_named/replica1"]
    tview = tfed.FleetSLOView(None, client=kv, staleness_s=60.0)
    jview = jfed.FleetSLOView(None, client=kv, staleness_s=60.0)
    t = tview.fleet_report(sorted(REPLICAS))
    assert t == jview.fleet_report(sorted(REPLICAS))
    assert t["staleness"]["fresh"] == sorted(REPLICAS)
    # sweep drops the name from the view's own transport, forget its
    # tracking
    tview.sweep("replica1")
    assert sorted(kv.d) == ["pt_named/replica0"]
    tview.forget("replica1")
    assert sorted(tview.frames()[0]) == ["replica0"]
    assert thb.read_named("replica1", client=kv) is None


def test_sweep_and_forget_leave_nothing_behind(tmp_path):
    d = str(tmp_path)
    kv = FakeKV()
    _publish("torch", d, client=kv)
    view = tfed.FleetSLOView(d, client=kv, staleness_s=60.0)
    assert view.poll(sorted(REPLICAS)) == 2
    for name in REPLICAS:
        view.sweep(name)
        view.forget(name)
    assert os.listdir(d) == [] and kv.d == {}
    assert view.frames() == ({}, {})
    assert view.poll(sorted(REPLICAS)) == 0
    # a view with no transport sweeps nothing, even with the env dir set
    os.environ["PADDLE_HEARTBEAT_DIR"] = d
    try:
        thb.touch_named(d, "replica0")
        tfed.FleetSLOView(staleness_s=60.0).sweep("replica0")
        assert os.listdir(d) == ["replica0.alive"]
    finally:
        del os.environ["PADDLE_HEARTBEAT_DIR"]


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------

def _surfaces(side, d):
    fed, _ = SIDES[side]
    _publish(side, d)
    view = fed.FleetSLOView(d, staleness_s=60.0)
    view.poll(sorted(REPLICAS))
    fed.set_active_view(view)
    snap = fed.fleet_serving_snapshot()
    snap.pop("unix_time")
    block = fed.flight_block()
    for f in block["local_frames"].values():
        f.pop("t")
    for f in snap["frames"].values():
        f.pop("t")
    return {"snapshot": snap, "text": fed.exposition_text(),
            "flight": block, "active": fed.active_view() is view}


def test_surfaces_match_the_reference(mon, tmp_path):
    t = _surfaces("torch", str(tmp_path / "t"))
    j = _surfaces("jax", str(tmp_path / "j"))
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert t["snapshot"]["source"] == "controller"
    assert 'slo_fleet_replica_burn_fast{replica="replica0"} 20' in t["text"]
    assert TM.snapshot()["gauges"]["slo.fleet.alerting"] == 1
    # the monitor's exposition appends the labeled series, and the
    # flight record carries the block
    assert "slo_fleet_replica_alerting" in TM.expose_text()
    assert TM.trace.flight_payload()["federation"] == tfed.flight_block()
    TM.reset()
    assert tfed.flight_block() is None and tfed.exposition_text() == ""
    assert tfed.active_view() is None and tfed.last_report() is None


def test_local_snapshot_without_a_view(mon):
    for side in ("jax", "torch"):
        fed, _ = SIDES[side]
        assert fed.flight_block() is None
        assert fed.fleet_serving_snapshot()["report"] is None
        pub = fed.FramePublisher("solo", local_only=True,
                                 slo_fn=_slo_fn(1.0, 1.0))
        pub.maybe_publish(StubEngine(STATS[side]))
    snaps = {}
    for side in ("jax", "torch"):
        snap = SIDES[side][0].fleet_serving_snapshot()
        snap.pop("unix_time")
        snap["frames"]["solo"].pop("t")
        snaps[side] = snap
    assert snaps["torch"] == snaps["jax"]
    assert snaps["torch"]["source"] == "local"
    assert snaps["torch"]["report"]["staleness"]["fresh"] == ["solo"]
