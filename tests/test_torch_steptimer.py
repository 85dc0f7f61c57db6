"""Port parity: the step timer and the step time series
(``paddle_tpu_torch/monitor/{steptimer,timeseries}.py`` against
``paddle_tpu/monitor/{steptimer,timeseries}.py``).

Both packages run the same scripted loop under one fake clock (every
module that reads a clock in both packages reads one value that only the
script moves), monitor on: the timer's report, the ring's rows, the
drift report, the ``train.*`` metrics, the trace spans, the flight
record's ``timeseries`` block and the ``/timeseries`` and ``/healthz``
routes must be equal. Also: the step listeners fire with the monitor off,
``ambient_phase`` bills the active timer (an orphan timer outside any),
and everything is a no-op with the monitor off. The drift windows are
the reference's defaults (8 recent rows over up to 32 before them,
threshold 1.25).
"""
import importlib
import json
import urllib.request

import pytest

from _torch_monitor_common import FakeClock, JM, TM, reset_both, set_monitor

CLOCKED = ("monitor.steptimer", "monitor.timeseries", "monitor.trace")


def _forget_providers():
    for M in (JM, TM):
        M.server.unregister_health_provider("steptime_drift")
        M.timeseries._PROVIDER_REGISTERED[0] = False
        M.timeseries.set_capacity(None)
        M.steptimer._ORPHAN[0] = None


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        for mod in CLOCKED:
            monkeypatch.setattr(importlib.import_module(f"{pkg}.{mod}"),
                                "time", c)
    reset_both()
    _forget_providers()
    set_monitor(True)
    yield c
    set_monitor(False)
    reset_both()
    _forget_providers()


def _script(n=40, slow_from=24):
    """Per step: (data ms, compute ms, checkpoint ms, useful tokens,
    loss); compute slows by 60% from step ``slow_from`` on, so the drift
    detector trips."""
    out = []
    for i in range(n):
        compute = 20.0 + (i % 3) + (12.0 if i >= slow_from else 0.0)
        out.append((1.0 + (i % 2), compute, 3.0 if i % 5 == 4 else 0.0,
                    64 + i, 2.5 - 0.01 * i))
    return out


def drive(M, clock, script):
    """The script through one StepTimer of package ``M``: data wait,
    compute, checkpoint time billed ambiently (``ambient_phase``, as
    ``CheckpointManager.save`` bills it) while the timer is active, and
    ``end_step`` with the step's tokens and loss."""
    st = M.StepTimer("train")
    with st:
        for data, compute, ckpt, tokens, loss in script:
            with st.data_wait():
                clock.advance(data / 1e3)
            with st.compute():
                clock.advance(compute / 1e3)
            if ckpt:
                with M.ambient_phase("checkpoint"):
                    clock.advance(ckpt / 1e3)
            clock.advance(0.0005)               # untracked host time
            st.end_step(useful_tokens=tokens, loss=loss)
    snap = M.snapshot()
    train = {kind: {k: v for k, v in snap.get(kind, {}).items()
                    if k.startswith("train.")}
             for kind in ("counters", "gauges", "histograms")}
    events = [{k: v for k, v in e.items() if k != "tid"}
              for e in M.trace.events()]
    return {"report": st.report(), "rows": M.timeseries.rows(),
            "drift": M.timeseries.drift_status(),
            "snapshot": M.timeseries.timeseries_snapshot(8),
            "metrics": train, "events": events,
            "flight": M.trace.flight_payload()["timeseries"]}


def both(clock, script):
    out = {}
    for side, M in (("jax", JM), ("torch", TM)):
        JM.reset()
        TM.reset()
        clock.now = 1000.0
        out[side] = drive(M, clock, script)
    return out


def test_timer_rows_drift_and_metrics_match_the_reference(clock):
    out = both(clock, _script())
    t, j = out["torch"], out["jax"]
    for key in ("report", "rows", "drift", "snapshot", "metrics", "events",
                "flight"):
        assert t[key] == j[key], key
    assert t["report"]["steps"] == 40 and t["report"]["checkpoint_s"] > 0
    assert len(t["rows"]) == 40 and t["rows"][-1]["loss"] == 2.11
    assert t["drift"]["drifting"] and t["drift"]["ratio"] > 1.25
    assert t["metrics"]["gauges"]["train.step.drift_ratio"] == \
        t["drift"]["ratio"]


def test_ring_bounds_and_off_flag_match_the_reference(clock):
    for M in (JM, TM):
        M.timeseries.set_capacity(16)
    out = both(clock, _script(n=20))
    assert out["torch"]["snapshot"] == out["jax"]["snapshot"]
    snap = out["torch"]["snapshot"]
    assert snap["capacity"] == 16 and snap["total_rows"] == 20
    assert [r["step"] for r in out["torch"]["rows"]] == list(range(5, 21))
    set_monitor(False)
    for M in (JM, TM):
        M.reset()
        st = M.StepTimer("off")
        with st.compute():
            clock.advance(0.01)
        st.end_step(useful_tokens=5, loss=1.0)
        M.timeseries.record_step(total_ms=1.0)
        assert st.report() == {} and M.timeseries.rows() == []
        assert M.snapshot() == {}


def test_timeseries_and_healthz_routes_match_the_reference(clock):
    payloads = {}
    for side, M in (("jax", JM), ("torch", TM)):
        JM.reset()
        TM.reset()
        clock.now = 1000.0
        drive(M, clock, _script())
        srv = M.server.start_server(port=0)
        try:
            got = {}
            for route in ("/timeseries", "/healthz"):
                with urllib.request.urlopen(srv.url + route,
                                            timeout=30) as r:
                    got[route] = (r.status, json.loads(r.read()))
        finally:
            M.server.stop_server()
        payloads[side] = got
    t, j = payloads["torch"], payloads["jax"]
    assert t["/timeseries"] == j["/timeseries"]
    assert t["/timeseries"][0] == 200
    assert t["/timeseries"][1]["drift"]["drifting"]
    drift = {side: p["/healthz"][1]["providers"]["steptime_drift"]
             for side, p in payloads.items()}
    assert drift["torch"] == drift["jax"]
    # warn-level: a slow step never fails liveness
    assert drift["torch"]["ok"] and drift["torch"]["level"] == "warn"
    assert t["/healthz"][0] == j["/healthz"][0] == 200


def test_step_listeners_fire_with_the_monitor_off():
    set_monitor(False)
    seen = []

    def listener():
        seen.append(1)

    def broken():
        raise RuntimeError("a broken listener must not stop the loop")

    TM.steptimer.add_step_listener(listener)
    TM.steptimer.add_step_listener(listener)        # idempotent
    TM.steptimer.add_step_listener(broken)
    try:
        st = TM.StepTimer("listen")
        st.end_step()
        st.end_step()
    finally:
        TM.steptimer.remove_step_listener(listener)
        TM.steptimer.remove_step_listener(broken)
    TM.steptimer.remove_step_listener(listener)     # absent: no error
    assert seen == [1, 1]
    assert listener not in TM.steptimer._STEP_LISTENERS


def test_ambient_phase_bills_the_active_timer_or_the_orphan(clock):
    out = {}
    for side, M in (("jax", JM), ("torch", TM)):
        JM.reset()
        TM.reset()
        clock.now = 1000.0
        M.steptimer._ORPHAN[0] = None
        st = M.StepTimer("loop")
        with M.ambient_phase("checkpoint"):        # no active timer
            clock.advance(0.004)
        with st.compute():
            with M.ambient_phase("checkpoint"):    # active while computing
                clock.advance(0.002)
        st.end_step()
        out[side] = (st.report(), M.steptimer._ORPHAN[0].report(),
                     M.snapshot()["histograms"][
                         "train.step.checkpoint_ms"]["count"])
    assert out["torch"] == out["jax"]
    report, orphan, count = out["torch"]
    assert report["checkpoint_s"] == 0.002 and orphan["checkpoint_s"] == 0.004
    assert count == 2
