"""Port parity: the SLO accounting plane (``monitor/slo.py``) and the
engine's cost attribution and ``shed_on_burn``, mirroring the
reference's ``tests/test_slo.py``.

Every case runs the same inputs through the JAX module and the port's
and compares the outputs: exactly for counts, strings and records;
``1e-9`` relative for float sums of fake-clock values (``approx`` below);
FLOPs shares ``1e-6`` relative, with the FLOPs of each program set equal
on both sides (``equal_flops``: the reference takes them from XLA's cost
analysis, the port from the program's shapes).

- ``TestCostAttribution``: every ``RequestCost`` field of a preempting
  serve equal to JAX's under one fake clock, including the cumulative
  queue wait across a preemption; no device synchronization added at
  exec and KV sample rate 1; monitor off, no cost and no registration.
- ``TestBurnRateMath``: ``compliance_report`` equal on the same
  synthetic records (the reference's pinned values asserted too).
- ``TestTenantExposition`` and ``TestAutoscale``.
- ``TestActingSignals``: ``shed_on_burn`` sheds the same rids with the
  same reasons and hints as JAX's engine while a latency objective
  burns, and nothing with the monitor off.
"""
import importlib
import math

import numpy as np
import pytest

from _torch_monitor_common import (FakeClock, JM, TM, cost_dict,
                                   equal_flops, monitor_on, patch_clock,
                                   reset_both, serve_pair, set_monitor,
                                   tiny_pair)

assert monitor_on                       # a fixture the tests take

REL = 1e-9


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair(2)


@pytest.fixture
def clock(monkeypatch):
    return patch_clock(monkeypatch, FakeClock())


def both(fn):
    """``fn(M)`` on the JAX package's planes and the port's, from clean
    planes each; returns ``(jax result, port result)``."""
    out = []
    for M in (JM, TM):
        M.reset()
        out.append(fn(M))
    return tuple(out)


def _completed(rec=None, tenant="default", **latencies):
    """A synthetic completed-request record (the reference test's)."""
    out = {"tenant": tenant, "rejected": False, "prefill_tokens": 4,
           "decode_tokens": 4, "queue_wait_ms": 1.0,
           "page_seconds": 0.01, "slot_steps": 4, "model_flops": 100.0,
           "ttft_ms": 10.0, "tpot_ms": 5.0, "e2e_ms": 50.0}
    out.update(rec or {})
    out.update(latencies)
    return out


def _sub(rid, n=5, new=4, **kw):
    return ("sub", rid, n, new, kw)


# -- engine cost attribution -------------------------------------------------

_PREEMPT = dict(num_slots=3, max_len=16, page_size=4, num_pages=6,
                decode_chunk=2)
_PREEMPT_SCRIPT = [_sub(r, n=5 + r % 4, new=7 + r % 3,
                        tenant=("a", "b")[r % 2], priority=r % 2)
                   for r in range(6)]


class TestCostAttribution:
    @pytest.fixture(scope="class")
    def served(self, tiny):
        mp = pytest.MonkeyPatch()
        clock = patch_clock(mp, FakeClock())
        equal_flops(mp)
        reset_both()
        set_monitor(True)
        for M in (JM, TM):
            M.exectime.set_sample_rate(1)
            M.numerics.set_kv_sample_rate(1)
        try:
            yield serve_pair(tiny, clock, _PREEMPT_SCRIPT, **_PREEMPT)
        finally:
            set_monitor(False)
            reset_both()
            mp.undo()

    def test_every_cost_field_matches(self, served):
        jout, tout = served["jax"][0], served["torch"][0]
        assert sorted(tout) == sorted(jout)
        for rid in jout:
            j, t = cost_dict(jout[rid]), cost_dict(tout[rid])
            assert j is not None and t is not None
            for k, v in j.items():
                if isinstance(v, float):
                    assert t[k] == pytest.approx(v, rel=REL), (rid, k)
                else:
                    assert t[k] == v, (rid, k)
            assert tout[rid].tokens.tolist() == jout[rid].tokens.tolist()

    def test_queue_wait_cumulative_across_preemption(self, served):
        jout, tout = served["jax"][0], served["torch"][0]
        pre = [r for r, o in tout.items() if o.preemptions]
        assert pre, "the starved pool must preempt"
        hist = served["torch"][2]["snapshot"]["histograms"]
        waits = hist["serving.latency.queue_wait_ms"]
        # each wait observed once (an admission each), the records
        # keep the sum
        assert waits["count"] == served["torch"][3].stats.admitted
        assert waits["sum"] == pytest.approx(
            sum(o.cost.queue_wait_ms for o in tout.values()), rel=REL)
        for r in pre:
            assert tout[r].cost.discarded_tokens > 0
            assert tout[r].cost.queue_wait_ms == pytest.approx(
                jout[r].cost.queue_wait_ms, rel=REL)

    def test_histograms_and_counters_match(self, served):
        js = served["jax"][2]["snapshot"]
        ts = served["torch"][2]["snapshot"]
        assert ts["counters"] == js["counters"]
        assert ts["gauges"] == js["gauges"]
        assert ts["histograms"].keys() == js["histograms"].keys()
        for name, h in js["histograms"].items():
            for k, v in h.items():
                assert ts["histograms"][name][k] == pytest.approx(
                    v, rel=REL), (name, k)

    def test_slo_records_and_tenants_match(self, served):
        jp, tp = served["jax"][2], served["torch"][2]
        assert tp["tenants"].keys() == jp["tenants"].keys()
        for t, agg in jp["tenants"]["tenants"].items():
            for k, v in agg.items():
                assert tp["tenants"]["tenants"][t][k] == pytest.approx(
                    v, rel=REL), (t, k)
        assert len(tp["records"]) == len(jp["records"])
        for a, b in zip(tp["records"], jp["records"]):
            assert a.keys() == b.keys()
            for k in b:
                if isinstance(b[k], float):
                    assert a[k] == pytest.approx(b[k], rel=REL), k
                else:
                    assert a[k] == b[k], k
        assert tp["slo"] == jp["slo"]
        assert tp["tenant_compliance"] == jp["tenant_compliance"]

    def test_zero_added_syncs_at_any_rate(self, tiny, monitor_on,
                                          monkeypatch):
        """Exec and KV sampling at rate 1 run on the engine's existing
        downloads: ``_block_until_ready`` is never called."""
        TE = importlib.import_module("paddle_tpu_torch.monitor.exectime")
        calls = []
        monkeypatch.setattr(TE, "_block_until_ready",
                            lambda out: calls.append(out))
        TM.exectime.set_sample_rate(1)
        TM.numerics.set_kv_sample_rate(1)
        from paddle_tpu_torch.inference import Request, ServingEngine
        from paddle_tpu_torch.models import llama as TL
        eng = ServingEngine(TL, tiny[3], tiny[2], device="cpu", **_PREEMPT)
        for r in range(4):
            eng.submit(Request(rid=r, prompt=np.arange(5) + r,
                               max_new_tokens=6))
        eng.run()
        snap = TM.snapshot()["counters"]
        assert snap["jit.program.exec.samples"] > 0
        assert snap["numerics.kv.samples"] > 0
        assert calls == []

    def test_off_path_no_cost_no_registrations(self, tiny):
        reset_both()
        set_monitor(False)
        from paddle_tpu_torch.inference import Request, ServingEngine
        from paddle_tpu_torch.models import llama as TL
        eng = ServingEngine(TL, tiny[3], tiny[2], device="cpu", **_PREEMPT)
        out = eng.run([Request(rid=r, prompt=np.arange(5) + r,
                               max_new_tokens=6) for r in range(4)])
        assert all(o.cost is None for o in out.values())
        assert TM.snapshot() == {} and TM.slo.records() == []
        assert TM.trace.events() == []
        assert TM.programs.programs_snapshot() == []
        assert TM.forensics.tracked() == 0


# -- burn-rate math -----------------------------------------------------------

class TestBurnRateMath:
    def test_compliance_and_burn_pinned(self, monitor_on):
        def run(M):
            slo = M.slo
            slo.set_objectives(ttft_p99_ms=100.0, availability=0.9)
            for i in range(10):
                slo.record_request(_completed(
                    ttft_ms=200.0 if i < 2 else 50.0))
            first = slo.compliance_report()
            slo.record_rejected("default")
            return first, slo.compliance_report(), M.snapshot()["gauges"]
        j, t = both(run)
        assert t == j
        tt = t[0]["objectives"]["ttft_p99_ms"]
        assert tt["compliance"] == pytest.approx(0.8)
        assert tt["burn_slow"] == pytest.approx(20.0)
        assert tt["budget_remaining"] == pytest.approx(-19.0)
        a = t[1]["objectives"]["availability"]
        assert a["samples_slow"] == 11
        assert a["burn_slow"] == pytest.approx((1 / 11) / 0.1)
        assert t[2]["slo.window.requests"] == 11

    def test_insufficient_data_answers_none(self, monitor_on):
        def run(M):
            M.slo.set_objectives(ttft_p99_ms=100.0)
            for _ in range(4):
                M.slo.record_request(_completed(ttft_ms=500.0,
                                                tpot_ms=None))
            thin = M.slo.compliance_report()
            M.slo.record_request(_completed(ttft_ms=500.0, tpot_ms=None))
            return thin, M.slo.compliance_report()
        j, t = both(run)
        assert t == j
        assert t[0]["objectives"]["ttft_p99_ms"]["compliance"] is None
        assert t[0]["objectives"]["tpot_p99_ms"]["samples_slow"] == 0
        assert t[1]["objectives"]["ttft_p99_ms"]["burn_slow"] == \
            pytest.approx(100.0)

    def test_warn_flips_and_recovers(self, monitor_on):
        def run(M):
            slo = M.slo
            slo.set_objectives(ttft_p99_ms=100.0)
            for _ in range(8):
                slo.record_request(_completed(ttft_ms=900.0))
            rep = slo.compliance_report()
            hz = slo._slo_provider()
            alert = M.snapshot()["gauges"]["slo.alerting"]
            for _ in range(rep["fast_window"]):
                slo.record_request(_completed(ttft_ms=10.0))
            return (rep, hz, alert, slo.compliance_report(),
                    M.snapshot()["gauges"]["slo.alerting"])
        j, t = both(run)
        assert t == j
        assert "ttft_p99_ms" in t[0]["alerting"] and t[2] == 1
        assert t[1]["ok"] is True and t[1]["level"] == "warn"
        assert "ttft_p99_ms" not in t[3]["alerting"] and t[4] == 0

    def test_tenant_compliance_windowed(self, monitor_on):
        def run(M):
            M.slo.set_objectives(ttft_p99_ms=100.0)
            for _ in range(6):
                M.slo.record_request(_completed(tenant="good",
                                                ttft_ms=10.0))
            for _ in range(6):
                M.slo.record_request(_completed(tenant="bad",
                                                ttft_ms=500.0))
            M.slo.record_request(_completed(tenant="thin"))
            return M.slo.tenant_compliance()
        j, t = both(run)
        assert t == j
        assert t["good"]["ttft_p99_ms"] == 1.0
        assert t["bad"]["ttft_p99_ms"] == 0.0
        assert t["thin"]["ttft_p99_ms"] is None

    def test_off_flag_zero_registration(self):
        reset_both()
        set_monitor(False)

        def run(M):
            M.slo.record_request(_completed())
            M.slo.record_rejected("ghost")
            M.slo.note_sched_tick(4, 2, 2, 0.5)
            return (M.slo.records(), M.slo.tenants_snapshot(),
                    M.snapshot(), M.slo.burn_alerting(max_age_s=0))
        j, t = both(run)
        assert t == j == ([], {"max_tenants": 32, "overflow_records": 0,
                               "tenants": {}}, {}, False)

    def test_window_bounded(self, monitor_on):
        def run(M):
            M.slo.set_window(16)
            for i in range(50):
                M.slo.record_request(_completed(tenant=f"t{i % 2}"))
            return (M.slo.window_capacity(), len(M.slo.records()),
                    M.slo.total_records(), M.slo.tenants_snapshot())
        j, t = both(run)
        assert t == j and t[:3] == (16, 16, 50)

    def test_objective_validation(self):
        for M in (JM, TM):
            with pytest.raises(ValueError, match="unknown"):
                M.slo.set_objectives(nope=1.0)
            with pytest.raises(ValueError, match="out of range"):
                M.slo.set_objectives(availability=1.5)
            with pytest.raises(ValueError, match="out of range"):
                M.slo.set_objectives(ttft_p99_ms=0)

    def test_env_objectives(self, monitor_on, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_SLO_TTFT_P99_MS", "42.5")
        monkeypatch.setenv("PADDLE_TPU_SLO_AVAILABILITY", "1.0")
        monkeypatch.setenv("PADDLE_TPU_SLO_FAST_WINDOW", "4")
        monkeypatch.setenv("PADDLE_TPU_SLO_BURN_WARN", "2.0")
        monkeypatch.setenv("PADDLE_TPU_SLO_MIN_SAMPLES", "2")

        def run(M):
            objs = M.slo.objectives()
            for i in range(6):
                M.slo.record_request(_completed(ttft_ms=10.0 + 10 * i))
            return objs, M.slo.compliance_report()
        j, t = both(run)
        assert t == j
        assert t[0]["ttft_p99_ms"] == 42.5 and t[0]["availability"] == 0.995
        assert t[1]["fast_window"] == 4 and "ttft_p99_ms" in t[1]["alerting"]


# -- tenant exposition + cardinality -----------------------------------------

class TestTenantExposition:
    def test_hostile_tenant_round_trips(self, monitor_on):
        nasty = 'evil"\n\\tenant'

        def run(M):
            M.slo.record_request(_completed(tenant=nasty))
            M.slo.record_request(_completed(tenant="plain"))
            return M.expose_text()
        j, t = both(run)
        assert t == j
        assert 'tenant="evil\\"\\n\\\\tenant"' in t

    def test_every_cost_family_exposed(self, monitor_on):
        def run(M):
            M.slo.record_request(_completed(tenant="acme"))
            return M.slo.tenant_exposition_text()
        j, t = both(run)
        assert t == j
        for field in ("requests", "completed", "rejected", "shed",
                      "expired", "prefill_tokens", "decode_tokens",
                      "discarded_tokens", "queue_wait_ms", "page_seconds",
                      "slot_steps", "model_flops", "preemptions"):
            assert f"# TYPE slo_tenant_{field} counter" in t, field

    def test_cardinality_cap_collapses_to_other(self, monitor_on, clock):
        def run(M):
            M.slo.set_max_tenants(3)
            for i in range(10):
                M.slo.record_request(_completed(tenant=f"tenant-{i}"))
            return M.slo.tenants_snapshot(), M.slo.records()
        j, t = both(run)
        assert t == j
        assert t[0]["tenants"][TM.slo.OVERFLOW_TENANT]["requests"] == 7
        assert t[0]["overflow_records"] == 7

    def test_cap_never_grows_registry(self, monitor_on):
        def run(M):
            M.slo.set_max_tenants(2)
            for _ in range(8):
                M.slo.record_request(_completed(tenant="a"))
            M.slo.compliance_report()
            n = len(M.registry())
            for i in range(20):
                M.slo.record_request(_completed(tenant=f"hostile-{i}"))
            M.slo.compliance_report()
            return n, len(M.registry()), M.slo.tenants_snapshot()
        j, t = both(run)
        assert t == j and t[0] == t[1] and len(t[2]["tenants"]) <= 3

    def test_rejection_cannot_claim_label_slot(self, monitor_on):
        def run(M):
            M.slo.record_rejected("squatter")
            before = M.slo.tenants_snapshot()
            M.slo.record_request(_completed(tenant="squatter"))
            M.slo.record_rejected("squatter")
            return before, M.slo.tenants_snapshot()
        j, t = both(run)
        assert t == j
        assert "squatter" not in t[0]["tenants"]
        assert t[1]["tenants"]["squatter"]["rejected"] == 1

    def test_empty_without_records(self, monitor_on):
        for M in (JM, TM):
            assert M.slo.tenant_exposition_text() == ""
            assert "slo_tenant" not in M.expose_text()


# -- autoscale signals -------------------------------------------------------

class TestAutoscale:
    def test_no_ticks_no_gauges(self, monitor_on):
        j, t = both(lambda M: (M.slo.update_autoscale_gauges(),
                               M.snapshot()))
        assert t == j == ({"available": False}, {})

    @pytest.mark.parametrize("ticks", [
        [(0, 2, 4, 0.25), (2, 2, 4, 0.25), (4, 2, 4, 0.25),
         (8, 2, 4, 0.25)],
        [(4, 2, 2, 0.5), (0, 0, 2, 1.0)],
        [(3, 2, 4, 0.5)]], ids=["growing", "idle", "one_tick"])
    def test_demand_model_and_gauges(self, monitor_on, clock, ticks):
        def run(M):
            for k, tick in enumerate(ticks):
                clock.now = 1000.0 + 0.5 * k
                M.slo.note_sched_tick(*tick)
            return (M.slo.update_autoscale_gauges(), M.snapshot(),
                    M.slo.demand_model(*ticks[-1]),
                    M.slo.retry_after_hint())
        j, t = both(run)
        assert t == j
        out = t[0]
        assert out["desired_capacity_hint"] == \
            math.ceil(out["demand_estimate"] - 1e-9)
        # the pure model without a trend: the tick-driven payload adds
        # the queue trend's growth to the demand
        for k, v in t[2].items():
            if k not in ("queue_depth_trend_per_s", "demand_estimate",
                         "desired_capacity_hint"):
                assert out[k] == v, k

    def test_headroom_leg_composes(self, monitor_on):
        hr = {"est_admittable_bytes": 25,
              "hbm": {"totals": {"bytes_limit": 100, "bytes_in_use": 60}}}

        def run(M):
            M.slo.note_sched_tick(0, 1, 4, 1.0)
            return (M.slo.update_autoscale_gauges(headroom=hr),
                    M.slo.update_autoscale_gauges(
                        headroom={"est_admittable_bytes": None,
                                  "hbm": {"totals": {}}}))
        j, t = both(run)
        assert t == j
        assert t[0]["memory_utilization"] == pytest.approx(0.75)
        assert t[1]["memory_utilization"] is None

    def test_engine_feeds_ticks(self, tiny, monitor_on, clock):
        """The engine's scheduler tick: the same payload mid-run and at
        the end as the reference engine's."""
        script = [_sub(r, n=4, new=6) for r in range(4)]
        kw = dict(num_slots=2, max_len=32, page_size=4, decode_chunk=2)
        res = serve_pair(tiny, clock, script, **kw)
        mids = {}
        for side, M in (("jax", JM), ("torch", TM)):
            eng = res[side][3]
            mids[side] = (eng.autoscale_payload(), eng.stats.as_dict())
        assert mids["torch"] == mids["jax"]
        jsnap = res["jax"][2]["snapshot"]["gauges"]
        tsnap = res["torch"][2]["snapshot"]["gauges"]
        assert tsnap == jsnap
        assert jsnap["serving.queue.depth"] == 0


# -- acting signals: shed_on_burn --------------------------------------------

class TestActingSignals:
    def test_retry_after_hint_math(self, monitor_on):
        def run(M):
            d = M.slo.demand_model
            return (M.slo.retry_after_hint(),
                    M.slo.retry_after_hint(d(0, 0, 2, 1.0)),
                    M.slo.retry_after_hint(d(2, 2, 2, 0.0)),
                    M.slo.retry_after_hint(d(100, 2, 2, 0.0)))
        j, t = both(run)
        assert t == j == (1.0, 1.0, 30.0, 60.0)

    def test_retry_after_hint_reads_the_last_tick(self, monitor_on):
        j, t = both(lambda M: (M.slo.note_sched_tick(6, 2, 2, 0.0),
                               M.slo.retry_after_hint())[1])
        assert t == j == 60.0

    def test_shed_and_expired_fold(self, monitor_on):
        def run(M):
            for _ in range(6):
                M.slo.record_request(_completed(tenant="t"))
            for _ in range(2):
                M.slo.record_shed("t")
            M.slo.record_request({"tenant": "t", "expired": True,
                                  "e2e_ms": 0.5, "queue_wait_ms": 3.0,
                                  "page_seconds": 0.01})
            M.slo.record_request({"tenant": "t", "rejected": True,
                                  "shed": True, "queue_wait_ms": 5.0,
                                  "prefill_tokens": 7})
            return M.slo.compliance_report(), M.slo.tenants_snapshot()
        j, t = both(run)
        assert t == j
        agg = t[1]["tenants"]["t"]
        assert agg["shed"] == 3 and agg["expired"] == 1
        assert agg["queue_wait_ms"] == pytest.approx(6.0 + 3.0 + 5.0)
        assert t[0]["objectives"]["e2e_p99_ms"]["samples_slow"] == 6

    def test_burn_alerting_cached_and_monitor_gated(self, monitor_on,
                                                   clock):
        def run(M):
            M.slo.set_objectives(e2e_p99_ms=1.0)
            for _ in range(40):
                M.slo.record_request(_completed(e2e_ms=100.0))
            first = M.slo.burn_alerting(max_age_s=0)
            for _ in range(40):
                M.slo.record_request(_completed(e2e_ms=0.5))
            cached = M.slo.burn_alerting(max_age_s=0.5)
            clock.advance(1.0)
            fresh = M.slo.burn_alerting(max_age_s=0.5)
            return first, cached, fresh
        j, t = both(run)
        assert t == j == (True, True, False)

    @pytest.fixture(scope="class")
    def burn_serves(self, tiny):
        """Six requests finish first against an e2e objective of 1 ms
        (every one violates), then a wave of priority 0 and 1
        submissions arrives, one every step, with ``shed_on_burn``: with
        the monitor on and off."""
        warm = [_sub(r, n=4, new=3) for r in range(6)]
        wave = []
        for r in range(10, 22):
            wave += [_sub(r, n=4, new=3, priority=r % 2), ("step",),
                     ("tick", 0.01)]
        # the tick outlasts the burn check's 0.5 s cache of the verdict
        # the warm submissions read (no records yet: not alerting)
        script = (warm + [("step",), ("tick", 0.01)] * 12
                  + [("tick", 1.0)] + wave)
        kw = dict(num_slots=2, max_len=32, page_size=4, decode_chunk=2,
                  shed_on_burn=True)
        mp = pytest.MonkeyPatch()
        clock = patch_clock(mp, FakeClock())
        equal_flops(mp)
        out = {}
        try:
            for on in (True, False):
                reset_both()
                for M in (JM, TM):
                    M.slo.set_objectives(e2e_p99_ms=1.0)
                set_monitor(on)
                out[on] = serve_pair(tiny, clock, script, **kw)
        finally:
            set_monitor(False)
            reset_both()
            mp.undo()
        return out

    def test_shed_on_burn_matches_the_reference(self, burn_serves):
        res = burn_serves[True]
        (jout, jref, jp, _), (tout, tref, tp, _) = res["jax"], res["torch"]
        assert tref == jref
        shed = {r for r, v in tref.items() if v[0] == "shed"}
        assert shed and all(r % 2 == 0 for r in shed)   # priority 0 only
        assert all("burn" in tref[r][1] for r in shed)
        assert sorted(tout) == sorted(jout)
        assert tp["snapshot"]["counters"] == jp["snapshot"]["counters"]
        assert tp["slo"] == jp["slo"]
        assert tp["forensics"]["decisions"] == jp["forensics"]["decisions"]

    def test_shed_on_burn_sheds_nothing_with_the_monitor_off(self,
                                                            burn_serves):
        res = burn_serves[False]
        assert res["torch"][1] == res["jax"][1] == {}
        assert len(res["torch"][0]) == len(res["jax"][0]) == 18
