"""Port parity: the metrics registry (``monitor/registry.py``), its
exposition (``monitor/exposition.py``) and the gated surface of
``paddle_tpu_torch.monitor`` against the reference's, on the cases of
``tests/test_monitor.py``.

The same sequence of ``inc`` / ``observe`` / ``set_gauge`` calls goes
through both packages: the ``snapshot()`` dicts are equal (the
bucket-interpolated p50/p90/p95/p99 included), ``expose_text()`` is
byte-identical, and ``dump_json`` has equal content (its ``unix_time``
aside). With the monitor off nothing registers on either side.
"""
import importlib
import json
import math

import numpy as np
import pytest

from _torch_monitor_common import JM, TM, monitor_on, reset_both, set_monitor
from paddle_tpu.monitor import StatRegistry as JRegistry
from paddle_tpu_torch.monitor import StatRegistry as TRegistry

# the packages' ``registry`` name is the accessor function: reach the
# modules by path
JREG = importlib.import_module("paddle_tpu.monitor.registry")
TREG = importlib.import_module("paddle_tpu_torch.monitor.registry")

assert monitor_on                       # a fixture the tests take


def _script(seed):
    """A seeded sequence of gated calls over counters, gauges and
    histograms (default, latency and custom buckets)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(60):
        k = int(rng.integers(0, 5))
        name = f"m{seed}.x{int(rng.integers(0, 4))}"
        if k == 0:
            ops.append(("inc", name + ".calls", int(rng.integers(1, 9))))
        elif k == 1:
            ops.append(("set_gauge", name + ".depth",
                        float(rng.standard_normal())))
        elif k == 2:
            ops.append(("observe", name + ".ms",
                        float(rng.lognormal(1.0, 2.0)), None))
        elif k == 3:
            ops.append(("observe", "serving.latency.x_ms",
                        float(rng.lognormal(3.0, 1.5)),
                        JREG.LATENCY_BUCKETS_MS))
        else:
            ops.append(("observe", "custom.h",
                        float(rng.uniform(0, 120)), (1.0, 10.0, 100.0)))
    return ops


def _play(M, ops):
    for op in ops:
        if op[0] == "inc":
            M.inc(op[1], op[2], doc=f"doc of {op[1]}")
        elif op[0] == "set_gauge":
            M.set_gauge(op[1], op[2], doc="a gauge")
        else:
            M.observe(op[1], op[2], doc="a histogram", buckets=op[3])


@pytest.mark.parametrize("seed", range(6))
def test_same_calls_same_snapshot_text_and_json(monitor_on, seed):
    ops = _script(seed)
    for M in (JM, TM):
        _play(M, ops)
    assert TM.snapshot() == JM.snapshot()
    assert TM.expose_text() == JM.expose_text()
    j = JM.dump_json(run_id=f"run{seed}")
    t = TM.dump_json(run_id=f"run{seed}")
    j.pop("unix_time")
    t.pop("unix_time")
    assert t == j


def test_dump_json_writes_the_same_file(monitor_on, tmp_path):
    ops = _script(11)
    out = {}
    for M in (JM, TM):
        _play(M, ops)
        p = tmp_path / f"{M.__name__}.json"
        M.dump_json(run_id="r", path=str(p))
        d = json.loads(p.read_text())
        d.pop("unix_time")
        out[M] = d
    assert out[TM] == out[JM]


def test_latency_buckets_are_the_reference_s():
    assert TREG.LATENCY_BUCKETS_MS == JREG.LATENCY_BUCKETS_MS


@pytest.mark.parametrize("buckets", [None, (1.0, 10.0, 100.0),
                                     JREG.LATENCY_BUCKETS_MS])
@pytest.mark.parametrize("values", [[], [0.5], [5.0] * 7,
                                    [0.5, 5.0, 50.0, 500.0],
                                    list(range(1, 200, 3))],
                         ids=["empty", "one", "flat", "spread", "ramp"])
def test_histogram_quantiles_match(buckets, values):
    hs = [R().histogram("h", "doc", buckets=buckets)
          for R in (JRegistry, TRegistry)]
    for h in hs:
        for v in values:
            h.observe(v)
    assert hs[1].snapshot() == hs[0].snapshot()
    assert hs[1].cumulative_buckets() == hs[0].cumulative_buckets()
    q = (0.5, 0.9, 0.95, 0.99)
    assert hs[1].quantiles(q) == hs[0].quantiles(q)


def test_registry_types_behave_as_the_reference():
    out = []
    for R in (JRegistry, TRegistry):
        r = R()
        c = r.counter("c", "doc")
        c.incr()
        c.incr(5)
        c.add(2)
        g = r.gauge("g")
        g.set(10)
        g.add(5)
        g.sub(3)
        live, peak = r.gauge("live"), r.gauge("peak")
        for d in (100, -40, 30):
            live.add_and_max_into(d, peak)
        out.append((c.value, g.value, live.value, peak.value,
                    r.snapshot(), len(r)))
        c.reset()
        assert c.value == 0
    assert out[1] == out[0]
    assert out[1][:4] == (8, 12, 90, 100)


def test_metric_kind_clash_raises_on_both():
    for R in (JRegistry, TRegistry):
        r = R()
        r.counter("x")
        with pytest.raises(Exception):
            r.gauge("x")


def test_hostile_names_and_docs_sanitize_alike(monitor_on):
    for M in (JM, TM):
        M.inc("9bad/name.with-dashes", doc='a "doc"\nwith \\ breaks')
        M.set_gauge("ok:name", math.inf)
        M.set_gauge("nan.gauge", math.nan)
    assert TM.expose_text() == JM.expose_text()


def test_timed_observes_only_when_on(monkeypatch):
    reset_both()
    set_monitor(False)
    for M in (JM, TM):
        with M.timed("t.ms"):
            pass
        assert M.snapshot() == {}
    set_monitor(True)
    try:
        for M in (JM, TM):
            with M.timed("t.ms", buckets=JREG.LATENCY_BUCKETS_MS):
                pass
            assert M.snapshot()["histograms"]["t.ms"]["count"] == 1
    finally:
        set_monitor(False)
        reset_both()


def test_off_path_registers_nothing():
    reset_both()
    set_monitor(False)
    for M in (JM, TM):
        _play(M, _script(3))
        assert M.snapshot() == {}
        assert M.expose_text() == ""
    assert not TM.enabled()


def test_reset_empties_every_ported_plane(monitor_on):
    TM.inc("a")
    TM.trace.instant("x")
    TM.slo.record_rejected("t")
    TM.slo.note_sched_tick(1, 1, 2, 0.5)
    TM.forensics.note(1, "enqueue")
    TM.programs.record_program(("k",), "p", source="test")
    TM.numerics.record_kv_absmax(np.ones((2, 3)))
    TM.exectime.record_exec(("k",), 1.0)
    TM.reset()
    assert TM.snapshot() == {} and TM.trace.events() == []
    assert TM.slo.records() == [] and TM.slo.total_records() == 0
    assert TM.slo.update_autoscale_gauges() == {"available": False}
    assert TM.forensics.tracked() == 0
    assert TM.programs.programs_snapshot() == []
    assert TM.numerics.kv_snapshot()["samples"] == 0
    assert TM.exectime.take_last_sample_ms() is None


def test_suppress_accounting_nests_per_thread():
    assert not TM.suppressed()
    with TM.suppress_accounting():
        with TM.suppress_accounting():
            assert TM.suppressed()
        assert TM.suppressed()
    assert not TM.suppressed()


def test_health_providers_match_the_reference(monitor_on):
    """The health-provider map: weakly held engines prune themselves, a
    raising provider reports without failing liveness, ``ok: False``
    fails it."""
    import gc
    out = {}
    for M in (JM, TM):
        S = M.server

        class Owner:
            pass

        o = Owner()
        import weakref
        ref = weakref.ref(o)
        S.register_health_provider(
            "weak", lambda: None if ref() is None else {"ok": True, "n": 1})
        S.register_health_provider("bad", lambda: 1 / 0)
        ok1, p1 = S.health()
        S.register_health_provider("down", lambda: {"ok": False})
        ok2, p2 = S.health()
        del o
        gc.collect()
        S.unregister_health_provider("down")
        ok3, p3 = S.health()
        S.unregister_health_provider("bad")
        mine = ("weak", "bad", "down")        # other tests register more
        out[M] = (ok1, {k: v for k, v in p1["providers"].items()
                        if k in mine}, ok2, ok3,
                  sorted(k for k in p3["providers"] if k in mine),
                  p1["status"], p2["status"])
    assert out[TM] == out[JM]
    assert out[TM][0] is True and out[TM][2] is False
    assert "weak" not in out[TM][4]


def test_engine_health_provider(monitor_on):
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.models import llama as TL
    cfg = TL.llama_tiny(num_hidden_layers=1)
    eng = ServingEngine(TL, TL.init_params(cfg, device="cpu"), cfg,
                        device="cpu", num_slots=2, max_len=16, page_size=4)
    name = f"serving:{eng._engine_uid}"
    ok, payload = TM.server.health()
    assert ok and payload["providers"][name] == {
        "ok": True, "queue_depth": 0, "slots_live": 0, "num_slots": 2,
        "pages_free": 8, "pages_total": 8, "requests_completed": 0}
    assert TM.snapshot()["gauges"]["serving.pages.total"] == 8
    del eng
    import gc
    gc.collect()
    assert name not in TM.server.health()[1]["providers"]
