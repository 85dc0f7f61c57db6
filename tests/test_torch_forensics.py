"""Port parity: the request forensics plane (``monitor/forensics.py``, a
copy of the reference's) as the serving engine feeds it.

The JAX engine and the port's engine serve the same scripted
submissions on carried-over float32 ``llama_tiny`` weights with the
monitor on, under one fake clock (``_torch_monitor_common.FakeClock``):

- FIFO on a starved pool (admission deferrals on ``no_free_slot``,
  ``watermark`` and ``alloc_failed``, and preemptions);
- priority admission with tenant caps (``tenant_cap`` deferrals, the
  port's one admission scan against the reference's ``_admit_policy``);
- the overload trace of ``tests/test_torch_engine_overload.py`` (sheds
  at submit, a displacement, expiries in the queue and in a slot, the
  drain).

Each case compares, exactly: every request's timeline (events, phases,
e2e and TTFT), the decision ring, the decision counts by kind, the
attribution table, the slowest-N index and the flight block. The
breaker decisions come from the failover coordinator, held to the
reference's on one scripted admission sequence.
"""
import importlib

import pytest

from _torch_monitor_common import (FakeClock, JM, TM, equal_flops,
                                   monitor_on, patch_clock, reset_both,
                                   serve_pair, set_monitor, tiny_pair)

assert monitor_on                       # a fixture the tests take


def _sub(rid, n=5, new=4, **kw):
    return ("sub", rid, n, new, kw)


def _overload_script():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_forensics",
                                                  path)
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    timed, burst = C.overload_trace_requests(256)
    steps = [("step",), ("tick", C.OVERLOAD_DT)]
    script, vnow, i, pending = [], 0.0, 0, list(burst)

    def sub(r):
        return _sub(r.rid, n=len(r.prompt), new=r.max_new_tokens,
                    prompt=r.prompt, tenant=r.tenant, priority=r.priority,
                    deadline_s=r.deadline_s)

    while i < len(timed) or pending:
        if pending and C.OVERLOAD_BURST_AT <= vnow:
            script += [sub(r) for r in pending]
            pending = []
        while i < len(timed) and timed[i][0] <= vnow:
            script.append(sub(timed[i][1]))
            i += 1
        script += steps
        vnow += C.OVERLOAD_DT
    script += [("drain",)] + steps * 40
    return script, dict(num_slots=8, max_len=2048, page_size=16,
                        priority_admission=True, max_queue=16)


def _case(name):
    if name == "fifo":
        script = [_sub(r, n=5 + r % 4, new=6 + r % 3) for r in range(6)]
        return 2, script, dict(num_slots=3, max_len=16, page_size=4,
                               num_pages=7, decode_chunk=2, watermark=0.2)
    if name == "priority_caps":
        script = [_sub(r, n=4 + r % 5, new=3 + r % 4,
                       tenant=("a", "b")[r % 2],
                       priority=(0, 1, 2, 0)[r % 4]) for r in range(9)]
        return 2, script, dict(num_slots=4, max_len=32, page_size=4,
                               decode_chunk=2, priority_admission=True,
                               tenant_inflight_cap=1)
    script, kw = _overload_script()
    return 1, script, kw


CASES = ("fifo", "priority_caps", "overload")


@pytest.fixture(scope="module", params=CASES)
def served(request):
    layers, script, kw = _case(request.param)
    mp = pytest.MonkeyPatch()
    clock = patch_clock(mp, FakeClock())
    equal_flops(mp)
    reset_both()
    set_monitor(True)
    try:
        res = serve_pair(tiny_pair(layers), clock, script, **kw)
    finally:
        set_monitor(False)
        reset_both()
        mp.undo()
    return request.param, res


def test_serve_tokens_and_terminals_match(served):
    name, res = served
    (jout, jref, _, _), (tout, tref, _, _) = res["jax"], res["torch"]
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        assert tout[rid].tokens.tolist() == jout[rid].tokens.tolist(), rid
        assert tout[rid].finish_reason == jout[rid].finish_reason, rid
    assert tref == jref


def test_timelines_match(served):
    name, res = served
    jp, tp = res["jax"][2], res["torch"][2]
    assert tp["timelines"].keys() == jp["timelines"].keys()
    for rid, tl in jp["timelines"].items():
        assert tp["timelines"][rid] == tl, rid


def test_decision_ring_and_counts_match(served):
    name, res = served
    jd, td = res["jax"][2]["forensics"], res["torch"][2]["forensics"]
    assert td["decisions"] == jd["decisions"]
    kinds = set(jd["decisions"]["by_kind"])
    want = {"fifo": {"admit", "defer", "preempt"},
            "priority_caps": {"admit", "defer"},
            "overload": {"admit", "defer", "shed", "displace", "evict"}}
    assert want[name] <= kinds
    reasons = {d.get("reason") for d in jd["decisions"]["ring"]
               if d["kind"] == "defer"}
    if name == "priority_caps":
        assert "tenant_cap" in reasons
    if name == "fifo":
        assert "no_free_slot" in reasons


def test_attribution_and_payload_match(served):
    name, res = served
    jp, tp = res["jax"][2], res["torch"][2]
    assert tp["forensics"]["attribution"] == jp["forensics"]["attribution"]
    assert tp["forensics"] == jp["forensics"]


def test_counters_match(served):
    name, res = served
    js, ts = res["jax"][2]["snapshot"], res["torch"][2]["snapshot"]
    assert ts["counters"] == js["counters"]
    assert {k: v["count"] for k, v in ts["histograms"].items()} == {
        k: v["count"] for k, v in js["histograms"].items()}


@pytest.mark.parametrize("objective", ["ttft_p99_ms", "e2e_p99_ms"])
def test_violation_causes_fold_equally(monitor_on, objective):
    """Synthetic timelines with a dominant phase each, through both
    modules: the same violations, causes and rates."""
    out = {}
    for M in (JM, TM):
        M.slo.set_objectives(ttft_p99_ms=5.0, e2e_p99_ms=20.0)
        F = M.forensics
        for rid, (q, p, d) in enumerate([(1, 1, 1), (9, 1, 1),
                                         (1, 9, 30), (1, 1, 40)]):
            t = 100.0
            F.note(rid, "enqueue", t=t, tenant="x")
            F.note(rid, "admit", t=t + q * 1e-3)
            F.note(rid, "first_token", t=t + (q + p) * 1e-3)
            F.note_terminal(rid, "completed", t=t + (q + p + d) * 1e-3)
        out[M] = F.attribution_table()[objective]
    assert out[TM] == out[JM]
    assert out[JM]["violations"] >= 1


def test_defer_coalesces_and_store_is_bounded(monitor_on, monkeypatch):
    for M in (JM, TM):
        F = M.forensics
        monkeypatch.setattr(F, "_MAX_REQUESTS", 4)
        monkeypatch.setattr(F, "_MAX_EVENTS", 4)
        for rid in range(6):
            F.note(rid, "enqueue", t=1.0)
            for _ in range(3):
                F.note_defer(rid, "watermark", need=2)
            for k in range(5):
                F.note(rid, "admit", t=2.0 + k)
            if rid % 2 == 0:
                F.note_terminal(rid, "completed", t=9.0)
    jp, tp = (M.forensics.forensics_payload() for M in (JM, TM))
    assert tp == jp
    assert jp["tracked"] == 4 and jp["evicted"] == 2
    for rid in jp["requests"]:
        assert (TM.forensics.request_payload(rid)
                == JM.forensics.request_payload(rid))


def test_breaker_decisions_match(monitor_on):
    """The coordinator's breaker transitions (open after three sheds,
    closed by a good probe after the cooldown) land in both decision
    rings, counters and gauges alike."""
    JF = importlib.import_module("paddle_tpu.inference.failover")
    TFo = importlib.import_module("paddle_tpu_torch.inference.failover")
    for mod in (JF, TFo):
        co = mod.FailoverCoordinator(breaker_threshold=3,
                                     breaker_cooldown_s=1.0)
        for t, ok in [(0.0, False), (0.1, False), (0.2, False),
                      (0.5, False), (1.5, True), (1.6, True)]:
            if t >= 1.5:
                co.pick_replica(["r0"], 0, now=t)
            co.admission_result("r0", ok, now=t)
    jd = JM.forensics.decisions()
    td = TM.forensics.decisions()
    strip = [{k: v for k, v in d.items() if k not in ("t", "t_last")}
             for d in jd]
    assert [{k: v for k, v in d.items() if k not in ("t", "t_last")}
            for d in td] == strip
    # the open and the close coalesce (same kind, no rid, no reason)
    assert [(d["state"], d.get("count")) for d in strip] == [("open", 2)]
    counters = JM.snapshot()["counters"]
    assert counters["serving.failover.breaker.opened"] == 1
    assert counters["serving.failover.breaker.closed"] == 1
    assert TM.snapshot() == JM.snapshot()


def test_monitor_off_records_nothing(monkeypatch):
    """Monitor off: the same serve leaves every plane empty."""
    clock = patch_clock(monkeypatch, FakeClock())
    reset_both()
    set_monitor(False)
    layers, script, kw = _case("fifo")
    res = serve_pair(tiny_pair(layers), clock, script, **kw)
    for side in ("jax", "torch"):
        planes = res[side][2]
        assert planes["snapshot"] == {}
        assert planes["forensics"]["tracked"] == 0
        assert planes["records"] == [] and planes["events"] == []
        assert all(o.cost is None for o in res[side][0].values())
