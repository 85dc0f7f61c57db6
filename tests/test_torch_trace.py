"""Port parity: the trace ring and flight recorder (``monitor/trace.py``)
and the serving engine's lifecycle events, against the reference's.

- The ring: overflow keeps the newest events and counts every one;
  spans nest by timestamp containment; ``complete`` records a span after
  the fact; the same calls give equal ``events()`` on both packages
  under one fake clock.
- The flight record: the payload's events, metrics and SLO / forensics
  blocks equal the reference's; ``dump_flight_record`` writes it only to
  an armed destination.
- The chrome-trace export is structurally equal to the reference's on
  the same events (no profiler track on either side).
- The token-accounting contract (``engine.py``'s docstring: generated -
  discarded == the tokens kept) on a preempting serve, held against the
  JAX engine along with every lifecycle event the two engines record.
- ``testing.faults``: a ``corrupt`` lands a ``fault.corrupt`` event, a
  ``raise`` lands ``fault.fired`` and dumps the armed flight record.
"""
import importlib
import json

import pytest
import torch

from _torch_monitor_common import (FakeClock, JM, TM, equal_flops,
                                   monitor_on, patch_clock, reset_both,
                                   serve_pair, set_monitor, tiny_pair)
from paddle_tpu_torch.testing import faults as TFAULTS

assert monitor_on                       # a fixture the tests take

JTR = importlib.import_module("paddle_tpu.monitor.trace")
TTR = importlib.import_module("paddle_tpu_torch.monitor.trace")


@pytest.fixture
def clock(monkeypatch):
    return patch_clock(monkeypatch, FakeClock())


def _calls(M, clock):
    tr = M.trace
    with tr.span("outer", step=1):
        clock.advance(0.001)
        tr.instant("mark", rid=7, reason="x")
        with tr.span("inner"):
            clock.advance(0.002)
        clock.advance(0.001)
    tr.complete("retro", int(999.5e9), 250_000, kind="late")
    for i in range(5):
        tr.instant("tick", i=i)
        clock.advance(0.0005)


def _events(M):
    return [{k: v for k, v in e.items() if k != "tid"}
            for e in M.trace.events()]


def test_same_calls_same_events(monitor_on, clock):
    for M in (JM, TM):
        clock.now = 1000.0
        _calls(M, clock)
    assert _events(TM) == _events(JM)
    ev = {e["name"]: e for e in _events(TM)}
    outer, inner = ev["outer"], ev["inner"]
    # nesting by containment
    assert outer["t_ns"] <= inner["t_ns"]
    assert inner["t_ns"] + inner["dur_ns"] <= outer["t_ns"] + \
        outer["dur_ns"]
    assert ev["retro"]["dur_ns"] == 250_000


@pytest.mark.parametrize("n", [3, 16, 40])
def test_ring_overflow_keeps_the_newest(monitor_on, clock, monkeypatch, n):
    for mod in (JTR, TTR):
        monkeypatch.setattr(mod, "_RING", mod._Ring(16))
    for M in (JM, TM):
        for i in range(n):
            M.trace.instant("e", i=i)
    assert _events(TM) == _events(JM)
    assert TM.trace.capacity() == 16
    assert TM.trace.total_events() == JM.trace.total_events() == n
    assert [e["args"]["i"] for e in _events(TM)] == \
        list(range(max(0, n - 16), n))


def test_off_records_nothing(clock):
    reset_both()
    set_monitor(False)
    for M in (JM, TM):
        _calls(M, clock)
        assert M.trace.events() == [] and M.trace.total_events() == 0


def test_flight_payload_matches(monitor_on, clock):
    for M in (JM, TM):
        clock.now = 1000.0
        _calls(M, clock)
        M.inc("serving.requests.completed", 3)
        M.slo.record_rejected("t")
        M.forensics.note(5, "enqueue", t=1000.0, tenant="t")
        M.forensics.note_terminal(5, "completed", t=1000.5)
    j = JM.trace.flight_payload("manual")
    t = TM.trace.flight_payload("manual")
    assert t.keys() == j.keys()
    for k in ("kind", "reason", "trace_capacity", "trace_total_events",
              "metrics", "slo", "forensics", "unix_time"):
        assert t[k] == j[k], k
    strip = [{k: v for k, v in e.items() if k != "tid"}
             for e in t["events"]]
    assert strip == [{k: v for k, v in e.items() if k != "tid"}
                     for e in j["events"]]
    # the unported planes' blocks are None; the KV block is the
    # reference's KV part
    assert t["timeseries"] is None and t["federation"] is None
    assert t["numerics"]["kv"] == j["numerics"]["kv"]
    assert t["numerics"]["kv_quant"] == j["numerics"]["kv_quant"]


def test_flight_record_written_only_when_armed(monitor_on, tmp_path,
                                               monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FLIGHT_RECORD", raising=False)
    TM.trace.set_flight_record_path(None)
    try:
        assert TM.trace.dump_flight_record() is None
        TM.trace.instant("x")
        path = tmp_path / "bb" / "flight.json"
        TM.trace.set_flight_record_path(str(path))
        assert TM.trace.flight_record_path() == str(path)
        payload = TM.trace.dump_flight_record(reason="test")
        disk = json.loads(path.read_text())
        assert disk["reason"] == "test" == payload["reason"]
        assert disk["kind"] == "paddle_tpu.flight_record"
        assert [e["name"] for e in disk["events"]] == ["x"]
    finally:
        TM.trace.set_flight_record_path(TTR._UNSET)


def test_env_arms_the_flight_record(monkeypatch, tmp_path):
    p = str(tmp_path / "env.json")
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_RECORD", p)
    TM.trace.set_flight_record_path(TTR._UNSET)
    assert TM.trace.flight_record_path() == p


def test_chrome_export_matches(monitor_on, clock, tmp_path):
    """The port merges no profiler track (it has no profiler yet), so its
    export equals the reference's without its profiler's events, whatever
    another test left in the JAX profiler's recorder."""
    out = {}
    for M, include in ((JM, False), (TM, True), (TM, False)):
        clock.now = 1000.0
        M.reset()
        _calls(M, clock)
        M.forensics.note(7, "enqueue", t=1000.0)
        M.trace.instant("serving.admit", rid=7)
        path = tmp_path / f"{M.__name__}{include}.json"
        M.trace.export_chrome_trace(str(path), include_profiler=include)
        doc = json.loads(path.read_text())
        for ev in doc["traceEvents"]:
            ev.pop("tid", None)
        out[M, include] = doc
    assert out[TM, True] == out[TM, False] == out[JM, False]
    out[TM] = out[TM, True]
    names = [e["name"] for e in out[TM]["traceEvents"]]
    assert names[0] == "process_name" and "outer" in names
    admit = [e for e in out[TM]["traceEvents"]
             if e["name"] == "serving.admit"][0]
    assert admit["args"]["forensics"] == "/requests/7"


@pytest.fixture(scope="module")
def preempting():
    """A serve that preempts (a starved pool), monitor on, fake clock."""
    mp = pytest.MonkeyPatch()
    clock = patch_clock(mp, FakeClock())
    equal_flops(mp)
    reset_both()
    set_monitor(True)
    script = [("sub", r, 5 + r % 4, 7 + r % 3, {}) for r in range(6)]
    try:
        yield serve_pair(tiny_pair(2), clock, script, num_slots=3,
                         max_len=16, page_size=4, num_pages=6,
                         decode_chunk=2)
    finally:
        set_monitor(False)
        reset_both()
        mp.undo()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_token_accounting_contract(preempting, side):
    out, _, planes, eng = preempting[side]
    c = planes["snapshot"]["counters"]
    kept = sum(len(o.tokens) for o in out.values())
    assert c["serving.requests.preempted"] > 0
    assert c["serving.tokens.generated"] - c["serving.tokens.discarded"] \
        == kept
    assert c["serving.tokens.generated"] == eng.stats.tokens_generated
    assert planes["snapshot"]["histograms"][
        "serving.latency.ttft_ms"]["count"] == len(out)


def test_lifecycle_events_match_the_reference(preempting):
    j, t = preempting["jax"][2]["events"], preempting["torch"][2]["events"]
    assert t == j
    names = {e["name"] for e in t}
    assert {"serving.enqueue", "serving.admit", "serving.first_token",
            "serving.prefill", "serving.decode_chunk", "serving.preempt",
            "serving.retire"} <= names


def test_fault_corrupt_and_raise_land_in_the_ring(monitor_on, tmp_path):
    path = tmp_path / "fault.json"
    TM.trace.set_flight_record_path(str(path))
    try:
        with TFAULTS.injected("train.batch", action="corrupt"):
            bad = TFAULTS.corrupt("train.batch", torch.zeros(3))
        assert torch.isnan(bad[0])
        with TFAULTS.injected("serving.drain", action="raise"):
            with pytest.raises(TFAULTS.FaultInjected):
                TFAULTS.hit("serving.drain")
        names = [(e["name"], e.get("args")) for e in TM.trace.events()]
        assert ("fault.corrupt", {"point": "train.batch",
                                  "action": "corrupt"}) in names
        assert ("fault.fired", {"point": "serving.drain",
                                "action": "raise"}) in names
        disk = json.loads(path.read_text())
        assert disk["reason"] == "fault:serving.drain:raise"
    finally:
        TM.trace.set_flight_record_path(TTR._UNSET)
