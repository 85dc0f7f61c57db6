"""Port parity: the profiler (``paddle_tpu_torch/profiler``) against
``paddle_tpu.profiler``.

- The scheduler: ``make_scheduler``'s state sequences and repeat cycles
  equal the reference's over a grid of arguments, and so do the steps at
  which ``Profiler``'s ``on_trace_ready`` fires (scheduled windows, the
  ``(start, end)`` tuple form, ``stop`` inside a window).
- The statistics (a copy of ``profiler/statistics.py``): ``build_table``,
  ``summary_string`` (also per thread), ``op_breakdown`` and the sort
  keys equal the reference's on the same synthetic events.
- The host tracer: ``csrc/host_tracer.cc`` builds with the host compiler
  (``_recorder_kind == "native"``, as the reference's test requires);
  ``RecordEvent`` spans nest; the chrome export has them; the Python
  recorder (no compiler) records the same spans.
- Op spans: while a window records, ``x + x`` is ``add`` and ``x @ y``
  ``matmul`` (the reference's names), and the torch function mode is
  gone after ``stop`` and between windows.
- The device trace needs a card: without one ``device_tracing=True`` and
  ``ProfilerTarget.GPU`` raise; with a foreign ``torch.profiler`` session
  open it refuses before recording anything.
"""
import json

import pytest
import torch

from paddle_tpu import profiler as JP
from paddle_tpu.profiler import statistics as JS
from paddle_tpu_torch import profiler as TP
from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.monitor import profile_capture as TPC
from paddle_tpu_torch.profiler import statistics as TS

SCHEDULES = [dict(closed=1, ready=1, record=2, repeat=0, skip_first=1),
             dict(closed=0, ready=0, record=1, repeat=2),
             dict(closed=2, ready=0, record=3, repeat=3, skip_first=2),
             dict(closed=0, ready=2, record=1),
             dict(closed=3, ready=1, record=4, repeat=1)]

EVENTS = [dict(name="a", begin_ns=0, end_ns=100, tid=1),
          dict(name="a", begin_ns=100, end_ns=400, tid=1),
          dict(name="b", begin_ns=0, end_ns=400, tid=2),
          dict(name="matmul", begin_ns=50, end_ns=75, tid=2),
          dict(name="c", begin_ns=0, end_ns=50, tid=1),
          dict(name="c", begin_ns=10, end_ns=60, tid=1)]


def _mode_on() -> bool:
    return torch._C._is_torch_function_mode_enabled()


@pytest.mark.parametrize("kw", SCHEDULES)
def test_scheduler_states_match_the_reference(kw):
    t, j = TP.make_scheduler(**kw), JP.make_scheduler(**kw)
    assert [t(i).name for i in range(40)] == [j(i).name for i in range(40)]


def test_scheduler_validation_matches():
    for kw in (dict(closed=-1, ready=0, record=1),
               dict(closed=0, ready=0, record=0)):
        with pytest.raises(ValueError):
            JP.make_scheduler(**kw)
        with pytest.raises(TE.InvalidArgumentError):
            TP.make_scheduler(**kw)


def _windows(mod, scheduler, steps, spans=False):
    got = []

    def ready(prof):
        got.append((prof.step_num,
                    sum(e["name"] == "tick" for e in prof.events())))

    p = mod.Profiler(scheduler=scheduler, on_trace_ready=ready)
    p.start()
    for _ in range(steps):
        if spans:
            with mod.RecordEvent("tick"):
                pass
        p.step()
    p.stop()
    return got


@pytest.mark.parametrize("sched", [
    *[("make", kw) for kw in SCHEDULES],
    ("tuple", (2, 4)), ("tuple", (0, 3)), ("tuple", (3, 12))])
def test_windows_fire_at_the_reference_steps(sched):
    kind, arg = sched
    make = (lambda mod: mod.make_scheduler(**arg)) if kind == "make" \
        else (lambda mod: arg)
    want = _windows(JP, make(JP), 12, spans=True)
    assert _windows(TP, make(TP), 12, spans=True) == want
    assert want


def test_summary_tables_match_the_reference():
    for unit in ("ns", "us", "ms", "s"):
        assert TS.build_table(TS.aggregate(EVENTS), time_unit=unit) == \
            JS.build_table(JS.aggregate(EVENTS), time_unit=unit)
    for key in TS.SortedKeys:
        jkey = JS.SortedKeys[key.name]
        assert TS.summary_string(EVENTS, sorted_by=key) == \
            JS.summary_string(EVENTS, sorted_by=jkey)
    assert TS.summary_string(EVENTS, thread_sep=True) == \
        JS.summary_string(EVENTS, thread_sep=True)
    assert TS.summary_string(EVENTS, span_ns=800) == \
        JS.summary_string(EVENTS, span_ns=800)
    assert TS.op_breakdown(EVENTS) == JS.op_breakdown(EVENTS)
    assert [k.name for k in TS.SortedKeys] == [k.name for k in JS.SortedKeys]
    assert [(k.name, k.value) for k in TP.TracerEventType] == \
        [(k.name, k.value) for k in JP.TracerEventType]
    with pytest.raises(ValueError):
        TS.build_table({}, time_unit="h")


def test_native_host_tracer_builds():
    TP._get_recorder()
    assert TP._recorder_kind == "native"
    assert isinstance(TP._recorder, TP._NativeRecorder)


@pytest.mark.parametrize("kind", ["native", "python"])
def test_record_event_spans_nest_and_export(kind, tmp_path):
    rec = TP._get_recorder() if kind == "native" else TP._PyRecorder()
    rec.start()
    rec.begin("outer")
    rec.begin("inner")
    rec.end()
    rec.end()
    rec.stop()
    rec.begin("after_stop")
    rec.end()
    ev = {e["name"]: e for e in rec.events()}
    assert set(ev) == {"outer", "inner"}
    assert ev["outer"]["begin_ns"] <= ev["inner"]["begin_ns"] \
        <= ev["inner"]["end_ns"] <= ev["outer"]["end_ns"]
    path = tmp_path / "t.json"
    assert rec.export(str(path), "proc") == 0
    doc = json.loads(path.read_text())
    assert doc["traceEvents"][0] == {"name": "process_name", "ph": "M",
                                     "pid": 0, "args": {"name": "proc"}}
    spans = {e["name"]: e for e in doc["traceEvents"][1:]}
    assert set(spans) == {"outer", "inner"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in spans.values())
    # a new session starts empty
    rec.start()
    rec.stop()
    assert rec.events() == []


def test_op_spans_named_as_the_reference_and_removed_after_stop(tmp_path):
    x = torch.ones(4, 4)
    p = TP.Profiler(on_trace_ready=TP.export_chrome_tracing(str(tmp_path)))
    assert not _mode_on()
    with p:
        assert _mode_on()
        y = x + x
        z = x @ y
        _ = (z - x) * 2.0 / 3.0
        _ = x.shape                   # attribute access: no span
        with TP.RecordEvent("my_block"):
            torch.nn.functional.linear(x, y).mean()
    assert not _mode_on()
    names = [e["name"] for e in p.events()]
    assert names[:5] == ["add", "matmul", "subtract", "multiply", "divide"]
    assert {"my_block", "linear", "mean"} <= set(names)
    assert "get" not in " ".join(names)
    spans = {e["name"]: e for e in p.events()}
    assert spans["my_block"]["begin_ns"] <= spans["linear"]["begin_ns"]
    doc = TP.load_profiler_result(p.last_export_path)
    assert {"add", "matmul", "my_block"} <= {e["name"]
                                            for e in doc["traceEvents"]}
    table = p.summary(sorted_by=TP.SortedKeys.CPUTotal, time_unit="us")
    assert "matmul" in table and "Total(us)" in table
    # the table is statistics.summary_string over the recorded events
    assert table == TS.summary_string(
        p.events(), sorted_by=TP.SortedKeys.CPUTotal, time_unit="us")
    _ = x + x                          # outside a window: no span
    assert [e["name"] for e in p.events()] == names


def test_op_spans_only_inside_scheduled_windows():
    x = torch.ones(2)
    seen = []

    def ready(prof):
        seen.append((prof.step_num, [e["name"] for e in prof.events()]))

    p = TP.Profiler(scheduler=TP.make_scheduler(closed=1, ready=0, record=1),
                    on_trace_ready=ready)
    p.start()
    modes = []
    for _ in range(4):
        modes.append(_mode_on())
        _ = x + x
        p.step()
    p.stop()
    assert modes == [False, True, False, True]
    assert seen == [(1, ["add"]), (3, ["add"])]
    assert not _mode_on()


def test_timer_only_records_nothing():
    p = TP.Profiler(timer_only=True)
    with p:
        assert not _mode_on()


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the device trace runs")


def test_device_trace_needs_a_card(no_card):
    with pytest.raises(TE.UnavailableError):
        TP.Profiler(device_tracing=True)
    with pytest.raises(TE.UnavailableError):
        TP.Profiler(targets=[TP.ProfilerTarget.CPU, TP.ProfilerTarget.GPU])
    assert TP.ProfilerTarget.GPU.value == 1
    assert not TP.Profiler().device_tracing


def test_device_trace_refuses_beside_another_session(monkeypatch):
    """A ``torch.profiler`` session already open (a benchmark's, or the
    ``/profile`` route's) makes the device trace raise ``CaptureBusy``
    before the window records anything, through the guard ``/profile``
    uses."""
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    p = TP.Profiler(device_tracing=True)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(TPC.CaptureBusy):
            p.start()
    assert p._device is None and p._ops is None and not _mode_on()


class _FakeSession:
    """Stands in for a ``torch.profiler`` session: records what the
    profiler asks of it."""

    def __init__(self, log):
        self.log = log

    def prepare_trace(self):
        self.log.append("prepare")

    def start_trace(self):
        self.log.append("start")

    def stop_trace(self):
        self.log.append("stop")

    def start(self):          # capture_sync's calls
        self.prepare_trace()
        self.start_trace()

    def stop(self):
        self.stop_trace()

    def export_chrome_trace(self, path):
        self.log.append("export")
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


def _fake_card(monkeypatch, log):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(TPC, "_profiler", lambda torch: _FakeSession(log))
    monkeypatch.setattr(TP, "_warm_cupti", lambda torch: log.append("warm"))


def test_device_trace_warms_up_in_the_ready_step(monkeypatch, tmp_path):
    """The window's session is prepared in the READY step before it,
    started when the window opens and stopped and exported when it ends;
    a READY step that leads to no window releases its session; the
    tuple form prepares in the closed step before its window, and a
    window with no step before it (``scheduler=None``, a tuple from
    step 0) prepares, warms the card up (``_warm_cupti``), then
    starts."""
    log = []
    _fake_card(monkeypatch, log)
    marks = []

    def step_through(p, n):
        p.start()
        for i in range(n):
            marks.append((i, p.current_state.name, list(log)))
            log.clear()
            p.step()
        p.stop()
        marks.append(("stop", p.current_state.name, list(log)))
        log.clear()

    step_through(TP.Profiler(
        scheduler=TP.make_scheduler(closed=1, ready=1, record=2, repeat=1),
        device_tracing=True, device_trace_dir=str(tmp_path)), 5)
    assert marks == [(0, "CLOSED", []), (1, "READY", ["prepare"]),
                     (2, "RECORD", ["start"]),
                     (3, "RECORD_AND_RETURN", []),
                     (4, "CLOSED", ["stop", "export"]),
                     ("stop", "CLOSED", [])]
    marks.clear()
    # stopped in the READY step: the prepared session is released
    step_through(TP.Profiler(
        scheduler=TP.make_scheduler(closed=0, ready=2, record=1),
        device_tracing=True, device_trace_dir=str(tmp_path)), 1)
    assert marks == [(0, "READY", ["prepare"]),
                     ("stop", "CLOSED", ["start", "stop"])]
    marks.clear()
    # no step before the window: prepared, warmed up, then started
    for sched in (None, (0, 1)):
        step_through(TP.Profiler(scheduler=sched, device_tracing=True,
                                 device_trace_dir=str(tmp_path)), 1)
        assert marks[0] == (0, "RECORD" if sched is None
                            else "RECORD_AND_RETURN",
                            ["prepare", "warm", "start"]), sched
        marks.clear()
    # the tuple form: prepared in the closed step before its window
    step_through(TP.Profiler(scheduler=(1, 3), device_tracing=True,
                             device_trace_dir=str(tmp_path)), 4)
    assert marks == [(0, "CLOSED", ["prepare"]),
                     (1, "RECORD", ["start"]),
                     (2, "RECORD_AND_RETURN", []),
                     (3, "CLOSED", ["stop", "export"]),
                     ("stop", "CLOSED", [])]
    assert not _mode_on()


@pytest.mark.parametrize("sched", [
    dict(closed=1, ready=1, record=2, repeat=1),
    dict(closed=0, ready=2, record=1),
    dict(closed=2, ready=0, record=1, repeat=1)])
def test_device_trace_holds_the_profiler_slot(monkeypatch, tmp_path,
                                              sched):
    """From the step that prepares a window's session to the window's end
    (or to ``stop`` in a READY step) the session holds the process's
    profiler slot: ``/profile``'s ``capture_sync`` raises ``CaptureBusy``
    there and runs again once the slot is given back."""
    log, held = [], []
    _fake_card(monkeypatch, log)
    monkeypatch.setattr(TPC, "MAX_SECONDS", 0.01)

    def busy():
        try:
            TPC.capture_sync(0.01, base_dir=str(tmp_path / "caps"))
        except TPC.CaptureBusy:
            return True
        return False

    p = TP.Profiler(scheduler=TP.make_scheduler(**sched),
                    device_tracing=True, device_trace_dir=str(tmp_path))
    p.start()
    for _ in range(4):
        held.append((p.current_state.name, TPC.capturing(), busy()))
        p.step()
    p.stop()
    held.append(("stop", TPC.capturing(), busy()))
    # a closed step holds the slot only where a window follows it
    nxt = [h[0] for h in held[1:]] + ["stop"]
    want = [s in ("READY", "RECORD", "RECORD_AND_RETURN")
            or (s == "CLOSED" and n.startswith("RECORD"))
            for s, n in zip((h[0] for h in held), nxt)]
    assert held == [(s, w, w) for (s, _, _), w in zip(held, want)]
    assert any(want) and not want[-1]
