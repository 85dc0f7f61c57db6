"""StepTimer: train-step timeline split + goodput accounting (port of
``paddle_tpu/monitor/steptimer.py``; the module holds no JAX, so the
port is the reference's code).

A production training loop spends its wall time in three places the
operator needs separated before any tuning conversation can start:
waiting for data, running the step, and checkpointing. This module is
the seam: the loop brackets each phase, the timer aggregates into
monitor histograms, emits trace spans (one timeline row per phase),
appends one row a step to the step time series
(``monitor/timeseries.py``) and reports **goodput**: useful tokens per
wall second.

Usage::

    st = monitor.StepTimer("train")
    for batch in st.iter_data(loader):        # data-wait timed per next()
        with st.compute():
            loss = step_fn(params, opt, batch)
        st.end_step(useful_tokens=n_real_tokens)
    print(st.report())

Checkpoint time can be billed two ways: explicitly (``with
st.checkpoint():``) or ambiently: ``CheckpointManager.save`` wraps its
work in :func:`ambient_phase`, which attributes the time to whichever
StepTimer is ACTIVE on that thread (activation is automatic while one
of the timer's phase contexts runs, or scoped with ``with st:``), so a
checkpoint taken inside a loop lands in the right bucket without
threading the timer through the caller.

Step listeners (:func:`add_step_listener`) run at every ``end_step``,
monitor on or off: the hang watchdog's heartbeat feed
(``training/sentinel.py``).

Gating: with ``FLAGS_enable_monitor`` unset every entry point is one
cached-flag branch; nothing registers, ``report()`` returns {}.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ..core import flags as _flags
from . import trace as _trace
from .registry import LATENCY_BUCKETS_MS as _PHASE_BUCKETS

__all__ = ["StepTimer", "ambient_phase", "add_step_listener",
           "remove_step_listener"]

_FLAG = _flags.flag_info("enable_monitor")

_PHASES = ("data_wait", "compute", "checkpoint")

# Step listeners: fn() invoked on EVERY StepTimer.end_step, regardless
# of FLAGS_enable_monitor — the hang watchdog's heartbeat feed
# (training/sentinel.py). A stalled step must be detectable even when
# metrics are off, so this sits above the flag gate; with no listeners
# the cost is one empty-tuple check.
_STEP_LISTENERS: list = []


def add_step_listener(fn):
    """Register ``fn()`` to run at every ``end_step`` on any timer
    (idempotent). Exceptions are swallowed — a broken listener must not
    take down the training loop."""
    if fn not in _STEP_LISTENERS:
        _STEP_LISTENERS.append(fn)


def remove_step_listener(fn):
    try:
        _STEP_LISTENERS.remove(fn)
    except ValueError:
        pass

# Thread-local active timer (the ambient_phase target).
_ACTIVE = threading.local()


class _Phase:
    """One timed phase; re-enterable (a step may wait for data twice).
    The phase's timer is the thread's ambient target only WHILE the
    phase runs — the previous target is restored on exit, so a
    finished loop's timer never keeps collecting ambient time."""

    __slots__ = ("_timer", "_name", "_t0", "_prev")

    def __init__(self, timer: "StepTimer", name: str):
        self._timer = timer
        self._name = name
        self._t0 = None
        self._prev = None

    def __enter__(self):
        self._t0 = time.perf_counter() if _FLAG.value else None
        if self._t0 is not None:
            self._prev = getattr(_ACTIVE, "timer", None)
            _ACTIVE.timer = self._timer
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            self._timer._add(self._name,
                             time.perf_counter() - self._t0)
            self._t0 = None
            if getattr(_ACTIVE, "timer", None) is self._timer:
                _ACTIVE.timer = self._prev
            self._prev = None
        return False


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullPhase()


class StepTimer:
    """Per-loop accumulator of phase seconds + useful-token goodput.

    Thread model: one StepTimer per training loop (one thread closes
    steps); ``ambient_phase`` may bill checkpoint time from the same
    thread's call stack. Metric names are prefixed ``train.`` so one
    dashboard row covers every loop; the instance keeps its own totals
    for ``report()``."""

    def __init__(self, name: str = "train"):
        self.name = name
        self._prev_active: list = []
        self._mu = threading.Lock()
        self._totals = {p: 0.0 for p in _PHASES}
        # this step's phase seconds (reset at end_step): the per-step
        # split the timeseries ring records alongside the cumulative
        # histograms
        self._step_phase = {p: 0.0 for p in _PHASES}
        self._steps = 0
        self._useful_tokens = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._t_step_open: Optional[float] = None

    # -- phase contexts -----------------------------------------------------

    def data_wait(self):
        return _Phase(self, "data_wait") if _FLAG.value else _NULL

    def compute(self):
        return _Phase(self, "compute") if _FLAG.value else _NULL

    def checkpoint(self):
        return _Phase(self, "checkpoint") if _FLAG.value else _NULL

    def iter_data(self, iterable):
        """Wrap a dataloader: each ``next()`` is billed as data-wait."""
        it = iter(iterable)
        while True:
            with self.data_wait():
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def __enter__(self):
        if _FLAG.value:
            self._prev_active.append(getattr(_ACTIVE, "timer", None))
            _ACTIVE.timer = self
        return self

    def __exit__(self, *exc):
        if self._prev_active:
            _ACTIVE.timer = self._prev_active.pop()
        return False

    # -- accumulation -------------------------------------------------------

    def _add(self, phase: str, seconds: float):
        from . import observe as _observe
        with self._mu:
            self._totals[phase] += seconds
            self._step_phase[phase] += seconds
            now = time.perf_counter()
            if self._t_first is None:
                self._t_first = now - seconds
            self._t_last = now
            if self._t_step_open is None:
                self._t_step_open = now - seconds
        _observe(f"train.step.{phase}_ms", seconds * 1e3,
                 doc=f"wall time of the {phase} phase of one train step",
                 buckets=_PHASE_BUCKETS)
        _trace.complete(f"step.{phase}",
                        time.perf_counter_ns() - int(seconds * 1e9),
                        int(seconds * 1e9), timer=self.name)

    def end_step(self, useful_tokens: int = 0, loss=None):
        """Close one step: observes the step total, counts useful
        tokens, refreshes the goodput gauges, and appends one row to
        the step timeseries (``monitor/timeseries.py`` — phase split,
        optional ``loss``, the step's sampled exec ms when one landed).
        Step listeners (the hang watchdog's heartbeats) fire first,
        monitor on or off. Pass ``loss`` only when it is already a
        host value — coercing a device scalar here would add a sync
        the loop didn't ask for."""
        for fn in tuple(_STEP_LISTENERS):
            try:
                fn()
            except Exception:
                pass
        if not _FLAG.value:
            return
        from . import exectime as _exectime
        from . import inc as _inc
        from . import observe as _observe
        from . import set_gauge as _set_gauge
        from . import timeseries as _timeseries
        now = time.perf_counter()
        with self._mu:
            t_open = self._t_step_open if self._t_step_open is not None \
                else now
            self._t_step_open = None
            self._steps += 1
            self._useful_tokens += int(useful_tokens)
            self._t_last = now
            wall = (self._t_last - self._t_first) \
                if self._t_first is not None else 0.0
            tokens = self._useful_tokens
            compute_s = self._totals["compute"]
            step_phase = dict(self._step_phase)
            for p in _PHASES:
                self._step_phase[p] = 0.0
        _timeseries.record_step(
            step=self._steps,
            total_ms=(now - t_open) * 1e3,
            data_wait_ms=step_phase["data_wait"] * 1e3,
            compute_ms=step_phase["compute"] * 1e3,
            checkpoint_ms=step_phase["checkpoint"] * 1e3,
            loss=loss,
            goodput_tokens_per_sec=(tokens / wall)
            if (wall > 0 and tokens) else None,
            exec_ms=_exectime.take_last_sample_ms())
        _observe("train.step.total_ms", (now - t_open) * 1e3,
                 doc="wall time of one full train step (all phases + "
                     "untracked host time)", buckets=_PHASE_BUCKETS)
        if useful_tokens:
            _inc("train.tokens.useful", int(useful_tokens),
                 doc="non-padding tokens consumed by training steps")
        if wall > 0:
            if tokens:
                # only loops that report tokens write the goodput
                # gauge: a token-blind loop writing 0 would read as
                # "goodput collapsed" (and clobber a token-aware
                # loop's value — the gauge is process-global)
                _set_gauge("train.goodput.tokens_per_sec",
                           round(tokens / wall, 2),
                           doc="useful tokens / wall seconds since "
                               "the timer's first phase")
            _set_gauge("train.goodput.compute_fraction",
                       round(compute_s / wall, 4),
                       doc="fraction of wall time inside the compiled "
                           "step (1 - data-wait - checkpoint - host)")
        _trace.instant("step.end", timer=self.name, step=self._steps,
                       tokens=int(useful_tokens))

    # -- reporting ----------------------------------------------------------

    def report(self) -> dict:
        """Totals + fractions + goodput; {} before any timed phase."""
        with self._mu:
            if self._t_first is None:
                return {}
            wall = max((self._t_last or self._t_first) - self._t_first,
                       1e-12)
            out = {
                "name": self.name,
                "steps": self._steps,
                "wall_s": round(wall, 4),
                "useful_tokens": self._useful_tokens,
                "goodput_tokens_per_sec": round(
                    self._useful_tokens / wall, 2),
            }
            tracked = 0.0
            for p in _PHASES:
                s = self._totals[p]
                tracked += s
                out[f"{p}_s"] = round(s, 4)
                out[f"{p}_fraction"] = round(s / wall, 4)
            out["untracked_s"] = round(max(wall - tracked, 0.0), 4)
            return out


def ambient_phase(name: str):
    """Phase context billing to the thread's ACTIVE StepTimer — the
    seam ``CheckpointManager.save`` uses so callback-driven saves land
    in their loop's checkpoint bucket without threading the timer
    through the callback API. Outside any active timer the time lands
    on a shared "ambient" timer (the histograms still see it); with
    the monitor off this is a single no-op branch."""
    if not _FLAG.value:
        return _NULL
    timer = getattr(_ACTIVE, "timer", None)
    if timer is None:
        timer = _orphan_timer()
    return _Phase(timer, name)


_ORPHAN = [None]


def _orphan_timer() -> StepTimer:
    """Shared sink for ambient phases outside any loop's timer (a
    standalone CheckpointManager.save still lands in the histograms)."""
    t = _ORPHAN[0]
    if t is None:
        t = _ORPHAN[0] = StepTimer("ambient")
    return t
