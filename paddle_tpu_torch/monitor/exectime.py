"""Sampled program execution timing (port of
``paddle_tpu/monitor/exectime.py``): 1-in-N sampling at the serving
engine's dispatch seams (prefill group, decode chunk, verify round),
timing the sampled dispatch to outputs-ready.

Why sample instead of timing every call: waiting for outputs is a
device synchronization, and timing every dispatch would serialize the
host-device pipeline the engine keeps full. The engine's seams call
the recorder with ``None`` right after the download they already make
(``.tolist()`` of a prefill group's tokens, ``.cpu()`` of a chunk's
emitted grid or a verify round's predictions), so sampling there adds
no synchronization at any rate. :func:`time_call` and a recorder
called with outputs wait through ``_block_until_ready``:
``torch.cuda.synchronize`` on each CUDA device the outputs lie on, and
nothing for CPU tensors, which are ready when returned. The rate is
``PADDLE_TPU_EXEC_SAMPLE`` (default 16; 0 disables sampling entirely).

What a sample feeds:

- the shared ``jit.program.exec_ms`` histogram (+ a
  ``jit.program.exec.samples`` counter), under the reference's names;
- per-program sampled count/mean/max on the
  :class:`monitor.programs.ProgramRecord` (``note_exec``);
- the last-sample slot :func:`take_last_sample_ms` hands to the step
  timeseries (``monitor/timeseries.py``; the engine's seams keep their
  samples out of it).

Gating: ``monitor.enabled()`` AND a nonzero sample rate. Off path =
one cached-flag branch, no counters, no syncs.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..core import flags as _flags
from .registry import LATENCY_BUCKETS_MS as _EXEC_BUCKETS

__all__ = ["sample_rate", "set_sample_rate", "maybe_sample",
           "record_exec", "time_call", "take_last_sample_ms", "reset"]

_FLAG = _flags.flag_info("enable_monitor")

_DEFAULT_RATE = 16

# Resolved sample rate: [None] = re-read the env on next use (tests
# flip it with set_sample_rate).
_RATE: list = [None]

# Per-program dispatch counters (registry key -> calls since the last
# sample). Plain dict ops are GIL-atomic enough: a lost increment under
# a race only shifts one sample point. Bounded defensively — keys of
# long-evicted programs must not grow this forever.
_COUNTS: dict = {}
_COUNTS_MAX = 4096
_MU = threading.Lock()

# Most recent sampled exec ms, consumed (and cleared) by the step
# timeseries so a row carries a sample only for steps where one landed.
_LAST_MS: list = [None]


def _block_until_ready(outputs):
    """Wait until ``outputs`` (a tensor or a pytree of them) are ready:
    one ``torch.cuda.synchronize`` per CUDA device they lie on. Also the
    indirection point where tests pin the number of added device
    synchronizations (monkeypatch this and count)."""
    import torch
    from torch.utils._pytree import tree_leaves
    devices = {x.device for x in tree_leaves(outputs)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


def sample_rate() -> int:
    """1-in-N sampling rate (``PADDLE_TPU_EXEC_SAMPLE``, default 16;
    0 or negative disables sampling)."""
    r = _RATE[0]
    if r is None:
        try:
            r = int(os.environ.get("PADDLE_TPU_EXEC_SAMPLE",
                                   str(_DEFAULT_RATE)))
        except ValueError:
            r = _DEFAULT_RATE
        r = max(r, 0)
        _RATE[0] = r
    return r


def set_sample_rate(n: Optional[int]):
    """Override the sampling rate in process (0 disables); ``None``
    re-reads the env var on next use."""
    _RATE[0] = max(int(n), 0) if n is not None else None


class _Recorder:
    """One armed sample: stamps t0 at creation (the dispatch seam),
    records when called with the dispatch's outputs. ``rec(None)``
    skips the block — for seams whose existing host download already
    synchronized (the engine's per-chunk ``.cpu()``), so sampling
    there adds zero extra synchronizations."""

    __slots__ = ("key", "feed_last", "_t0")

    def __init__(self, key, feed_last: bool):
        self.key = key
        self.feed_last = feed_last
        self._t0 = time.perf_counter()

    def __call__(self, outputs=None):
        if outputs is not None:
            _block_until_ready(outputs)
        record_exec(self.key, (time.perf_counter() - self._t0) * 1e3,
                    feed_last=self.feed_last)


def maybe_sample(key, feed_last: bool = True) -> Optional[_Recorder]:
    """Arm a sample for this dispatch of program ``key`` iff the
    monitor is on, sampling is enabled, and this call is the 1-in-N.
    Returns a recorder (call it with the outputs right after the
    dispatch) or None. The None path touches no device API and adds no
    synchronization. ``feed_last=False`` keeps the sample out of the
    step-timeseries last-sample slot — the ENGINE seams pass it, so a
    decode-chunk sample landing between two train steps can never be
    misattributed as that train step's exec time."""
    if not _FLAG.value:
        return None
    rate = sample_rate()
    if rate <= 0:
        return None
    if len(_COUNTS) > _COUNTS_MAX:
        with _MU:
            if len(_COUNTS) > _COUNTS_MAX:
                _COUNTS.clear()
    n = _COUNTS.get(key, 0) + 1
    if n >= rate:
        _COUNTS[key] = 0
        return _Recorder(key, feed_last)
    _COUNTS[key] = n
    return None


def record_exec(key, ms: float, feed_last: bool = True):
    """Feed one measured execution: the shared histogram, the sample
    counter, the program record's count/mean/max, and (for train-seam
    samples) the last-sample slot the step timeseries consumes."""
    from . import inc as _inc
    from . import observe as _observe
    from . import programs as _programs

    _observe("jit.program.exec_ms", ms,
             doc="sampled wall time of one program execution at the "
                 "dispatch seam (dispatch to outputs-ready), all "
                 "programs — per-program mean/max live on /programs",
             buckets=_EXEC_BUCKETS)
    _inc("jit.program.exec.samples",
         doc="program executions timed by the 1-in-N sampler")
    _programs.note_exec(key, ms)
    if feed_last:
        _LAST_MS[0] = ms


def time_call(key, fn, *args, **kwargs):
    """Explicitly timed execution (no sampling decision): run
    ``fn(*args, **kwargs)``, block until its outputs are ready, record
    the wall ms against ``key``. Returns ``(outputs, ms)`` — the bench
    harness uses this for its per-rung exec-ms distributions."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _block_until_ready(out)
    ms = (time.perf_counter() - t0) * 1e3
    if _FLAG.value:
        record_exec(key, ms)
    return out, ms


def take_last_sample_ms() -> Optional[float]:
    """The most recent sampled exec ms, consumed: a second call before
    the next sample returns None (so timeseries rows only carry a
    sample for steps where one actually landed)."""
    v = _LAST_MS[0]
    _LAST_MS[0] = None
    return v


def reset():
    """Drop sampling state (monitor.reset); the rate override is kept
    (it is configuration, not accumulated state)."""
    _COUNTS.clear()
    _LAST_MS[0] = None
