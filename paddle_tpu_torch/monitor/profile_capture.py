"""On-demand profiler capture, ``/profile?seconds=N`` (port of
``paddle_tpu/monitor/profile_capture.py`` onto ``torch.profiler``).

The host spans (``monitor/trace.py``) tell what the scheduler was
doing; only a device trace shows what the card executed and when. This
module is the operator-facing seam: one bounded, exclusive, time-boxed
``torch.profiler`` window that an HTTP request (``monitor/server.py``
``/profile``) or a test opens on demand, with no code change, no
restart and no always-on tracing cost.

- **Exclusive**: one capture at a time, process-wide. A second request
  while one runs raises :class:`CaptureBusy` (the route answers HTTP
  409). A ``torch.profiler`` session that someone else holds also
  counts as busy: a second session started beside it ends the first one
  and loses its events, so the capture refuses instead.
- **Bounded**: captures land in per-capture subdirectories
  (``cap_<stamp>``) of the capture root (``PADDLE_TPU_PROFILE_DIR``,
  default ``<tmp>/paddle_tpu_profiles``); only the newest
  ``PADDLE_TPU_PROFILE_KEEP`` (default 4) are kept, oldest evicted.
- **Correlated**: while a capture is live, :func:`annotate` and
  :func:`annotate_step` return ``torch.profiler.record_function`` for
  the engine's ``serving.prefill``, ``serving.decode_chunk`` and
  ``serving.spec_chunk`` seams, so the card's kernels line up with the
  host spans. Outside a capture both return a shared null context (one
  list read).

Where the port differs: the trace format is torch's, not XLA's. A
capture writes one chrome trace, ``trace.json``, of the profiler's CPU
activity (operators and the annotations, from every thread, so the
engine's own stepping thread is in it) and, when a CUDA device is
present, its CUDA activity (kernels and copies, from CUPTI). The
reference writes XLA's profile directory (``plugins/profile/...``).
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
import time
from typing import Optional

__all__ = ["CaptureBusy", "capture_sync", "capturing", "capture_root",
           "exclusive_profiler", "hold_profiler", "release_profiler",
           "keep_captures", "annotate", "annotate_step",
           "list_captures", "TRACE_FILE"]


class CaptureBusy(RuntimeError):
    """A capture (or a foreign torch.profiler session) is already
    running; the ``/profile`` route maps this to HTTP 409."""


_MU = threading.Lock()
_ACTIVE: list = [None]        # info dict while a capture window is open

# Hard ceiling on one capture window: an operator typing seconds=3600
# must not pin the profiler (and its buffer growth) for an hour.
MAX_SECONDS = 60.0

TRACE_FILE = "trace.json"


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def capture_root() -> str:
    return os.environ.get(
        "PADDLE_TPU_PROFILE_DIR",
        os.path.join(tempfile.gettempdir(), "paddle_tpu_profiles"))


def keep_captures() -> int:
    try:
        return max(int(os.environ.get("PADDLE_TPU_PROFILE_KEEP", "4")), 1)
    except ValueError:
        return 4


def capturing() -> bool:
    return _ACTIVE[0] is not None


def annotate(name: str, **attrs):
    """``torch.profiler.record_function(name)`` while a capture is live,
    else a shared null context (one list read)."""
    if _ACTIVE[0] is None:
        return _NULL
    import torch
    args = ",".join(f"{k}={v}" for k, v in sorted(attrs.items())) or None
    return torch.profiler.record_function(name, args)


def annotate_step(name: str, step_num):
    """The step annotation (the reference's ``StepTraceAnnotation``):
    ``record_function(name)`` carrying ``step_num`` while a capture is
    live, else the shared null context."""
    if _ACTIVE[0] is None:
        return _NULL
    import torch
    return torch.profiler.record_function(name,
                                          f"step_num={int(step_num)}")


def list_captures(root: Optional[str] = None):
    """Capture subdirectories under the root, newest first."""
    root = root or capture_root()
    try:
        subs = [d for d in os.listdir(root)
                if d.startswith("cap_")
                and os.path.isdir(os.path.join(root, d))]
    except OSError:
        return []
    return sorted(subs, reverse=True)


def _evict_old(root: str) -> int:
    """Keep the newest ``keep_captures()`` capture dirs, delete the
    rest. Returns how many were evicted."""
    evicted = 0
    for d in list_captures(root)[keep_captures():]:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)
        evicted += 1
    return evicted


def _walk_files(d: str):
    out = []
    for dirpath, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(dirpath, f)
            try:
                size = os.path.getsize(p)
            except OSError:
                size = None
            out.append({"path": os.path.relpath(p, d), "bytes": size})
    out.sort(key=lambda e: e["path"])
    return out


def _profiler(torch):
    """A ``torch.profiler.profile`` of every thread, over CPU activity
    plus CUDA activity when a CUDA device is present."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    cfg = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=acts, experimental_config=cfg)


@contextlib.contextmanager
def exclusive_profiler(torch):
    """Hold the process's profiler slot while a ``torch.profiler``
    session starts: raises :class:`CaptureBusy` when a capture window is
    open or another session (a benchmark's ``torch.profiler``, a
    ``paddle_tpu_torch.profiler.Profiler`` device trace) holds the
    profiler, since a second session started beside it would end the
    first. Both ``capture_sync`` and the profiler's device trace start
    under it."""
    with _MU:
        if _ACTIVE[0] is not None:
            raise CaptureBusy(
                f"a capture is already running ({_ACTIVE[0]['dir']})")
        if torch.autograd.profiler._is_profiler_enabled:
            raise CaptureBusy("torch profiler unavailable: another "
                              "profiler session is running")
        yield


def hold_profiler(torch, owner: str) -> dict:
    """Take the process's profiler slot for a session whose owner starts
    and stops it itself (a ``Profiler`` device trace, from the step that
    prepares it to the end of its window): until
    :func:`release_profiler`, ``capture_sync`` and another hold raise
    :class:`CaptureBusy`, and :func:`annotate` marks the session's
    trace. Returns the slot's info."""
    with exclusive_profiler(torch):
        info = {"dir": owner, "started_unix": round(time.time(), 3)}
        _ACTIVE[0] = info
    return info


def release_profiler(info: dict):
    """Give back a slot taken by :func:`hold_profiler`."""
    with _MU:
        if _ACTIVE[0] is info:
            _ACTIVE[0] = None


def capture_sync(seconds: float, base_dir: Optional[str] = None) -> dict:
    """Run one exclusive capture window: start ``torch.profiler`` (CPU
    activity, plus CUDA activity when a CUDA device is present), sleep
    ``seconds`` (clamped to ``(0, MAX_SECONDS]``) while the workload
    runs, stop, write ``trace.json`` into a fresh ``cap_*``
    subdirectory, evict old captures. Returns ``{"dir", "seconds",
    "files", "evicted", "kept"}``. Raises
    :class:`CaptureBusy` when a window is already open or another
    profiler session holds the profiler."""
    import torch

    from . import inc as _inc
    from . import trace as _trace

    seconds = float(seconds)
    if not seconds > 0:
        raise ValueError(f"capture seconds must be > 0, got {seconds}")
    seconds = min(seconds, MAX_SECONDS)
    root = base_dir or capture_root()
    with exclusive_profiler(torch):
        cap_dir = os.path.join(
            root, f"cap_{time.strftime('%Y%m%d_%H%M%S')}_"
                  f"{int((time.time() % 1) * 1e6):06d}")
        os.makedirs(cap_dir, exist_ok=True)
        try:
            prof = _profiler(torch)
            prof.start()
        except Exception as e:
            shutil.rmtree(cap_dir, ignore_errors=True)
            raise CaptureBusy(
                f"torch profiler unavailable: {type(e).__name__}: {e}"
            ) from e
        info = {"dir": cap_dir, "seconds": seconds,
                "started_unix": round(time.time(), 3)}
        _ACTIVE[0] = info
    try:
        time.sleep(seconds)
    finally:
        try:
            prof.stop()
        finally:
            # a torn stop must still release the slot
            _ACTIVE[0] = None
    prof.export_chrome_trace(os.path.join(cap_dir, TRACE_FILE))
    evicted = _evict_old(root)
    files = _walk_files(cap_dir)
    _inc("monitor.profile.captures",
         doc="on-demand profiler capture windows completed")
    _trace.instant("profile.capture", dir=cap_dir,
                   seconds=seconds, files=len(files))
    return {"dir": cap_dir, "seconds": seconds, "files": files,
            "evicted": evicted, "kept": list_captures(root)}
