"""paddle.profiler for the port (port of ``paddle_tpu/profiler``):
scheduler-driven profiling windows, host ``RecordEvent`` spans, op spans,
chrome-trace export and, on the card, ``torch.profiler``'s CUDA trace.

Reference capability: python/paddle/profiler/profiler.py (Profiler,
ProfilerState, make_scheduler, export_chrome_tracing) +
paddle/fluid/platform/profiler/host_tracer.cc (host span stream) +
chrometracing_logger.cc (trace export).

- Host spans: the native tracer ``csrc/host_tracer.cc`` (lock-free
  per-thread buffers, C ABI), built by the host C++ compiler into
  ``build/host/`` (``kernels/_build.py`` ``load_host``) and bound with
  ``ctypes``. A pure-Python recorder takes its place on a machine without
  a C++ compiler; ``_recorder_kind`` says which one ran.
- Op spans: while a window records, each registered op of the op
  library (``paddle_tpu_torch.add``, ``F.rms_norm``, ...) is one host
  span under the reference's op name, through the dispatch seam's
  profile hook (``ops/_op.py`` ``set_profile_hook``), and one
  ``torch.overrides.TorchFunctionMode`` on the thread that opened the
  window puts a host span around each other torch function call, named
  as the reference's dispatcher names its ops for the operators
  (``x + y`` is ``add``, ``x @ y`` ``matmul``) and by torch's function
  name otherwise (``mean``); the torch calls inside a registered op are
  not spanned again. Hook and mode are removed when the window ends, so
  outside a window they cost nothing.
- Device trace: ``Profiler(device_tracing=True)`` (or a ``GPU`` target)
  opens ``torch.profiler.profile`` over CPU and CUDA activity for each
  window and writes torch's chrome trace (the card's kernels from CUPTI)
  into ``device_trace_dir``; the reference brackets the window with
  ``jax.profiler.start_trace`` / ``stop_trace`` instead. Without a card
  this raises: the CPU is never traced in the card's name. It refuses, as
  the ``/profile`` route does, while another ``torch.profiler`` session
  is open (``monitor.profile_capture.exclusive_profiler``).
"""
from __future__ import annotations

import ctypes
import json
import os
import threading
import time
from enum import Enum
from typing import Callable, Iterable, Optional

from torch.overrides import TorchFunctionMode

from ..core import enforce as E

__all__ = [
    "Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
    "make_scheduler", "export_chrome_tracing", "load_profiler_result",
]


class ProfilerState(Enum):
    """reference: profiler.py ProfilerState."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    """reference: profiler.py ProfilerTarget. ``GPU`` (1, upstream
    Paddle's value and the reference's slot for its TPU) is the CUDA
    card; asking for it opens the device trace."""
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 3


# ---------------------------------------------------------------------------
# host span recorders
# ---------------------------------------------------------------------------

class _PyRecorder:
    """The recorder without a C++ compiler (pure Python, thread-local
    span stacks)."""

    def __init__(self):
        self._local = threading.local()
        self._all = []
        self._mu = threading.Lock()
        self.enabled = False
        self._t0 = 0
        self._epoch = 0

    def start(self):
        with self._mu:
            self._all.clear()
        # frames opened before this start (a span that straddled the last
        # stop) are epoch-stamped and dropped by end()
        self._epoch += 1
        self._t0 = time.perf_counter_ns()
        self.enabled = True

    def stop(self):
        self.enabled = False

    def _stack(self):
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def begin(self, name):
        if self.enabled:
            self._stack().append((name, time.perf_counter_ns(), self._epoch))

    def end(self):
        if not self.enabled:
            return
        st = self._stack()
        while st and st[-1][2] != self._epoch:
            st.pop()
        if st:
            name, t0, _ = st.pop()
            with self._mu:
                self._all.append((name, t0, time.perf_counter_ns(),
                                  threading.get_ident() & 0xFFFFFF))

    def events(self):
        with self._mu:
            return [dict(name=n, begin_ns=b, end_ns=e, tid=t)
                    for n, b, e, t in self._all]

    def export(self, path, process_name="paddle_tpu"):
        trace = [{"name": "process_name", "ph": "M", "pid": 0,
                  "args": {"name": process_name}}]
        for e in self.events():
            trace.append({"name": e["name"], "ph": "X", "pid": 0,
                          "tid": e["tid"],
                          "ts": (e["begin_ns"] - self._t0) / 1000.0,
                          "dur": (e["end_ns"] - e["begin_ns"]) / 1000.0})
        with open(path, "w") as f:
            json.dump({"traceEvents": trace}, f)
        return 0


_NAME_BYTES = 120      # host_tracer.cc Event::name


class _NativeRecorder:
    """``csrc/host_tracer.cc`` through ``ctypes``."""

    def __init__(self, lib):
        self._lib = lib
        u64p = ctypes.POINTER(ctypes.c_uint64)
        for fn in ("pt_tracer_start", "pt_tracer_stop", "pt_record_end"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = None
        lib.pt_tracer_enabled.argtypes = []
        lib.pt_tracer_enabled.restype = ctypes.c_int
        lib.pt_record_begin.argtypes = [ctypes.c_char_p]
        lib.pt_record_begin.restype = None
        lib.pt_record_span.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                       ctypes.c_uint64]
        lib.pt_record_span.restype = None
        lib.pt_now_ns.argtypes = []
        lib.pt_now_ns.restype = ctypes.c_uint64
        lib.pt_event_count.argtypes = []
        lib.pt_event_count.restype = ctypes.c_int64
        lib.pt_tracer_export.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.pt_tracer_export.restype = ctypes.c_int
        lib.pt_tracer_dump.argtypes = [ctypes.c_char_p, u64p, u64p, u64p,
                                       ctypes.c_int64]
        lib.pt_tracer_dump.restype = ctypes.c_int64

    @property
    def enabled(self):
        return bool(self._lib.pt_tracer_enabled())

    def start(self):
        self._lib.pt_tracer_start()

    def stop(self):
        self._lib.pt_tracer_stop()

    def begin(self, name):
        self._lib.pt_record_begin(name.encode())

    def end(self):
        self._lib.pt_record_end()

    def events(self):
        n = int(self._lib.pt_event_count())
        if n == 0:
            return []
        names = ctypes.create_string_buffer(_NAME_BYTES * n)
        begins = (ctypes.c_uint64 * n)()
        ends = (ctypes.c_uint64 * n)()
        tids = (ctypes.c_uint64 * n)()
        got = int(self._lib.pt_tracer_dump(names, begins, ends, tids, n))
        out = []
        for i in range(got):
            nm = names.raw[i * _NAME_BYTES:(i + 1) * _NAME_BYTES]
            out.append(dict(name=nm.split(b"\0", 1)[0].decode(),
                            begin_ns=int(begins[i]), end_ns=int(ends[i]),
                            tid=int(tids[i])))
        return out

    def export(self, path, process_name="paddle_tpu"):
        return int(self._lib.pt_tracer_export(path.encode(),
                                              process_name.encode()))


_recorder = None
_recorder_kind = None


def _get_recorder():
    """The process's recorder: the native tracer, built on first use, or
    the Python one where the host library cannot be built."""
    global _recorder, _recorder_kind
    if _recorder is not None:
        return _recorder
    from ..kernels import _build
    try:
        _recorder = _NativeRecorder(_build.load_host("host_tracer"))
        _recorder_kind = "native"
    except E.UnavailableError:
        _recorder = _PyRecorder()
        _recorder_kind = "python"
    return _recorder


# ---------------------------------------------------------------------------
# RecordEvent + op spans
# ---------------------------------------------------------------------------

class RecordEvent:
    """User span (reference: profiler/utils.py RecordEvent): a context
    manager, or explicit ``begin()`` / ``end()``."""

    def __init__(self, name: str, event_type=None):
        self.name = name

    def begin(self):
        _get_recorder().begin(self.name)

    def end(self):
        _get_recorder().end()

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()


# torch names whose op the reference's dispatcher names otherwise
# (core/tensor.py binds ``__sub__`` to ``subtract``, ...); an in-place
# ``<name>_`` keeps its trailing underscore
_PADDLE_NAMES = {"sub": "subtract", "mul": "multiply", "div": "divide",
                 "truediv": "divide", "true_divide": "divide",
                 "floordiv": "floor_divide"}
# operators whose reflected ``__r<op>__`` and in-place ``__i<op>__``
# forms name the op itself
_OPERATORS = ("add", "sub", "mul", "div", "truediv", "floordiv", "mod",
              "pow", "matmul", "and", "or", "xor", "lshift", "rshift")
# attribute access (``t.shape``, ``t.grad``) reaches __torch_function__ as
# a descriptor's __get__ / __set__: not an op
_NOT_OPS = ("__get__", "__set__", "__delete__")
_OP_NAMES: dict = {}


def _op_name(func) -> Optional[str]:
    """The span name of a torch function, or None for attribute access."""
    try:
        return _OP_NAMES[func]
    except (KeyError, TypeError):
        pass
    name = getattr(func, "__name__", None) or str(func)
    if name in _NOT_OPS:
        out = None
    else:
        if name.startswith("__") and name.endswith("__"):
            name = name[2:-2]
            if name[:1] in ("r", "i") and name[1:] in _OPERATORS:
                name = name[1:] + ("_" if name[0] == "i" else "")
        inplace = name.endswith("_") and not name.startswith("_")
        base = name[:-1] if inplace else name
        out = _PADDLE_NAMES.get(base, base) + ("_" if inplace else "")
    try:
        _OP_NAMES[func] = out
    except TypeError:
        pass
    return out


class _OpSpans(TorchFunctionMode):
    """A host span around each torch function call on this thread, and
    (``op_begin`` / ``op_end``, the op library's profile hook,
    ``ops/_op.py``) around each registered op under the reference's op
    name on any thread. Torch runs the handler with the mode off, so a
    function's own inner calls are not spanned, and neither are the torch
    calls inside a registered op."""

    def __init__(self, recorder):
        super().__init__()
        self._rec = recorder
        self._in_op = threading.local()

    def op_begin(self, name):
        self._rec.begin(name)
        self._in_op.depth = getattr(self._in_op, "depth", 0) + 1

    def op_end(self):
        self._in_op.depth -= 1
        self._rec.end()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(self._in_op, "depth", 0):
            return func(*args, **kwargs)
        name = _op_name(func)
        if name is None:
            return func(*args, **kwargs)
        self._rec.begin(name)
        try:
            return func(*args, **kwargs)
        finally:
            self._rec.end()


# ---------------------------------------------------------------------------
# scheduler + profiler
# ---------------------------------------------------------------------------

def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """reference: profiler.py make_scheduler -- step_num -> state."""
    if closed < 0 or ready < 0 or record < 1:
        raise E.InvalidArgumentError("closed/ready must be >=0 and record >=1")
    span = closed + ready + record

    def fn(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat > 0 and s >= repeat * span:
            return ProfilerState.CLOSED
        pos = s % span
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == span - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return fn


def _default_on_trace_ready(prof: "Profiler"):
    pass


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready factory writing the host spans as chrome://tracing
    JSON (reference: profiler.py export_chrome_tracing)."""
    os.makedirs(dir_name, exist_ok=True)

    def handle(prof: "Profiler"):
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(
            dir_name, f"{name}_time_{int(time.time() * 1000)}"
                      f".paddle_trace.json")
        _get_recorder().export(path, name)
        prof.last_export_path = path

    return handle


# what a window with no step before it does on the card between preparing
# its session and recording: launches that run while CUPTI is on but
# nothing is kept, then a wait -- about what one eager Llama step of
# 4 layers at [4, 2048] gives a READY step on an H100 (~1100 launches,
# ~240 ms), which kept every record where a session started at once lost
# its first 17-31
WARM_LAUNCHES = 1024
WARM_S = 0.25


def _warm_cupti(torch):
    """The stand-in for a READY step before a window with no step before
    it: ``WARM_LAUNCHES`` small launches on the current card and a
    ``WARM_S`` wait, with the session prepared and not yet recording."""
    buf = torch.zeros(1, device="cuda")
    for _ in range(WARM_LAUNCHES):
        buf.add_(1.0)
    torch.cuda.synchronize()
    time.sleep(WARM_S)


def load_profiler_result(path: str) -> dict:
    """Load a chrome-trace JSON produced by export_chrome_tracing (or a
    device trace of ``Profiler(device_tracing=True)``)."""
    with open(path) as f:
        return json.load(f)


class Profiler:
    """reference: profiler.py Profiler -- scheduler-state-driven windows,
    an ``on_trace_ready`` callback at the end of each, and the CUDA device
    trace with ``device_tracing=True`` or a ``ProfilerTarget.GPU`` target.

    ``scheduler`` is a step -> ``ProfilerState`` function, a ``(start,
    end)`` tuple (record steps ``[start, end)`` once) or None (record from
    ``start`` to ``stop``). Each window's device trace is written to
    ``device_trace_dir`` as ``device_<pid>_step<n>_<ms>.pt.trace.json``;
    ``last_device_trace`` names the newest and ``device_profile`` holds its
    ``torch.profiler.profile`` (``key_averages()``, ``events()``). The
    device trace of a window is prepared in the step before it (its READY
    step, or the closed step of a tuple or ``ready=0`` scheduler); a
    window with no step before it (``scheduler=None``, a window at step
    0, one right after another) is prepared when it opens and warmed by
    ``_warm_cupti`` before it records. From preparing to the window's end
    the session holds the process's profiler slot
    (``monitor.profile_capture.hold_profiler``), so ``/profile`` cannot
    open a second one beside it."""

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready=None, timer_only=False,
                 device_tracing: bool = False,
                 device_trace_dir: Optional[str] = None):
        import torch
        self.targets = list(targets) if targets is not None else [
            ProfilerTarget.CPU]
        if scheduler is None:
            self._scheduler = lambda step: ProfilerState.RECORD
        elif callable(scheduler):
            self._scheduler = scheduler
        else:   # (start, end) tuple: profile [start, end) ONCE (repeat=1)
            lo, hi = scheduler
            self._scheduler = make_scheduler(
                closed=lo, ready=0, record=hi - lo, repeat=1, skip_first=0)
        self.on_trace_ready = on_trace_ready or _default_on_trace_ready
        self.timer_only = timer_only
        self.device_tracing = bool(device_tracing
                                   or ProfilerTarget.GPU in self.targets)
        E.enforce(not self.device_tracing or torch.cuda.is_available(),
                  "Profiler: the device trace (device_tracing=True or "
                  "ProfilerTarget.GPU) needs a CUDA card; none is present",
                  error=E.UnavailableError)
        self.device_trace_dir = device_trace_dir or "./profiler_device_trace"
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self.last_export_path = None
        self.last_device_trace = None
        self.device_profile = None
        self._device = None          # the torch.profiler session, prepared
        self._device_started = False  # ... and recording
        self._slot = None            # the profiler slot it holds
        self._ops = None             # the open op-span mode

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self.current_state = self._scheduler(self.step_num)
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._begin_record()
        elif self._window_next(self.current_state):
            self._prepare_device()
        return self

    def stop(self):
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._end_record()
            self.on_trace_ready(self)
        self._release_device()
        self.current_state = ProfilerState.CLOSED

    def step(self):
        prev = self.current_state
        rec = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if prev == ProfilerState.RECORD_AND_RETURN:
            self._end_record()
            self.on_trace_ready(self)
        recording = prev in rec and prev != ProfilerState.RECORD_AND_RETURN
        self.step_num += 1
        nxt = self._scheduler(self.step_num)
        if nxt in rec and not recording:
            self._begin_record()
        elif recording and nxt not in rec:
            self._end_record()
        if self._window_next(nxt):
            self._prepare_device()
        elif nxt not in rec:
            self._release_device()
        self.current_state = nxt

    def _window_next(self, state) -> bool:
        """The step in ``state`` prepares the device trace: a READY step,
        or a closed one that a window follows (the tuple form, a
        scheduler with ``ready=0``), so that every window with a step
        before it starts from a session prepared a step ahead."""
        if state == ProfilerState.READY:
            return True
        return state == ProfilerState.CLOSED and self._scheduler(
            self.step_num + 1) in (ProfilerState.RECORD,
                                   ProfilerState.RECORD_AND_RETURN)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- internals ---------------------------------------------------------
    def _prepare_device(self):
        """Take the profiler slot, open the next window's
        ``torch.profiler`` session and prepare it (CUPTI on) without
        recording: the READY state's warm-up, as torch.profiler's own
        warmup steps. On an H100, in a process that had traced before, a
        session started at once lost the first ~30 kernels of its window;
        one prepared a step ahead lost none."""
        if self.timer_only or not self.device_tracing \
                or self._device is not None:
            return
        import torch
        from ..monitor import profile_capture as _pcap
        slot = _pcap.hold_profiler(torch, self.device_trace_dir)
        try:
            prof = _pcap._profiler(torch)
            prof.prepare_trace()
        except BaseException:
            _pcap.release_profiler(slot)
            raise
        self._device, self._slot, self._device_started = prof, slot, False

    def _give_back_slot(self):
        from ..monitor import profile_capture as _pcap
        slot, self._slot = self._slot, None
        if slot is not None:
            _pcap.release_profiler(slot)

    def _release_device(self):
        """Close a prepared session that never recorded (a READY step
        followed by no window), as torch.profiler does."""
        if self._device is not None and not self._device_started:
            prof, self._device = self._device, None
            try:
                prof.start_trace()
                prof.stop_trace()
            finally:
                self._give_back_slot()

    def _begin_record(self):
        if self.timer_only:
            return
        if self.device_tracing and not self._device_started:
            import torch
            cold = self._device is None
            self._prepare_device()
            if cold:
                _warm_cupti(torch)
            torch.cuda.synchronize()
            self._device.start_trace()
            self._device_started = True
        rec = _get_recorder()
        if not rec.enabled:
            rec.start()
        if self._ops is None:
            from ..ops import _op
            self._ops = _OpSpans(rec)
            self._ops.__enter__()
            _op.set_profile_hook(self._ops.op_begin, self._ops.op_end)

    def _end_record(self):
        if self.timer_only:
            return
        if self._ops is not None:
            from ..ops import _op
            _op.set_profile_hook(None, None)
            ops, self._ops = self._ops, None
            ops.__exit__(None, None, None)
        _get_recorder().stop()
        if self._device_started:
            import torch
            prof, self._device = self._device, None
            self._device_started = False
            torch.cuda.synchronize()
            try:
                prof.stop_trace()
            finally:
                self._give_back_slot()
            os.makedirs(self.device_trace_dir, exist_ok=True)
            path = os.path.join(
                self.device_trace_dir,
                f"device_{os.getpid()}_step{self.step_num}_"
                f"{int(time.time() * 1000)}.pt.trace.json")
            prof.export_chrome_trace(path)
            self.last_device_trace = path
            self.device_profile = prof

    # -- reporting ---------------------------------------------------------
    def events(self):
        return _get_recorder().events()

    def export(self, path: str, format: str = "json"):
        if format not in ("json", "chrome"):
            raise E.InvalidArgumentError(
                "only chrome-trace json export is supported")
        _get_recorder().export(path)
        self.last_export_path = path
        return path

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Aggregate span stats per name and render the reference-shaped
        table -- calls/total/avg/max/min/ratio columns, sortable by
        ``SortedKeys`` (reference: profiler.py summary ->
        profiler_statistic._build_table). Prints and returns the table
        string; ``statistics.op_breakdown(self.events())`` gives the
        machine-readable form."""
        from .statistics import summary_string
        table = summary_string(self.events(), sorted_by=sorted_by,
                               time_unit=time_unit, thread_sep=thread_sep)
        print(table)
        return table


from .statistics import SortedKeys  # noqa: E402  (single definition home)


class SummaryView(Enum):
    """Summary view selection (reference: profiler/profiler.py
    SummaryView)."""
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready factory writing the raw trace dict as a pickled
    protobuf-stand-in artifact (reference: profiler.py export_protobuf;
    the chrome-trace JSON remains the interchange format)."""
    import pickle
    import socket

    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{socket.gethostname()}"
        path = os.path.join(
            dir_name,
            f"{name}_time_{int(time.time() * 1000)}.paddle_trace.pb")
        json_path = path + ".json"
        _get_recorder().export(json_path, name)
        with open(json_path) as f:
            trace = json.load(f)
        os.remove(json_path)
        with open(path, "wb") as f:
            pickle.dump(trace, f)
        prof.last_export_path = path

    return handler


__all__ += ["SortedKeys", "SummaryView", "export_protobuf"]


class TracerEventType(Enum):
    """Host-span categories (reference:
    profiler/profiler_statistic.py TracerEventType; values mirror the
    reference enum so exported traces classify identically)."""
    Operator = 0
    Dataloader = 1
    ProfileStep = 2
    CudaRuntime = 3
    Kernel = 4
    Memcpy = 5
    Memset = 6
    UserDefined = 7
    OperatorInner = 8
    Forward = 9
    Backward = 10
    Optimization = 11
    Communication = 12
    PythonOp = 13
    PythonUserDefined = 14


__all__.append("TracerEventType")
