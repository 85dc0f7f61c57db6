"""Program registry: which serving programs ran, at which shapes, and
what each one costs (port of ``paddle_tpu/monitor/programs.py``).

A bounded process-global list of :class:`ProgramRecord`s. The serving
engine records each of its programs (prefill group, shared prefill,
decode chunk, verify window) at the first dispatch of its (kind, shape)
key and counts every later dispatch as a hit; the exec-timing sampler
(``monitor/exectime.py``) folds its samples into the record.

Where the port differs: the reference has XLA build each program and
reads its FLOPs and bytes from XLA's cost analysis
(``record_jit_call``). XLA counts the body of a ``lax.scan`` once, so
the reference's FLOPs of a program that loops over layers, or over the
steps of a decode chunk, are those of one layer and one step. The port
runs eager PyTorch, so :func:`record_call` takes the FLOPs and the bytes
its caller computed from the program's shapes (every layer, every step,
every matmul: the engine's ``serving_program_flops`` and
``serving_program_bytes``). A caller that counts no bytes leaves
``bytes_accessed`` None, as the reference's backend does when it reports
none: the plane never fabricates a value. The reference's lazy XLA
memory analyzer
(``analyze_pending``, ``analyzer_for``) has no counterpart: eager
PyTorch compiles no program to analyze. So a record's ``memory``,
``collectives`` and ``sharding`` are None, the ``/programs`` route
(``monitor/server.py``) serves the records without analysis, and
:func:`max_temp_bytes` is 0, the reference's value before any analysis
ran (ROADMAP C, "Reference behaviour").

Gating: callers gate on ``monitor.enabled()``; with the flag off nothing
records and the registry stays empty. ``monitor.reset()`` clears it.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

__all__ = ["ProgramRecord", "record_program", "record_call", "note_hit",
           "note_exec", "has_record", "flops_of", "programs_snapshot",
           "max_temp_bytes", "signature_of", "evicted_count", "next_uid",
           "reset"]

# Bounded registry: a serving process cycling through prompt buckets
# must not grow this without limit — oldest records evict FIFO.
_MAX_RECORDS = 256

_MU = threading.Lock()
_RECORDS: List["ProgramRecord"] = []
_BY_KEY: dict = {}
_EVICTED = [0]

# Process-unique monotonic ids for registry/provider keys: records
# OUTLIVE their owner, and CPython reuses addresses, so an owner keys
# its records by a uid, never by id(self). itertools.count.__next__ is
# C-implemented, so this is GIL-atomic.
_UID = itertools.count(1)


def next_uid() -> int:
    return next(_UID)


class ProgramRecord:
    """One program specialization. ``flops`` and ``bytes_accessed`` are
    the FLOPs and bytes of one call (None when unknown, never
    fabricated); ``memory``, ``comms`` and ``sharding`` are the
    reference's fields and stay None here (see the module docstring).

    Measured-execution fields (``monitor/exectime.py`` sampler):
    ``exec_samples`` / ``exec_total_ms`` / ``exec_max_ms`` accumulate
    the 1-in-N sampled dispatch-to-outputs-ready wall times (None when
    never sampled). ``last_hit_mono`` is the monotonic stamp of the last
    hit, so a snapshot shows staleness."""

    __slots__ = ("key", "name", "source", "signature", "donated",
                 "compile_ms", "flops", "bytes_accessed", "hits",
                 "created_unix", "memory", "comms", "sharding",
                 "analyze_error", "exec_samples", "exec_total_ms",
                 "exec_max_ms", "last_hit_mono")

    def __init__(self, key, name: str, source: str, signature: str,
                 donated=(), compile_ms: Optional[float] = None,
                 flops: Optional[float] = 0.0,
                 bytes_accessed: Optional[float] = None,
                 sharding: Optional[dict] = None):
        self.key = key
        self.name = name
        self.source = source
        self.signature = signature
        self.donated = tuple(donated)
        self.compile_ms = compile_ms
        self.flops = float(flops) if flops is not None else None
        self.bytes_accessed = bytes_accessed
        self.sharding = sharding
        self.hits = 0
        self.created_unix = round(time.time(), 3)
        self.memory: Optional[dict] = None
        self.comms: Optional[dict] = None
        self.analyze_error: Optional[str] = None
        self.exec_samples = 0
        self.exec_total_ms = 0.0
        self.exec_max_ms: Optional[float] = None
        self.last_hit_mono: Optional[float] = None

    def exec_mean_ms(self) -> Optional[float]:
        """Mean sampled execution ms; None when never sampled."""
        if not self.exec_samples:
            return None
        return self.exec_total_ms / self.exec_samples

    def as_dict(self) -> dict:
        mean = self.exec_mean_ms()
        return {
            "name": self.name,
            "source": self.source,
            "signature": self.signature,
            "donated_args": list(self.donated),
            "compile_ms": self.compile_ms,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "hits": self.hits,
            "created_unix": self.created_unix,
            "exec_samples": self.exec_samples,
            "exec_mean_ms": round(mean, 4) if mean is not None else None,
            "exec_max_ms": round(self.exec_max_ms, 4)
            if self.exec_max_ms is not None else None,
            "last_hit_age_s": round(time.monotonic()
                                    - self.last_hit_mono, 3)
            if self.last_hit_mono is not None else None,
            "memory": self.memory,
            "collectives": self.comms,
            "sharding": self.sharding,
            **({"analyze_error": self.analyze_error}
               if self.analyze_error else {}),
        }


def _leaf_sig(leaf) -> str:
    import numpy as np
    import torch
    if isinstance(leaf, torch.Tensor):
        dt = str(leaf.dtype).replace("torch.", "")
        shape = ",".join(str(int(d)) for d in leaf.shape)
        return f"{dt}[{shape}]"
    if isinstance(leaf, np.ndarray):
        shape = ",".join(str(int(d)) for d in leaf.shape)
        return f"{leaf.dtype.name}[{shape}]"
    return type(leaf).__name__


def signature_of(tree) -> str:
    """dtype[shape] summary of a pytree of tensors and arrays:
    ``'float32[4,128], int32[4]'`` (other leaves by type name)."""
    try:
        from torch.utils._pytree import tree_leaves
        return ", ".join(_leaf_sig(x) for x in tree_leaves(tree))
    except Exception:
        return ""


def record_program(key, name: str, *, source: str, signature: str = "",
                   donated=(), compile_ms: Optional[float] = None,
                   flops: Optional[float] = 0.0,
                   bytes_accessed: Optional[float] = None,
                   sharding: Optional[dict] = None) -> ProgramRecord:
    """Register one program (callers gate on ``monitor.enabled()``).
    Re-recording an existing key refreshes the record in place rather
    than duplicating it."""
    from . import set_gauge as _set_gauge

    rec = ProgramRecord(key, name, source, signature, donated,
                        compile_ms, flops, bytes_accessed=bytes_accessed,
                        sharding=sharding)
    with _MU:
        old = _BY_KEY.pop(key, None)
        if old is not None:
            try:
                _RECORDS.remove(old)
            except ValueError:
                pass
        _RECORDS.append(rec)
        _BY_KEY[key] = rec
        while len(_RECORDS) > _MAX_RECORDS:
            dead = _RECORDS.pop(0)
            _BY_KEY.pop(dead.key, None)
            _EVICTED[0] += 1
        n = len(_RECORDS)
    _set_gauge("jit.program.count",
               n, doc="compiled programs in the introspection registry")
    return rec


def record_call(key, name: str, flops: Optional[float], args: tuple, *,
                source: str = "serving", donated=(),
                bytes_accessed: Optional[float] = None) -> ProgramRecord:
    """Register a program at its first call: the signature of the call's
    arguments and the FLOPs and bytes of one call, which the caller
    computed from the program's shapes (the port's ``record_jit_call``,
    whose FLOPs and bytes come from XLA's cost analysis). Also feeds the reference's
    ``jit.program.flops`` counter and ``jit.program.last_flops`` gauge.
    Callers gate on ``monitor.enabled()``."""
    from . import inc as _inc
    from . import set_gauge as _set_gauge
    if flops and flops > 0:
        _inc("jit.program.flops", int(flops),
             doc="total XLA-cost-analysis FLOPs of compiled programs "
                 "(one invocation each), accumulated per cache miss")
        _set_gauge("jit.program.last_flops", int(flops),
                   doc="XLA-cost-analysis FLOPs of the most recently "
                       "compiled program")
    return record_program(key, name, source=source,
                          signature=signature_of(args), donated=donated,
                          flops=flops, bytes_accessed=bytes_accessed)


def note_hit(key):
    """Count a hit against the program's record and stamp its staleness
    clock (no-op for unknown or evicted keys)."""
    with _MU:
        rec = _BY_KEY.get(key)
        if rec is not None:
            rec.hits += 1
            rec.last_hit_mono = time.monotonic()


def note_exec(key, ms: float):
    """Fold one sampled execution time into the program's measured
    stats (``monitor/exectime.py`` feed; no-op for unknown keys)."""
    with _MU:
        rec = _BY_KEY.get(key)
        if rec is not None:
            rec.exec_samples += 1
            rec.exec_total_ms += float(ms)
            if rec.exec_max_ms is None or ms > rec.exec_max_ms:
                rec.exec_max_ms = float(ms)


def has_record(key) -> bool:
    with _MU:
        return key in _BY_KEY


def flops_of(key) -> Optional[float]:
    """Registered FLOPs of one program (the serving engine's per-chunk
    cost-attribution numerator), or None when the key is unknown or no
    count was given — the cost plane skips the contribution, never
    fabricates one."""
    with _MU:
        rec = _BY_KEY.get(key)
        return rec.flops if rec is not None else None


def max_temp_bytes() -> int:
    """Largest analyzed per-program temp footprint, the admission-headroom
    input of ``monitor/memory.py``: 0, since no program is analyzed (see
    the module docstring)."""
    with _MU:
        return max((r.memory.get("temp_bytes", 0) for r in _RECORDS
                    if r.memory), default=0)


def programs_snapshot() -> List[dict]:
    """JSON-safe record list, newest first."""
    with _MU:
        return [r.as_dict() for r in reversed(_RECORDS)]


def evicted_count() -> int:
    return _EVICTED[0]


def reset():
    with _MU:
        _RECORDS.clear()
        _BY_KEY.clear()
        _EVICTED[0] = 0
