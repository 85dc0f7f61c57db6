"""Deterministic fault injection for crash-consistency testing (a copy
of ``paddle_tpu/testing/faults.py``).

Code under test declares **named injection points**
(``faults.hit("serving.drain")``), and a test -- or a chaos run via
``FLAGS_fault_injection`` -- arms an action at a point:

- ``raise``  raise :class:`FaultInjected` (clean in-process failure)
- ``delay``  sleep ``delay_s`` (widen race windows, keep going)
- ``kill``   ``os._exit(137)`` -- the ``kill -9`` equivalent: no
  ``finally`` blocks, no ``atexit``, nothing flushed.
- ``corrupt`` / ``corrupt_inf``  poison a VALUE passing through a
  :func:`corrupt` point: NaN (or +Inf) planted into the first array
  leaf (a torch tensor or a numpy array; integer leaves get an
  out-of-range id) -- data corruption for anomaly-path testing.

Arming is per-point with an ``nth`` trigger (fire on the Nth hit,
1-based), so a test can let the first call succeed and fail the second;
``every=True`` keeps firing on EVERY hit from the Nth onward (sustained
chaos). Disarmed, ``hit()`` is one list-indexing branch.

In-process use::

    from paddle_tpu_torch.testing import faults
    with faults.injected("serving.drain", action="raise"):
        engine.begin_drain()        # raises FaultInjected

Cross-process use (chaos runs, subprocess crash tests)::

    FLAGS_fault_injection=serving.drain:kill:1 python serve.py

The flag is parsed once at import; the spec is a comma-separated list
of ``point:action[:nth[:delay_s]]``.

As in the reference, a ``raise`` or ``kill`` first dumps the trace ring
to the armed flight record (``monitor.trace.record_fault``) and a
``corrupt`` records a ``fault.corrupt`` trace event. Where the port
differs: ``corrupt`` walks its value with ``torch.utils._pytree`` where
the reference walks a JAX tree.

The reference's injection points (grep ``faults.hit`` for the live
list); those marked [port] exist in the port so far:

- ``checkpoint.write``     before a shard file is written
- ``checkpoint.metadata``  before the coordinator writes metadata+manifest
- ``checkpoint.rename``    before the tmp-dir -> final-dir rename
- ``checkpoint.commit``    before the COMMIT marker lands
- ``collective.gather``    inside ``all_gather_object``
- ``collective.kv_get``    each poll of the typed collective fault
  layer's deadline loop
- ``dataloader.batch``     value point: each batch a DataLoader yields
- ``train.batch``          value point: each batch entering a sentinel
  loop / hapi train step
- ``serving.drain``        [port] as the serving engine enters its drain
  lifecycle (``ServingEngine.begin_drain``)
- ``drain.checkpoint``     before the elastic scale-in path's pre-drain
  checkpoint save
- ``drain.stop``           after ``drain_safe`` held, before the replica
  is stopped
- ``loadgen.replay.step``  each engine step of a single-engine trace
  replay
- ``loadgen.replica.<name>.step``  each pump tick of fleet replica
  ``<name>`` in a fleet trace replay
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

__all__ = ["FaultInjected", "inject", "clear", "injected", "hit",
           "corrupt", "hit_count", "armed", "KILL_EXIT_CODE"]

# 128 + SIGKILL(9): what a shell reports for a kill -9'd process.
KILL_EXIT_CODE = 137


class FaultInjected(RuntimeError):
    """Raised by an armed ``raise`` injection point."""


class _Injection:
    __slots__ = ("point", "action", "nth", "delay_s", "hits", "fired",
                 "every")

    def __init__(self, point: str, action: str, nth: int, delay_s: float,
                 every: bool = False):
        if action not in ("raise", "delay", "kill", "corrupt",
                          "corrupt_inf"):
            raise ValueError(f"unknown fault action {action!r} "
                             "(want raise|delay|kill|corrupt|corrupt_inf)")
        if nth < 1:
            raise ValueError(f"nth must be >= 1, got {nth}")
        self.point = point
        self.action = action
        self.nth = nth
        self.delay_s = delay_s
        self.hits = 0
        self.fired = False
        self.every = bool(every)


_MU = threading.Lock()
_POINTS: Dict[str, _Injection] = {}
_HITS: Dict[str, int] = {}       # lifetime hit counts, armed or not
# One-element armed gate: the disarmed hot path reads it without the
# lock (list indexing is GIL-atomic) and returns immediately.
_ARMED = [False]


def inject(point: str, action: str = "raise", nth: int = 1,
           delay_s: float = 0.05, every: bool = False):
    """Arm ``point`` to fire ``action`` on its ``nth`` hit (counted
    from now); ``every=True`` keeps firing on every hit from the Nth
    onward (sustained chaos — meaningful for ``delay``/``corrupt``
    storms; ``raise``/``kill`` end the flow on the first firing
    anyway). Re-arming a point resets its hit count."""
    inj = _Injection(point, action, nth, delay_s, every)
    with _MU:
        _POINTS[point] = inj
        _ARMED[0] = True
    return inj


def clear(point: Optional[str] = None):
    """Disarm one point (or all of them); lifetime hit counts survive."""
    with _MU:
        if point is None:
            _POINTS.clear()
        else:
            _POINTS.pop(point, None)
        _ARMED[0] = bool(_POINTS)


class injected:
    """Context manager: arm on enter, disarm (that point) on exit."""

    def __init__(self, point: str, action: str = "raise", nth: int = 1,
                 delay_s: float = 0.05, every: bool = False):
        self._args = (point, action, nth, delay_s, every)

    def __enter__(self):
        return inject(*self._args)

    def __exit__(self, *exc):
        clear(self._args[0])
        return False


def _fire(point: str, value_point: bool):
    """Shared arming logic: count the hit and return ``(action,
    delay_s)`` when the point's Nth hit fires. Corrupt actions only
    fire (and only count toward ``nth``) at value points — a plain
    ``hit()`` at a corrupt-armed point neither fires nor consumes."""
    with _MU:
        _HITS[point] = _HITS.get(point, 0) + 1
        inj = _POINTS.get(point)
        if inj is None or inj.fired:
            return None
        if not value_point and inj.action in ("corrupt", "corrupt_inf"):
            return None
        inj.hits += 1
        if inj.hits < inj.nth:
            return None
        if not inj.every:       # every=True re-fires on later hits
            inj.fired = True
        return inj.action, inj.delay_s


def _fire_fatal(point: str, action: str):
    """raise/kill tail shared by ``hit`` and ``corrupt``. Black box
    first: before the process dies (or the failure starts unwinding),
    dump the trace ring + metrics snapshot to the armed flight-record
    path. The lazy import keeps this module free of monitor dependencies
    on the no-fault path; ``record_fault`` never raises and does nothing
    when no destination is armed."""
    try:
        from ..monitor import trace as _trace
        _trace.record_fault(point, action)
    except Exception:
        pass
    if action == "kill":
        os._exit(KILL_EXIT_CODE)
    raise FaultInjected(f"fault injected at {point!r}")


def hit(point: str):
    """Declare an injection point. No-op (one branch) unless a test or
    ``FLAGS_fault_injection`` armed this point."""
    if not _ARMED[0]:
        return
    fired = _fire(point, value_point=False)
    if fired is None:
        return
    action, delay_s = fired
    # fire outside the lock: delay must not serialize unrelated points,
    # and a raise must not leave the lock held
    if action == "delay":
        time.sleep(delay_s)
        return
    _fire_fatal(point, action)


def corrupt(point: str, value):
    """Declare a VALUE injection point: returns ``value`` untouched
    unless this is the armed Nth hit — then a poisoned copy. The
    ``corrupt`` action plants into the first array leaf of the pytree
    (tuples/dicts/Tensors welcome): floating leaves get NaN (``corrupt``)
    or +Inf (``corrupt_inf``) at element 0; integer leaves get
    ``iinfo.min`` at element 0 — the out-of-range-token-id equivalent
    of bit-rot in an int data pipeline, which the guarded train step's
    id-range check turns into an anomaly. raise/delay/kill armed at a
    value point fire exactly as in :func:`hit`. Disarmed: one branch,
    value passes through by identity."""
    if not _ARMED[0]:
        return value
    fired = _fire(point, value_point=True)
    if fired is None:
        return value
    action, delay_s = fired
    if action == "delay":
        time.sleep(delay_s)
        return value
    if action in ("corrupt", "corrupt_inf"):
        try:
            from ..monitor import trace as _trace
            _trace.instant("fault.corrupt", point=point, action=action)
        except Exception:
            pass
        return _poison_first_leaf(value, action == "corrupt_inf")
    _fire_fatal(point, action)


def _poison_first_leaf(value, inf: bool):
    """A copy of ``value`` with the first poisonable array leaf
    corrupted (non-array leaves -- ints, None, strings -- pass over)."""
    from torch.utils import _pytree

    leaves, spec = _pytree.tree_flatten(value)
    for i, leaf in enumerate(leaves):
        poisoned = _poison_leaf(leaf, inf)
        if poisoned is not None:
            leaves[i] = poisoned
            return _pytree.tree_unflatten(leaves, spec)
    return value


def _bad_value(dt, inf: bool):
    import numpy as np
    dt = np.dtype(dt)
    if np.issubdtype(dt, np.floating):
        return float("inf") if inf else float("nan")
    if np.issubdtype(dt, np.unsignedinteger):
        # unsigned: iinfo.min is 0 -- a VALID token id, i.e. a silent
        # no-op; the out-of-range value is the other end
        return int(np.iinfo(dt).max)
    if np.issubdtype(dt, np.integer):
        return int(np.iinfo(dt).min)
    return None


def _torch_bad_value(dt, inf: bool):
    import torch
    if dt.is_floating_point:
        return float("inf") if inf else float("nan")
    if dt == torch.bool or dt.is_complex:
        return None
    info = torch.iinfo(dt)
    return info.max if info.min == 0 else info.min


def _poison_leaf(leaf, inf: bool):
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        bad = _torch_bad_value(leaf.dtype, inf)
        if bad is None or leaf.numel() == 0:
            return None
        out = leaf.clone()
        out.view(-1)[0] = bad
        return out
    if isinstance(leaf, np.ndarray):
        bad = _bad_value(leaf.dtype, inf)
        if bad is None or leaf.size == 0:
            return None
        out = np.array(leaf)
        out.flat[0] = bad
        return out
    return None


def hit_count(point: str) -> int:
    """Lifetime hits at ``point`` while *any* point was armed (the
    harness only counts when the gate is up, keeping hit() free in
    production)."""
    with _MU:
        return _HITS.get(point, 0)


def armed() -> bool:
    return _ARMED[0]


def _arm_from_spec(spec: str):
    """Parse a ``point:action[:nth[:delay_s]]`` comma list (the
    ``FLAGS_fault_injection`` format) and arm every entry."""
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) < 2:
            raise ValueError(
                f"bad FLAGS_fault_injection entry {part!r}: want "
                "point:action[:nth[:delay_s]]")
        point, action = bits[0], bits[1]
        nth = int(bits[2]) if len(bits) > 2 else 1
        delay_s = float(bits[3]) if len(bits) > 3 else 0.05
        inject(point, action=action, nth=nth, delay_s=delay_s)


def _init_from_flag():
    # core.flags reads the FLAGS_fault_injection env var at registration;
    # going through the registry keeps set_flags introspection working.
    try:
        from ..core import flags as _flags
        spec = _flags.flag_value("fault_injection")
    except Exception:
        spec = os.environ.get("FLAGS_fault_injection", "")
    if spec:
        _arm_from_spec(spec)


_init_from_flag()
