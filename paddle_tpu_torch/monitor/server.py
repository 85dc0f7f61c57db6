"""The operator plane's health-provider map (port of the part of
``paddle_tpu/monitor/server.py`` that the serving engine and the SLO
plane call with or without a server): :func:`plane_active`,
:func:`register_health_provider`, :func:`unregister_health_provider`
and :func:`health`.

Health providers: :func:`register_health_provider` maps a name to a
zero-arg callable returning a dict (``ok`` defaults True). Owners that
die (an engine) register through weakrefs and are pruned on read. A
broken provider reports its error but does not fail liveness — a
crashed *telemetry* hook must not get a healthy worker killed.

The HTTP server that serves :func:`health` at ``/healthz`` (with
``/metrics``, ``/slo``, ``/forensics`` and the other routes),
``start_server`` / ``stop_server`` / ``maybe_start`` and the profile
capture are ROADMAP A7(d). ``FLAGS_enable_monitor_server`` is defined so
that the serving engine can refuse it until then.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional

from ..core import flags as _flags

__all__ = ["plane_active", "register_health_provider",
           "unregister_health_provider", "health"]

_FLAG_SERVER = _flags.flag_info("enable_monitor_server")

_PROVIDERS_MU = threading.Lock()
_HEALTH_PROVIDERS: Dict[str, Callable[[], Optional[dict]]] = {}


def plane_active() -> bool:
    """True when the operator plane could serve a probe: the server
    flag is set (the reference also counts a running server; the port
    starts none, ROADMAP A7(d)). Entrypoints whose
    health providers are pruned only on reads (engine/sentinel
    weakrefs) gate their registration on this OR on the monitor flag —
    a fully-off process must register nothing, ever."""
    return bool(_FLAG_SERVER.value)


def _prune_dead_locked_snapshot():
    """Snapshot the provider map, call each provider, and drop the
    entries whose owner died (fn() -> None) — identity-checked, so a
    provider RE-registered under the same name between the snapshot
    and the pop is never deleted. Returns the live (name, fn, report)
    triples plus the raising (name, error) pairs."""
    with _PROVIDERS_MU:
        items = list(_HEALTH_PROVIDERS.items())
    live, errors, dead = [], [], []
    for name, fn in items:
        try:
            rep = fn()
        except Exception as e:
            errors.append((name, f"{type(e).__name__}: {e}"[:200]))
            continue
        if rep is None:
            dead.append((name, fn))
            continue
        live.append((name, fn, rep))
    if dead:
        with _PROVIDERS_MU:
            for name, fn in dead:
                if _HEALTH_PROVIDERS.get(name) is fn:
                    _HEALTH_PROVIDERS.pop(name, None)
    return live, errors


def register_health_provider(name: str, fn: Callable[[], Optional[dict]]):
    """Register/replace a ``/healthz`` contributor. ``fn()`` returns a
    JSON-safe dict (key ``ok`` defaults True; False flips the endpoint
    to 503) or None to self-prune (dead weakref owners). Each
    registration also sweeps dead entries, so a loop creating engines
    bounds the map by its LIVE owners even if no probe ever reads
    it."""
    with _PROVIDERS_MU:
        _HEALTH_PROVIDERS[name] = fn
    _prune_dead_locked_snapshot()


def unregister_health_provider(name: str):
    with _PROVIDERS_MU:
        _HEALTH_PROVIDERS.pop(name, None)


def health() -> tuple:
    """``(all_ok, payload)`` across the registered providers. Providers
    returning None are pruned (their owner died); providers raising are
    reported but do NOT fail liveness."""
    live, errors = _prune_dead_locked_snapshot()
    providers = {}
    ok = True
    for name, _, rep in live:
        providers[name] = rep
        # falsy, not `is False`: a provider computing ok from a numpy
        # bool (or 0) must still flip the probe
        if not rep.get("ok", True):
            ok = False
    for name, err in errors:
        providers[name] = {"error": err}
    payload = {
        "status": "ok" if ok else "unhealthy",
        "pid": os.getpid(),
        "unix_time": round(time.time(), 3),
        "providers": providers,
    }
    return ok, payload
