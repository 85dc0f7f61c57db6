"""Named-participant heartbeats (a copy of the named-beat transport of
``paddle_tpu/distributed/heartbeat.py``: ``touch_named``, ``start_named``,
``publish_named``, ``read_named``, ``remove_named``, ``stale_names`` and
their helpers).

A named participant (a serving replica, or a replica's admission journal
``<replica>.journal``) publishes a JSON payload on two transports: a beat
file ``<name>.alive`` in a heartbeat directory (the ``dir_path`` argument,
else ``PADDLE_HEARTBEAT_DIR``), whose mtime is the liveness beat, and a
key-value store (key ``pt_named/<name>``) for controllers with no shared
filesystem. Readers take the freshest copy across both (a ``seq`` field
breaks the tie).

The key-value leg takes a duck-typed ``client`` (with ``key_value_set``,
``key_value_try_get`` or ``blocking_key_value_get``, and
``key_value_delete``). Without one it finds :func:`_kv_client`: an
adapter over the default ``torch.distributed`` process group's store
(the reference finds JAX's coordination-service client), or None
without a process group, when only the file leg runs. The rank-keyed
beats, the dead and abort markers and the KV relay of the reference's
module wait for A10.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

__all__ = ["touch_named", "start_named", "publish_named", "read_named",
           "remove_named", "stale_names", "StoreClient"]

_AUTO_SUFFIX = ".alive"


def _touch(path, payload=None):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(payload or {"t": time.time()}))
    os.replace(tmp, path)


class StoreClient:
    """The four key-value calls the transport makes, over a
    ``torch.distributed`` store (``TCPStore``, ``FileStore``,
    ``HashStore``): values are text, as the reference's coordination
    service keeps them."""

    def __init__(self, store):
        self.store = store

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = False):
        if not allow_overwrite and self.store.check([key]):
            raise KeyError(f"key {key!r} is already set")
        self.store.set(key, value)

    def key_value_try_get(self, key: str) -> str:
        if not self.store.check([key]):
            raise KeyError(f"key {key!r} is not set")
        return self.store.get(key).decode()

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        import datetime
        self.store.wait([key], datetime.timedelta(milliseconds=timeout_ms))
        return self.store.get(key).decode()

    def key_value_delete(self, key: str):
        self.store.delete_key(key)


def _kv_client():
    """The process's key-value client: a :class:`StoreClient` over the
    default process group's store, or None without a process group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.distributed_c10d import _get_default_store
    return StoreClient(_get_default_store())


# -- named beats (serving replicas & other non-rank participants) ------------
#
# The elastic SERVING controller watches arbitrarily-NAMED participants --
# "replica3" is not a trainer rank. Name-keyed files, the reference's
# staleness semantics.

def touch_named(dir_path: str, name: str, payload: Optional[dict] = None):
    """One liveness beat for a named participant (``<name>.alive``)."""
    os.makedirs(dir_path, exist_ok=True)
    _touch(os.path.join(dir_path, f"{name}{_AUTO_SUFFIX}"),
           payload or {"t": time.time()})


def start_named(dir_path: str, name: str,
                interval: float = 1.0) -> threading.Event:
    """Auto-beat daemon for a named participant; returns the stop
    event. The thread dies with the process — a kill -9'd replica goes
    stale within ``interval`` + the watcher's timeout."""
    os.makedirs(dir_path, exist_ok=True)
    stop = threading.Event()
    path = os.path.join(dir_path, f"{name}{_AUTO_SUFFIX}")

    def loop():
        while not stop.is_set():
            try:
                _touch(path)
            except OSError:
                pass
            stop.wait(interval)

    threading.Thread(target=loop, daemon=True).start()
    return stop


_NAMED_KV_PREFIX = "pt_named"


def publish_named(name: str, payload: dict, *,
                  dir_path: Optional[str] = None, client=None) -> bool:
    """Publish a named participant's payload on BOTH transports: the
    beat file (``touch_named`` — the payload IS the beat, so a replica
    publishing telemetry frames needs no separate auto-beat daemon to
    stay live under ``stale_names``) and the coordination-service KV
    store (key ``pt_named/<name>``) for controllers with no shared
    filesystem. Never raises; returns True when at least one transport
    took the write."""
    ok = False
    d = _marker_dir(dir_path)
    if d:
        try:
            touch_named(d, name, payload)
            ok = True
        except (OSError, TypeError, ValueError):
            # TypeError/ValueError: a payload json.dumps can't take
            # (e.g. numpy scalars from a user slo_fn) must report
            # "transport took nothing", not crash the serving loop
            # the docstring promises never to take down
            pass
    client = client if client is not None else _kv_client()
    if client is not None:
        try:
            client.key_value_set(f"{_NAMED_KV_PREFIX}/{name}",
                                 json.dumps(payload),
                                 allow_overwrite=True)
            ok = True
        except Exception:
            pass
    return ok


def read_named(name: str, *, dir_path: Optional[str] = None,
               client=None, env_fallback: bool = True) -> Optional[dict]:
    """The freshest published payload for a named participant across
    both transports (a ``seq`` field, when both carry one, breaks the
    tie — the file and KV copies of one publisher never regress
    against each other). None when neither transport has it.
    ``env_fallback=False`` confines the file leg to the EXPLICIT
    ``dir_path`` (skipped when None) instead of the
    ``PADDLE_HEARTBEAT_DIR`` fallback — a KV-only reader must not
    ingest an unrelated fleet's generic ``replicaN`` payloads off a
    launcher-set env dir."""
    best = None
    d = _marker_dir(dir_path) if env_fallback else dir_path
    if d:
        try:
            with open(os.path.join(d, f"{name}{_AUTO_SUFFIX}")) as f:
                best = json.load(f)
        except (OSError, ValueError):
            best = None
    client = client if client is not None else _kv_client()
    if client is not None:
        try:
            kv_payload = json.loads(_kv_try(
                client, f"{_NAMED_KV_PREFIX}/{name}", probe_ms=10))
        except Exception:
            kv_payload = None
        if isinstance(kv_payload, dict):
            if not isinstance(best, dict) or \
                    _seq_of(kv_payload) > _seq_of(best):
                best = kv_payload
    return best if isinstance(best, dict) else None


def _seq_of(payload: dict) -> float:
    """A payload's seq as a comparable number; -1 when missing or
    malformed. Payloads are remote input — a corrupt KV copy carrying
    ``"seq": "5"`` must lose the tiebreak, not raise a TypeError that
    discards the valid file-transport copy too (and gets a healthy
    frame-is-the-beat replica stale-killed)."""
    s = payload.get("seq")
    if isinstance(s, bool) or not isinstance(s, (int, float)) \
            or s != s:
        return -1
    return s


def remove_named(dir_path: Optional[str], name: str, *, client=None,
                 env_fallback: bool = True):
    """GC a stopped or replaced named participant: drop its beat file
    and its KV payload key. Without this a long-lived controller dir
    accumulates one ``<name>.alive`` per replica the fleet ever ran —
    ``run_serving`` sweeps on every stop/replace. Idempotent, never
    raises. ``env_fallback=False`` confines the file removal to the
    EXPLICIT ``dir_path`` (skipped when None): a KV-only sweeper in a
    process where the launcher exported ``PADDLE_HEARTBEAT_DIR`` must
    not delete an unrelated fleet's beat files."""
    d = _marker_dir(dir_path) if env_fallback else dir_path
    if d:
        try:
            os.remove(os.path.join(d, f"{name}{_AUTO_SUFFIX}"))
        except OSError:
            pass
    client = client if client is not None else _kv_client()
    if client is not None:
        try:
            client.key_value_delete(f"{_NAMED_KV_PREFIX}/{name}")
        except Exception:
            pass


def stale_names(dir_path: str, names, timeout: float,
                started_at=None) -> Dict[str, str]:
    """{name: reason} for every stale named participant. Same contract
    as :func:`check_stale`'s auto-beat leg: a participant that never
    beat is stale only once its startup grace (one ``timeout`` from
    ``started_at``) is spent. ``started_at`` may be a single float or
    a {name: float} map (per-replica spawn times). A beat file OLDER
    than ``started_at`` is a leftover from a previous incarnation of
    the name (controllers reuse replica0, replica1, ...) and counts as
    never-beat — a fresh healthy replica must get its startup grace,
    not be declared stale off a predecessor's mtime."""
    now = time.time()
    stale: Dict[str, str] = {}
    for name in names:
        path = os.path.join(dir_path, f"{name}{_AUTO_SUFFIX}")
        t0 = started_at.get(name) if isinstance(started_at, dict) \
            else started_at
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            mtime = None
        if mtime is not None and (t0 is None or mtime >= t0):
            age = now - mtime
            if timeout > 0 and age > timeout:
                stale[name] = f"no liveness beat for {age:.1f}s"
        elif timeout > 0 and t0 is not None and now - t0 > timeout:
            stale[name] = ("never emitted a liveness beat "
                           f"({now - t0:.1f}s since spawn)")
    return stale



# -- helpers -----------------------------------------------------------------

def _marker_dir(dir_path: Optional[str]) -> Optional[str]:
    return dir_path or os.environ.get("PADDLE_HEARTBEAT_DIR")


def _kv_try(client, key: str, probe_ms: int = 50):
    """Short KV probe: ``key_value_try_get`` when the client has one,
    else a ``probe_ms`` blocking get (a store with no non-blocking
    read). Raises when absent."""
    try_get = getattr(client, "key_value_try_get", None)
    if try_get is not None:
        return try_get(key)
    return client.blocking_key_value_get(key, probe_ms)
