"""Worker liveness heartbeats and the dead-peer and abort markers (port
of ``paddle_tpu/distributed/heartbeat.py``).

Rank beats (elastic training): ``start`` runs a daemon thread that
touches ``rank<r>.alive`` in the heartbeat directory (``dir_path``,
else ``PADDLE_HEARTBEAT_DIR``) every interval, which dies with its
process; ``beat(step=n)`` from the training loop touches
``rank<r>.progress`` and opts the worker into wedge detection. The
launch controller's ``check_stale`` reads both.

Named beats (serving replicas, admission journals ``<replica>.journal``):
a JSON payload on a beat file ``<name>.alive``, whose mtime is the
liveness beat, and in a key-value store (key ``pt_named/<name>``) for
controllers with no shared filesystem. Readers take the freshest copy
across both (a ``seq`` field breaks the tie).

Markers: a worker's exit leaves ``rank<r>.g<gen>.dead`` (``mark_dead``,
``dead_ranks``) and a coordinated abort ``abort.g<gen>.json``
(``write_abort_marker``, ``read_abort_marker``), keyed by the elastic run
index (``elastic_generation``) and scoped to the job's rendezvous
address, so a marker of one world never fails the next;
``clear_run_markers`` sweeps the stale ones at launch.

The key-value leg takes a duck-typed ``client`` (with ``key_value_set``,
``key_value_try_get`` or ``blocking_key_value_get``, and
``key_value_delete``). Without one it finds :func:`_kv_client`: an
adapter over the default ``torch.distributed`` process group's store
(the reference finds JAX's coordination-service client), or None
without a process group, when only the file leg runs.
``KVHeartbeatWatcher`` measures staleness on that leg clock-skew-free
(the time since a rank's beat value last changed, on its own clock), and
``start_kv_relay`` mirrors every rank's key-value beats into a local
heartbeat directory for a controller that sees no shared filesystem.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

__all__ = ["start", "stop", "beat", "check_stale", "touch_named",
           "start_named", "publish_named", "read_named", "remove_named",
           "stale_names", "KVHeartbeatWatcher", "start_kv_relay",
           "elastic_generation", "mark_dead", "dead_ranks",
           "write_abort_marker", "read_abort_marker", "clear_run_markers",
           "StoreClient"]

_AUTO_SUFFIX = ".alive"
_PROGRESS_SUFFIX = ".progress"
_DEAD_SUFFIX = ".dead"
_KV_PREFIX = "paddle_hb"
_DEAD_KV_PREFIX = "pt_dead"
_ABORT_KV_PREFIX = "pt_abort"
_state = {"thread": None, "stop": None, "dir": None, "rank": None,
          "seq": 0}


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


# -- rank beats (elastic training) ------------------------------------------

def _kv_publish(kind: str, rank: int, payload: dict):
    client = _kv_client()
    if client is None:
        return False
    _state["seq"] += 1
    payload = dict(payload, seq=_state["seq"])
    try:
        client.key_value_set(f"{_KV_PREFIX}/{kind}/rank{rank}",
                             json.dumps(payload), allow_overwrite=True)
        return True
    except Exception:
        return False


def start(dir_path: Optional[str] = None, rank: Optional[int] = None,
          interval: float = 1.0):
    """Start the auto-beat daemon thread (idempotent). Called by
    ``env.init_parallel_env``; a no-op without a heartbeat directory."""
    dir_path = dir_path or os.environ.get("PADDLE_HEARTBEAT_DIR")
    if not dir_path:
        return False
    rank = rank if rank is not None else int(
        os.environ.get("PADDLE_TRAINER_ID", "0"))
    if _state["thread"] is not None and _state["thread"].is_alive():
        return True
    os.makedirs(dir_path, exist_ok=True)
    stop = threading.Event()
    path = os.path.join(dir_path, f"rank{rank}{_AUTO_SUFFIX}")

    def loop():
        while not stop.is_set():
            try:
                _touch(path)
            except OSError:
                pass
            _kv_publish("auto", rank, {"t": time.time()})
            stop.wait(interval)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    _state.update(thread=th, stop=stop, dir=dir_path, rank=rank)
    return True


def stop():
    if _state["stop"] is not None:
        _state["stop"].set()
        _state["thread"] = None


def beat(step: Optional[int] = None):
    """Emit a PROGRESS beat from the training loop. A worker that emits
    one opts into wedge detection: the watcher kills the job if its
    progress beat goes stale. Publishes to the file dir (when set) AND
    the KV store (when a process group's store is live)."""
    rank = _state["rank"] if _state["rank"] is not None else int(
        os.environ.get("PADDLE_TRAINER_ID", "0"))
    dir_path = _state["dir"] or os.environ.get("PADDLE_HEARTBEAT_DIR")
    if dir_path:
        os.makedirs(dir_path, exist_ok=True)
        _touch(os.path.join(dir_path, f"rank{rank}{_PROGRESS_SUFFIX}"),
               {"t": time.time(), "step": step})
    _kv_publish("progress", rank, {"t": time.time(), "step": step})


def check_stale(dir_path: str, ranks, auto_timeout: float,
                progress_timeout: float,
                started_at: Optional[float] = None) -> Dict[int, str]:
    """Watcher side: {rank: reason} for every stale worker among
    ``ranks`` (GLOBAL rank ids — a node's watcher passes its own ranks,
    node_rank*nproc..+nproc). A rank with no auto beat yet is stale only
    once ``started_at`` is more than auto_timeout old (a worker can
    wedge before its first beat — import hang, stuck backend init);
    progress staleness applies only to ranks that have beaten progress
    at least once."""
    now = time.time()
    stale = {}
    for rank in ranks:
        auto = os.path.join(dir_path, f"rank{rank}{_AUTO_SUFFIX}")
        prog = os.path.join(dir_path, f"rank{rank}{_PROGRESS_SUFFIX}")
        try:
            age = now - os.stat(auto).st_mtime
            if auto_timeout > 0 and age > auto_timeout:
                stale[rank] = f"no liveness beat for {age:.1f}s"
                continue
        except OSError:
            # never beat at all: stale once the startup grace (one
            # auto_timeout from job start) is spent
            if (auto_timeout > 0 and started_at is not None
                    and now - started_at > auto_timeout):
                stale[rank] = ("never emitted a liveness beat "
                               f"({now - started_at:.1f}s since launch)")
                continue
        try:
            page = now - os.stat(prog).st_mtime
            if progress_timeout > 0 and page > progress_timeout:
                stale[rank] = f"no training progress for {page:.1f}s"
        except OSError:
            pass   # never opted in
    return stale


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



# -- KV-store transport (multi-host, no shared filesystem) -------------------

class KVHeartbeatWatcher:
    """Staleness over KV beats, clock-skew-free: a rank's age is the
    time since its beat VALUE last changed, measured on THIS process's
    clock (cross-host timestamps are never compared)."""

    def __init__(self, client=None):
        self._client = client if client is not None else _kv_client()
        # key -> (last value, local time the value last changed)
        self._last: Dict[str, tuple] = {}

    def _age(self, key: str, now: float) -> Optional[float]:
        try:
            val = self._client.key_value_try_get(key)
        except Exception:
            return None                 # never published
        prev = self._last.get(key)
        if prev is None or prev[0] != val:
            self._last[key] = (val, now)
            return 0.0
        return now - prev[1]

    def check(self, ranks, auto_timeout: float, progress_timeout: float,
              started_at: Optional[float] = None) -> Dict[int, str]:
        """Same contract as ``check_stale``, over the KV transport."""
        now = time.time()
        stale: Dict[int, str] = {}
        for rank in ranks:
            age = self._age(f"{_KV_PREFIX}/auto/rank{rank}", now)
            if age is None:
                if (auto_timeout > 0 and started_at is not None
                        and now - started_at > auto_timeout):
                    stale[rank] = ("never published a liveness beat "
                                   f"({now - started_at:.1f}s since "
                                   "launch)")
                continue
            if auto_timeout > 0 and age > auto_timeout:
                stale[rank] = f"no liveness beat for {age:.1f}s"
                continue
            page = self._age(f"{_KV_PREFIX}/progress/rank{rank}", now)
            if page is not None and progress_timeout > 0 \
                    and page > progress_timeout:
                stale[rank] = f"no training progress for {page:.1f}s"
        return stale

    def latest(self, kind: str, rank: int) -> Optional[dict]:
        try:
            return json.loads(self._client.key_value_try_get(
                f"{_KV_PREFIX}/{kind}/rank{rank}"))
        except Exception:
            return None


def start_kv_relay(dir_path: str, world_ranks, interval: float = 1.0,
                   client=None) -> Optional[threading.Event]:
    """Rank-0 side: mirror every rank's KV beats into ``dir_path`` as
    the files the launch controller already watches, so a controller
    with no shared filesystem (and no process group of its own)
    sees remote hosts' liveness through its local disk. A rank's file
    is touched only when its KV beat VALUE changes, preserving the
    staleness signal. Returns the stop event (None if no client)."""
    watcher = KVHeartbeatWatcher(client)
    if watcher._client is None:
        return None
    os.makedirs(dir_path, exist_ok=True)
    stop = threading.Event()
    seen: Dict[str, str] = {}

    def loop():
        while not stop.is_set():
            for rank in world_ranks:
                for kind, suffix in (("auto", _AUTO_SUFFIX),
                                     ("progress", _PROGRESS_SUFFIX)):
                    key = f"{_KV_PREFIX}/{kind}/rank{rank}"
                    try:
                        val = watcher._client.key_value_try_get(key)
                    except Exception:
                        continue
                    if seen.get(key) == val:
                        continue
                    seen[key] = val
                    try:
                        _touch(os.path.join(
                            dir_path, f"rank{rank}{suffix}"),
                            json.loads(val))
                    except (OSError, ValueError):
                        pass
            stop.wait(interval)

    threading.Thread(target=loop, daemon=True).start()
    return stop


# -- dead-peer tombstones + coordinated-abort markers ------------------------
#
# A peer the launcher already reaped, or one that aborted on its own
# fault, is visible to the survivors at once. Two transports, as the
# beats: per-rank FILES in the heartbeat dir (written by the launch
# controller, which has no process group) and KV keys (written by
# workers, visible without a shared filesystem). Markers are
# GENERATION-keyed by the elastic run index: a marker from world
# incarnation g-1 must never kill incarnation g after a restart, and
# writers best-effort delete their stale-generation KV keys.

def elastic_generation() -> int:
    """The elastic world incarnation markers are keyed by (0 = first;
    the elastic managers export PADDLE_ELASTIC_RUN per relaunch)."""
    try:
        return int(os.environ.get("PADDLE_ELASTIC_RUN", "0"))
    except ValueError:
        return 0


def _job_identity(job: Optional[str]) -> Optional[str]:
    """Markers are scoped to one JOB: its rendezvous address (every
    launch picks a fresh free port by default, so two successive jobs
    reusing a log_dir — same generation 0 — can never honor each
    other's markers, while multi-node controllers of ONE job share the
    master and therefore the markers)."""
    return job or os.environ.get("PADDLE_MASTER")


def _job_matches(payload: dict) -> bool:
    """A marker counts only for the job that wrote it; markers or
    readers without a job identity (direct API use, tests) match
    everything."""
    mine = os.environ.get("PADDLE_MASTER")
    theirs = payload.get("job")
    return theirs is None or mine is None or theirs == mine


def mark_dead(rank: int, reason: str, *, dir_path: Optional[str] = None,
              client=None, generation: Optional[int] = None,
              job: Optional[str] = None):
    """Write rank ``rank``'s death marker (file + KV, whichever
    transports are reachable). Idempotent; never raises."""
    gen = elastic_generation() if generation is None else int(generation)
    payload = {"rank": int(rank), "reason": str(reason), "gen": gen,
               "job": _job_identity(job), "t": time.time()}
    d = _marker_dir(dir_path)
    if d:
        try:
            os.makedirs(d, exist_ok=True)
            _touch(os.path.join(d, f"rank{rank}.g{gen}{_DEAD_SUFFIX}"),
                   payload)
        except OSError:
            pass
    client = client if client is not None else _kv_client()
    if client is not None:
        try:
            client.key_value_set(
                f"{_DEAD_KV_PREFIX}/g{gen}/rank{rank}",
                json.dumps(payload), allow_overwrite=True)
        except Exception:
            pass


def dead_ranks(ranks, *, dir_path: Optional[str] = None, client=None,
               generation: Optional[int] = None) -> Dict[int, str]:
    """{rank: reason} for every rank in ``ranks`` with a death marker of
    THIS generation on either transport."""
    gen = elastic_generation() if generation is None else int(generation)
    d = _marker_dir(dir_path)
    client = client if client is not None else _kv_client()
    out: Dict[int, str] = {}
    for rank in ranks:
        payload = None
        if d:
            try:
                with open(os.path.join(
                        d, f"rank{rank}.g{gen}{_DEAD_SUFFIX}")) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                payload = None
        if payload is None and client is not None:
            try:
                # presence check only — never WAIT for a marker to
                # appear (the caller polls); 10ms bounds per-rank cost
                # on clients whose only read is a blocking get
                payload = json.loads(_kv_try(
                    client, f"{_DEAD_KV_PREFIX}/g{gen}/rank{rank}",
                    probe_ms=10))
            except Exception:
                payload = None
        if payload is not None and _job_matches(payload):
            out[int(rank)] = str(payload.get("reason", "dead"))
    return out


def write_abort_marker(rank: int, payload: dict, *,
                       dir_path: Optional[str] = None, client=None,
                       generation: Optional[int] = None,
                       job: Optional[str] = None):
    """Publish the coordinated-abort marker: the failing rank announces
    its typed collective fault so every surviving peer's wait loop fails
    fast instead of waiting out its own deadline. One marker per
    generation (last writer wins — any marker means the world is going
    down). Best-effort reclamation: the previous generation's KV marker
    is deleted. Never raises."""
    gen = elastic_generation() if generation is None else int(generation)
    payload = dict(payload, rank=int(rank), gen=gen,
                   job=_job_identity(job), t=time.time())
    d = _marker_dir(dir_path)
    if d:
        try:
            os.makedirs(d, exist_ok=True)
            _touch(os.path.join(d, f"abort.g{gen}.json"), payload)
        except OSError:
            pass
    client = client if client is not None else _kv_client()
    if client is not None:
        try:
            client.key_value_set(f"{_ABORT_KV_PREFIX}/g{gen}",
                                 json.dumps(payload),
                                 allow_overwrite=True)
        except Exception:
            pass
        if gen > 0:
            try:
                client.key_value_delete(
                    f"{_ABORT_KV_PREFIX}/g{gen - 1}")
            except Exception:
                pass


def read_abort_marker(*, dir_path: Optional[str] = None, client=None,
                      generation: Optional[int] = None) -> Optional[dict]:
    """This generation's abort marker payload, or None."""
    gen = elastic_generation() if generation is None else int(generation)
    d = _marker_dir(dir_path)
    if d:
        try:
            with open(os.path.join(d, f"abort.g{gen}.json")) as f:
                payload = json.load(f)
            if _job_matches(payload):
                return payload
        except (OSError, ValueError):
            pass
    client = client if client is not None else _kv_client()
    if client is not None:
        try:
            payload = json.loads(_kv_try(client,
                                         f"{_ABORT_KV_PREFIX}/g{gen}",
                                         probe_ms=10))
            if _job_matches(payload):
                return payload
        except Exception:
            pass
    return None


_MARKER_GEN_RE = None


def clear_run_markers(dir_path: str, generation: Optional[int] = None,
                      own_ranks=()):
    """Launcher start-of-run hygiene over a shared heartbeat dir. Drops
    marker FILES that are provably stale from THIS controller's view:

    - every marker of a generation OLDER than ``generation`` (elastic
      manager paths export a fresh PADDLE_ELASTIC_RUN per relaunch);
    - current-generation markers for ``own_ranks`` — this node's
      workers haven't spawned yet, so any marker for them predates
      this job (a re-run with a pinned --master reusing a log_dir);
    - current-generation ABORT markers — one present at launcher start
      cannot have been written by this not-yet-started incarnation
      (worst case it was a cross-node peer's live abort: the peer's
      own controller still fails that job; only the fast path is lost).

    Other nodes' current-generation rank tombstones are PRESERVED — a
    later-starting controller of a multi-node job must not delete a
    peer node's live markers (so a multi-node run with a pinned master
    reusing a log_dir should clean ``heartbeats/`` between jobs).
    Markers with no parseable generation are legacy debris and are
    dropped. KV markers need no sweep — every launch rendezvouses a
    fresh store."""
    import re
    global _MARKER_GEN_RE
    if _MARKER_GEN_RE is None:
        _MARKER_GEN_RE = re.compile(
            r"(?:^abort\.g(\d+)\.json$|\.g(\d+)" +
            re.escape(_DEAD_SUFFIX) + r"$)")
    gen = elastic_generation() if generation is None else int(generation)
    own = {int(r) for r in own_ranks}
    try:
        names = os.listdir(dir_path)
    except OSError:
        return
    for name in names:
        if not (name.endswith(_DEAD_SUFFIX) or name.startswith("abort.g")):
            continue
        m = _MARKER_GEN_RE.search(name)
        marker_gen = int(m.group(1) or m.group(2)) if m else None
        if marker_gen is not None and marker_gen >= gen:
            if name.startswith("abort.g"):
                pass                 # pre-start abort: provably stale
            else:
                rm = re.match(r"^rank(\d+)\.", name)
                if rm is None or int(rm.group(1)) not in own:
                    continue         # a peer node may own it — keep
        try:
            os.remove(os.path.join(dir_path, name))
        except OSError:
            pass

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
