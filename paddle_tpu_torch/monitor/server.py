"""Operator-plane HTTP server: live telemetry endpoints (port of
``paddle_tpu/monitor/server.py``).

A flag-gated stdlib ``http.server`` daemon that an operator's
Prometheus scraper or liveness probe hits:

- ``GET /metrics``: Prometheus text exposition 0.0.4 of the live
  registry, refreshing the ``device.hbm.*`` gauges, the autoscale
  gauges and the ``slo.*`` gauges per scrape;
- ``GET /healthz``: JSON liveness over the registered health providers
  (serving queue depth, SLO burn); a provider reporting ``ok: false``
  turns it **503**;
- ``GET /flight``: the flight record on demand (``monitor/trace.py``);
- ``GET /programs``: the serving program registry
  (``monitor/programs.py``), served without memory analysis: eager
  PyTorch compiles no program to analyze;
- ``GET /memory``: per-device allocator stats and the serving headroom
  estimate (``monitor/memory.py``);
- ``GET /timeseries``: the bounded step ring and the step-time drift
  report (``monitor/timeseries.py``);
- ``GET /numerics``: the numerics plane (``monitor/numerics.py``):
  per-layer gradient statistics, the quantization audit, KV-page
  absmax;
- ``GET /slo``: objectives, compliance, burn rates, tenants and the
  autoscale signals (``monitor/slo.py``);
- ``GET /fleet/serving``: fleet SLO federation
  (``monitor/federation.py``): frames, the federated verdict and the
  failover block;
- ``GET /scorecard``: the last trace replay's scorecard
  (``loadgen/scorecard.py``), 404 until one was scored;
- ``GET /forensics`` and ``GET /requests/<rid>``: the forensics plane
  (``monitor/forensics.py``);
- ``GET /profile?seconds=N``: one exclusive ``torch.profiler`` window
  (``monitor/profile_capture.py``); a second concurrent request answers
  **409**.

- ``GET /sharding``: the sharding inspector's registered trees
  (``distributed/introspect.py``);
- ``GET /metrics?scope=fleet``: the cross-process aggregate
  (``monitor/fleet.py``): computed fresh per scrape in a single process,
  else the last ``aggregated_snapshot()`` the ranks gathered (503 until
  one was).

- ``GET /roofline``: per-program compute / HBM / comm-bound verdicts
  and the step-level attribution (``monitor/roofline.py``).

A route whose plane is not ported (``UNPORTED_ROUTES``, empty now)
answers **501** with a JSON body that names its ROADMAP item, never a
made-up payload.

Gating and lifecycle: ``FLAGS_enable_monitor_server`` off (the default)
means :func:`maybe_start` is one cached-flag branch: no thread, no
socket. ``ServingEngine`` calls it; tests and bespoke loops call
:func:`start_server` directly. Port 0 (the default of
``FLAGS_monitor_server_port``) binds an ephemeral port, read back from
``server.port``; the host is **127.0.0.1** unless
``PADDLE_TPU_MONITOR_HOST`` overrides it, since these endpoints expose
operational detail and carry no auth.

Health providers: :func:`register_health_provider` maps a name to a
zero-arg callable returning a dict (``ok`` defaults True). Owners that
die (an engine) register through weakrefs and are pruned on read. A
broken provider reports its error but does not fail liveness: a crashed
*telemetry* hook must not get a healthy worker killed.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from ..core import flags as _flags

__all__ = ["start_server", "stop_server", "maybe_start", "get_server",
           "bound_port", "plane_active", "register_health_provider",
           "unregister_health_provider", "health", "MonitorServer"]

_FLAG_SERVER = _flags.flag_info("enable_monitor_server")
_PORT_FLAG = _flags.flag_info("monitor_server_port")

_MU = threading.Lock()
_SERVER: list = [None]

_PROVIDERS_MU = threading.Lock()
_HEALTH_PROVIDERS: Dict[str, Callable[[], Optional[dict]]] = {}

# The routes whose planes are not ported, each with its ROADMAP item;
# they answer 501 and name it.
UNPORTED_ROUTES: Dict[str, tuple] = {}


def plane_active() -> bool:
    """True when the operator plane could serve a probe: the server
    flag is set or a server is already running. Entrypoints whose
    health providers are pruned only on reads (engine weakrefs) gate
    their registration on this OR on the monitor flag — a fully-off
    process must register nothing, ever."""
    return bool(_FLAG_SERVER.value) or _SERVER[0] is not None


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


class _Handler(BaseHTTPRequestHandler):
    # the default handler logs every request to stderr — a scraper
    # hitting /metrics every 15s must not spam a training log
    def log_message(self, fmt, *args):
        pass

    server_version = "paddle-tpu-monitor"

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload):
        self._send(code, json.dumps(payload, indent=1,
                                    sort_keys=True).encode(),
                   "application/json")

    def do_GET(self):  # noqa: N802  (http.server API)
        from . import inc as _inc
        from . import observe as _observe

        t0 = time.perf_counter()
        url = urlparse(self.path)
        route = url.path.rstrip("/") or "/"
        try:
            if route == "/metrics":
                self._metrics(parse_qs(url.query))
            elif route == "/healthz":
                ok, payload = health()
                self._send_json(200 if ok else 503, payload)
            elif route == "/flight":
                from . import trace as _trace
                self._send_json(200, _trace.flight_payload(
                    reason="operator_scrape"))
            elif route == "/programs":
                from . import programs as _programs
                self._send_json(200, {
                    "programs": _programs.programs_snapshot(),
                    "evicted": _programs.evicted_count(),
                })
            elif route == "/memory":
                from . import memory as _memory
                # one backend read: headroom() carries the hbm payload
                # it already fetched, so the two blocks are consistent
                hr = _memory.headroom()
                self._send_json(200, {"hbm": hr.pop("hbm"),
                                      "headroom": hr})
            elif route == "/sharding":
                from ..distributed import introspect as _introspect
                self._send_json(200, _introspect.sharding_snapshot())
            elif route in UNPORTED_ROUTES:
                self._unported(route)
            elif route == "/roofline":
                from . import roofline as _roofline
                self._send_json(200, _roofline.roofline_snapshot())
            elif route == "/timeseries":
                from . import timeseries as _timeseries
                self._send_json(200, _timeseries.timeseries_snapshot())
            elif route == "/numerics":
                from . import numerics as _numerics
                self._send_json(200, _numerics.numerics_snapshot())
            elif route == "/slo":
                from . import memory as _memory
                from . import slo as _slo
                # one backend read: the headroom payload rides into the
                # autoscale block so the HBM leg of the demand estimate
                # is fresh exactly when someone asks
                self._send_json(200, _slo.slo_snapshot(
                    headroom=_memory.headroom()))
            elif route == "/fleet/serving":
                from . import federation as _federation
                self._send_json(
                    200, _federation.fleet_serving_snapshot())
            elif route == "/scorecard":
                # the most recent trace-replay SLO scorecard
                # (loadgen/scorecard.py). 404 until a replay graded —
                # absence is honest, an empty card would read as a
                # zero-traffic fleet that passed
                from ..loadgen import scorecard as _scorecard
                card = _scorecard.last_scorecard()
                if card is None:
                    self._send_json(404, {
                        "available": False,
                        "error": "no trace replay has been scored in "
                                 "this process"})
                else:
                    self._send_json(200, card)
            elif route == "/forensics":
                from . import forensics as _forensics
                self._send_json(200, _forensics.forensics_payload())
            elif route.startswith("/requests/"):
                # per-request timeline: /requests/<rid> (the only
                # prefix-matched route — the rid is the path tail)
                from . import forensics as _forensics
                rid = route[len("/requests/"):]
                payload = _forensics.request_payload(rid)
                if payload is None:
                    self._send_json(404, {
                        "error": f"no timeline for rid {rid!r} "
                                 "(unknown, evicted, or the forensics "
                                 "plane is off)"})
                else:
                    self._send_json(200, payload)
            elif route == "/profile":
                self._profile(parse_qs(url.query))
            elif route == "/":
                self._send_json(200, {
                    "service": "paddle_tpu_torch.monitor",
                    "routes": ["/metrics", "/metrics?scope=fleet",
                               "/healthz", "/flight", "/programs",
                               "/memory", "/roofline", "/sharding",
                               "/timeseries", "/numerics", "/slo",
                               "/fleet/serving", "/scorecard",
                               "/forensics", "/requests/<rid>",
                               "/profile?seconds=N"],
                })
            else:
                self._send_json(404, {"error": f"no route {route!r}"})
            _inc("monitor.server.requests",
                 doc="operator-plane HTTP requests served")
        except BrokenPipeError:
            pass                     # scraper hung up mid-response
        except Exception as e:
            _inc("monitor.server.errors",
                 doc="operator-plane requests that raised")
            try:
                self._send_json(500, {
                    "error": f"{type(e).__name__}: {e}"[:400]})
            except Exception:
                pass
        _observe("monitor.server.scrape_ms",
                 (time.perf_counter() - t0) * 1e3,
                 doc="wall time serving one operator-plane request")

    def _profile(self, query: dict):
        """On-demand profiler capture: blocks this handler thread for
        the window (the server is threading — other routes keep
        serving), 409 when a capture is already running, 400 on a bad
        ``seconds``."""
        from . import inc as _inc
        from . import profile_capture as _pcap

        raw = (query.get("seconds") or ["1"])[0]
        try:
            seconds = float(raw)
        except ValueError:
            self._send_json(400, {
                "error": f"seconds={raw!r} is not a number"})
            return
        if not 0 < seconds <= _pcap.MAX_SECONDS:
            self._send_json(400, {
                "error": f"seconds must be in (0, {_pcap.MAX_SECONDS}]"
                         f", got {seconds}"})
            return
        try:
            info = _pcap.capture_sync(seconds)
        except _pcap.CaptureBusy as e:
            _inc("monitor.profile.busy_rejected",
                 doc="/profile requests refused because a capture "
                     "window was already open (HTTP 409)")
            self._send_json(409, {"error": str(e)})
            return
        self._send_json(200, info)

    def _unported(self, route: str):
        item, plane = UNPORTED_ROUTES[route]
        self._send_json(501, {
            "error": f"{route} is not ported yet: {plane} is ROADMAP.md "
                     f"queue A item {item}",
            "roadmap": item})

    def _metrics(self, query: dict):
        from . import expose_text as _expose_text
        from . import memory as _memory

        scope = (query.get("scope") or ["process"])[0]
        if scope == "fleet":
            from . import fleet as _fleet
            if _fleet.world_size() == 1:
                # a single process: the gather is local, so compute it
                # fresh per scrape (a cached payload would freeze)
                payload = _fleet.aggregated_snapshot()
            else:
                payload = _fleet.last_aggregate()
            if payload is None:
                self._send_json(503, {
                    "error": "no fleet aggregate published yet — "
                             "aggregated_snapshot() is a collective the "
                             "training/serving loop must call"})
                return
            self._send(200, _fleet.expose_fleet_text(payload).encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
            return
        # scrape-time refresh: HBM gauges re-read the backend (the
        # headroom composition reuses that one read), and the
        # serving.autoscale.* gauges recompute from the engine's latest
        # scheduler tick
        from . import slo as _slo
        hr = _memory.headroom()
        _slo.update_autoscale_gauges(headroom=hr)
        _slo.compliance_report()      # refreshes the slo.* gauges
        body = _expose_text()
        self._send(200, body.encode(),
                   "text/plain; version=0.0.4; charset=utf-8")


class MonitorServer:
    """One ``ThreadingHTTPServer`` + its serve thread (both daemonic:
    an operator plane must never keep a finished job's process
    alive)."""

    def __init__(self, host: str, port: int):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        # 50ms shutdown poll (default 500ms): stop_server should not
        # stall a test teardown or a SIGTERM drain half a second
        self._thread = threading.Thread(
            target=lambda: self._httpd.serve_forever(poll_interval=0.05),
            daemon=True, name="paddle-tpu-monitor-server")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start_server(port: Optional[int] = None,
                 host: Optional[str] = None) -> MonitorServer:
    """Start (or return the already-running) operator-plane server.
    ``port`` defaults to ``FLAGS_monitor_server_port`` (0 =
    ephemeral); ``host`` to ``PADDLE_TPU_MONITOR_HOST`` or
    127.0.0.1."""
    with _MU:
        if _SERVER[0] is not None:
            return _SERVER[0]
        if host is None:
            host = os.environ.get("PADDLE_TPU_MONITOR_HOST",
                                  "127.0.0.1")
        if port is None:
            port = int(_PORT_FLAG.value)
        srv = MonitorServer(host, port)
        _SERVER[0] = srv
        return srv


def stop_server():
    """Shut the server down and release the socket (idempotent)."""
    with _MU:
        srv = _SERVER[0]
        _SERVER[0] = None
    if srv is not None:
        srv.close()


def get_server() -> Optional[MonitorServer]:
    return _SERVER[0]


def bound_port() -> Optional[int]:
    srv = _SERVER[0]
    return srv.port if srv is not None else None


def maybe_start() -> Optional[MonitorServer]:
    """The entrypoint seam (ServingEngine / SentinelLoop / hapi fit):
    starts the server iff ``FLAGS_enable_monitor_server`` is set. Off
    path = this one cached-flag branch — no thread, no socket, no
    registration."""
    if not _FLAG_SERVER.value:
        return None
    try:
        return start_server()
    except OSError:
        # a second process racing for a fixed port must not take down
        # the training/serving loop it rides in
        return None
