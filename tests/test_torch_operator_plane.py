"""Port parity: the operator plane's HTTP server
(``paddle_tpu_torch/monitor/server.py`` against
``paddle_tpu/monitor/server.py``) and the memory plane
(``monitor/memory.py``).

- Lifecycle: ``start_server`` on port 0 binds an ephemeral port on
  127.0.0.1, a second start returns the running server, ``stop_server``
  is idempotent; ``maybe_start`` starts nothing with
  ``FLAGS_enable_monitor_server`` off and the server on
  ``FLAGS_monitor_server_port`` with it on.
- Routes: both packages serve the same requests (``llama_tiny`` float32,
  weights carried across, one fake clock, monitor on), then each
  package's server is scraped route by route: every ported route answers
  the reference's status with the reference's JSON keys (``/metrics``
  the same metric families, those of the reference's XLA program
  analysis excepted; ``/timeseries``, ``/numerics`` and every block of
  ``/flight`` whole). Bad ``/profile`` arguments answer 400 on both.
- ``/roofline``, the route that answered 501 until its plane was ported
  (A10), answers 200 with the reference's payload keys and a verdict
  for every program; ``/sharding`` and ``/metrics?scope=fleet`` (A9)
  are compared with the reference's.
- ``memory.hbm_stats`` / ``update_hbm_gauges`` / ``headroom`` on one
  injected ``stats_fn`` and one page-pool state equal the reference's,
  gauges included; on this host (no card) the port's device reading is
  the reference's CPU answer: nothing reported.
"""
import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_monitor_common import (FakeClock, JM, TM, equal_flops,
                                   patch_clock, reset_both, set_monitor,
                                   tiny_pair)
from paddle_tpu.core import flags as JF
from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import failover as jfo
from paddle_tpu.loadgen import scorecard as jscorecard
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.device import memory as tdevmem
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.inference import failover as tfo
from paddle_tpu_torch.loadgen import scorecard as tscorecard
from paddle_tpu_torch.models import llama as TL

ROUTES = ("/metrics", "/healthz", "/flight", "/programs", "/memory",
          "/timeseries", "/numerics", "/slo", "/fleet/serving", "/scorecard",
          "/forensics", "/requests/1", "/requests/999", "/",
          "/profile?seconds=abc", "/profile?seconds=0",
          "/profile?seconds=1000", "/no/such/route")
# routes that answered 501 until their plane was ported, with its
# ROADMAP item; scraped on both sides
UNPORTED = {"/roofline": "A10"}
# the A9 routes, scraped on both sides after the same serve: the
# parameter tree's layout and the single-process fleet aggregate
MESH_ROUTES = ("/sharding", "/metrics?scope=fleet")
# the reference's XLA analysis of its programs (memory bytes, and the
# collectives its comms plane reads from the compiled program) registers
# these on a /metrics scrape; eager PyTorch compiles no program to analyze
XLA_ONLY_FAMILIES = ("jit_program_", "comm_program_")


@pytest.fixture(autouse=True)
def _servers_down():
    TM.server.stop_server()
    JM.server.stop_server()
    saved = {k: TF.flag_value(k) for k in
             ("enable_monitor_server", "monitor_server_port")}
    yield
    TM.server.stop_server()
    JM.server.stop_server()
    TF.set_flags(saved)
    JF.set_flags({"enable_monitor_server": False})


def get(srv, path):
    try:
        with urllib.request.urlopen(srv.url + path, timeout=60) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def test_server_lifecycle_on_port_zero():
    S = TM.server
    assert S.get_server() is None and S.bound_port() is None
    assert not S.plane_active()
    srv = S.start_server(port=0)
    try:
        assert srv.host == "127.0.0.1" and srv.port > 0
        assert S.bound_port() == srv.port and S.plane_active()
        assert S.start_server(port=0) is srv     # one server a process
        st, body, ctype = get(srv, "/")
        assert st == 200 and ctype == "application/json"
        assert json.loads(body)["service"] == "paddle_tpu_torch.monitor"
    finally:
        S.stop_server()
    assert S.get_server() is None and not S.plane_active()
    S.stop_server()                               # idempotent
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(srv.url + "/", timeout=2)


def test_maybe_start_under_the_flag():
    S = TM.server
    TF.set_flags({"FLAGS_enable_monitor_server": False})
    assert S.maybe_start() is None and S.get_server() is None
    TF.set_flags({"FLAGS_enable_monitor_server": True,
                  "FLAGS_monitor_server_port": 0})
    srv = S.maybe_start()
    assert srv is not None and srv.port > 0 and S.maybe_start() is srv
    # a fixed port that another process holds: maybe_start gives up
    # without raising, as the reference does
    S.stop_server()
    import socket
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        TF.set_flags({"FLAGS_monitor_server_port": busy.getsockname()[1]})
        assert S.maybe_start() is None


def _keys(v):
    if isinstance(v, dict):
        return sorted(v)
    if isinstance(v, list):
        return [_keys(x) for x in v[:1]]
    return type(v).__name__


def _families(text):
    return sorted(line.split()[2] for line in text.decode().splitlines()
                  if line.startswith("# TYPE ")
                  and not line.split()[2].startswith(XLA_ONLY_FAMILIES))


def _scrape(M, routes):
    srv = M.server.start_server(port=0)
    out = {}
    try:
        for route in routes:
            st, body, ctype = get(srv, route)
            if route == "/metrics":
                out[route] = (st, ctype, _families(body))
                continue
            if route == "/metrics?scope=fleet":
                out[route] = (st, ctype, _families(body), body.decode())
                continue
            payload = json.loads(body)
            if route == "/healthz":
                # the providers this serve registered (the map is
                # process-wide); their names carry each package's engine
                # counter
                payload["providers"] = {
                    re.sub(r"^serving:\d+$", "serving:<uid>", k): v
                    for k, v in payload["providers"].items()
                    if k == "slo_burn" or k.startswith("serving:")}
            shape = {k: _keys(v) for k, v in payload.items()} \
                if isinstance(payload, dict) else _keys(payload)
            out[route] = (st, ctype, shape, payload)
    finally:
        M.server.stop_server()
    return out


@pytest.fixture(scope="module")
def scraped():
    jcfg, jp, tcfg, tp = tiny_pair(2)
    mp = pytest.MonkeyPatch()
    clock = patch_clock(mp, FakeClock())
    equal_flops(mp)
    reset_both()
    set_monitor(True)
    # the last scorecard is process-global: no replay scored on either
    # side before this serve
    jscorecard.reset()
    tscorecard.reset()
    for fo in (jfo, tfo):
        fo.set_active_coordinator(None)
    kw = dict(num_slots=2, max_len=32, page_size=4, decode_chunk=3)
    out = {}
    try:
        for side, M in (("torch", TM), ("jax", JM)):
            JM.reset()
            TM.reset()
            clock.now = 1000.0
            if side == "torch":
                eng, req = ServingEngine(TL, tp, tcfg, device="cpu",
                                         **kw), Request
            else:
                eng, req = JEngine(JL, jp, jcfg, **kw), JRequest
            rng = np.random.default_rng(0)
            for i in range(3):
                eng.submit(req(rid=i, prompt=rng.integers(0, 256, (6,))
                               .astype(np.int32), max_new_tokens=4))
            while eng.step():
                clock.advance(0.01)
            out[side] = _scrape(M, ROUTES + MESH_ROUTES + (
                tuple(UNPORTED)))
            del eng
    finally:
        set_monitor(False)
        reset_both()
        mp.undo()
    return out


@pytest.mark.parametrize("route", ROUTES)
def test_route_status_and_keys_match_the_reference(scraped, route):
    t, j = scraped["torch"][route], scraped["jax"][route]
    assert t[0] == j[0], (route, t[0], j[0])
    assert t[1] == j[1]
    if route == "/metrics":
        assert t[2] == j[2]
        assert "serving_tokens_generated" in t[2]
    elif route == "/":
        assert t[3]["routes"] == j[3]["routes"]
    elif route in ("/timeseries", "/numerics"):
        assert t[0] == 200 and t[2] == j[2]
        assert t[3] == j[3]        # a serve records no steps: empty planes
    elif route == "/flight":
        assert t[2] == j[2]
        assert t[3]["timeseries"] == j[3]["timeseries"]
        assert t[3]["numerics"] == j[3]["numerics"]
    else:
        assert t[2] == j[2], (route, t[2], j[2])


def test_route_payloads_pins(scraped):
    t = scraped["torch"]
    assert t["/healthz"][0] == 200 and t["/healthz"][3]["status"] == "ok"
    assert any(k.startswith("serving:")
               for k in t["/healthz"][3]["providers"])
    assert t["/scorecard"][0] == 404 and t["/requests/999"][0] == 404
    assert t["/requests/1"][3]["rid"] == 1
    progs = t["/programs"][3]["programs"]
    assert progs and all(p["memory"] is None for p in progs)
    mem = t["/memory"][3]
    assert mem["hbm"]["totals"] == {} and mem["headroom"][
        "program_temp_bytes_max"] == 0
    assert mem["headroom"]["pages_total"] > 0
    fl = t["/flight"][3]
    assert fl["kind"] == "paddle_tpu.flight_record" and fl["forensics"]
    for route in ("/profile?seconds=abc", "/profile?seconds=0",
                  "/profile?seconds=1000"):
        assert t[route][0] == 400 and "error" in t[route][3]


@pytest.mark.parametrize("route", sorted(UNPORTED))
def test_unported_routes_name_their_roadmap_item(scraped, route):
    """A route once unported leaves the server's 501 map when its plane
    is ported (``/roofline``, A10): it answers 200 with the reference's
    payload keys, and every serving program, whose bytes the port counts
    from its shapes, has a verdict."""
    from paddle_tpu_torch.monitor import server as tserver
    assert route not in tserver.UNPORTED_ROUTES
    st, ctype, shape, payload = scraped["torch"][route]
    jst, jctype, jshape, _ = scraped["jax"][route]
    assert st == jst == 200 and ctype == jctype == "application/json"
    assert set(shape) == set(jshape)
    assert payload["programs"]
    assert all(p["verdict"] is not None for p in payload["programs"])


def test_sharding_route_lists_the_engine_params(scraped):
    """``/sharding`` answers 200 with the engine's parameter tree, the
    reference's layout facts leaf by leaf (unsharded in one process)."""
    t, j = scraped["torch"]["/sharding"], scraped["jax"]["/sharding"]
    assert t[0] == j[0] == 200 and t[1] == j[1] == "application/json"
    assert sorted(t[3]) == sorted(j[3]) == ["programs", "trees", "world"]
    assert sorted(t[3]["world"]) == sorted(j[3]["world"])
    (tname, tree), = t[3]["trees"].items()
    (jname, jtree), = j[3]["trees"].items()
    assert re.fullmatch(r"serving:\d+\.params", tname)
    assert re.fullmatch(r"serving:\d+\.params", jname)
    assert tree["leaves"] == jtree["leaves"]
    for key in ("num_arrays", "total_global_bytes",
                "total_shard_bytes_per_device", "replicated_bytes"):
        assert tree[key] == jtree[key], key
    assert tree["imbalance"]["devices"] == 1


def test_fleet_scope_answers_with_the_single_process_aggregate(scraped):
    """``/metrics?scope=fleet`` answers 200 with the aggregate of this
    process's snapshot (world size 1), the reference's families."""
    t = scraped["torch"]["/metrics?scope=fleet"]
    j = scraped["jax"]["/metrics?scope=fleet"]
    assert t[0] == j[0] == 200 and t[1] == j[1]
    assert "paddle_fleet_world_size 1" in t[3]
    assert 'serving_tokens_generated{agg="sum"}' in t[3]
    assert t[2] == j[2]


SNAPS = [
    {"gauges": {"g.ema": 1.0, "g.only0": 5, "z": 1.0},
     "counters": {"c.tok": 100},
     "histograms": {"h.lat": {"count": 2, "sum": 3.0, "min": 1.0,
                              "max": 2.0}},
     "slo_tenants": {"acme": {"tokens": 7, "cost": 1.5}}},
    {"gauges": {"g.ema": 1.1, "z": -1.0}, "counters": {"c.tok": 100},
     "histograms": {"h.lat": {"count": 1, "sum": 9.0, "min": 9.0,
                              "max": 9.0}},
     "slo_tenants": {"acme": {"tokens": 3}, "b\"x": {"cost": 2}}},
    {"gauges": {"g.ema": 9.0}, "counters": {"c.tok": 100},
     "histograms": {"h.lat": {"count": 0}}},
]


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_fleet_aggregate_divergence_and_text_match_the_reference(hosts):
    """``aggregate_hosts``, ``divergence`` and ``expose_fleet_text`` on
    the same synthetic snapshots (the reference's
    ``TestFleetAggregation`` shapes, with histograms and tenants)."""
    from paddle_tpu.monitor import fleet as jfleet
    from paddle_tpu_torch.monitor import fleet as tfleet
    snaps = SNAPS[:hosts]
    agg = tfleet.aggregate_hosts(snaps)
    assert agg == jfleet.aggregate_hosts(snaps)
    assert tfleet.divergence(agg) == jfleet.divergence(agg)
    payload = {"world_size": hosts, "aggregate": agg}
    assert tfleet.expose_fleet_text(payload) == \
        jfleet.expose_fleet_text(payload)


def test_single_process_aggregated_snapshot_matches_the_reference():
    reset_both()
    set_monitor(True)
    try:
        got = {}
        for side, M in (("torch", TM), ("jax", JM)):
            M.set_gauge("fa.gauge", 12.5, doc="g")
            M.inc("fa.count", 4, doc="c")
            M.observe("fa.lat", 3.0, doc="h")
            got[side] = M.fleet.aggregated_snapshot(name="t1")
            assert M.fleet.last_aggregate() is got[side]
        t, j = got["torch"], got["jax"]
        assert t["world_size"] == j["world_size"] == 1
        assert t["divergence"] == j["divergence"] == []
        for key in ("fa.gauge", "fa.count"):
            assert t["aggregate"]["scalars"][key] == \
                j["aggregate"]["scalars"][key]
        assert t["aggregate"]["histograms"]["fa.lat"] == \
            j["aggregate"]["histograms"]["fa.lat"]
        assert sorted(t) == sorted(j)
    finally:
        set_monitor(False)
        reset_both()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from _torch_mesh_common import launched, load_json
    tmp = launched(tmp_path_factory, "fleet", 2, ["fleet"], lambda d: None)
    return [load_json(tmp / f"out_fleet_r{r}.json") for r in range(2)]


def test_aggregated_snapshot_agrees_on_every_rank(two_ranks):
    """The collective over 2 gloo ranks: one payload on both, each
    host's gauge in its place."""
    a, b = (r["payload"] for r in two_ranks)
    assert a == b and a["world_size"] == 2
    s = a["aggregate"]["scalars"]["test.rank"]
    assert s["hosts"] == [0.0, 1.0] and s["sum"] == 1.0
    assert a["aggregate"]["scalars"]["test.steps"]["sum"] == 10
    assert a["divergence"][0]["metric"] == "test.rank"
    assert all(r["last_is_payload"] for r in two_ranks)


def test_store_client_carries_a_beat_and_a_frame(two_ranks):
    """With a process group, ``heartbeat._kv_client()`` is the default
    store's adapter: rank 0 publishes a named beat and a telemetry frame
    without a ``client``, rank 1 reads both."""
    r0, r1 = two_ranks
    assert r0["client"] == r1["client"] == "StoreClient"
    assert r0["published"]
    assert r1["beat"]["beat"] == 7
    assert r1["ingested"] == 1 and r1["frame_names"] == ["replica1"]


# ---------------------------------------------------------------------------
# the memory plane
# ---------------------------------------------------------------------------

READINGS = {
    "two_cards": [{"bytes_in_use": 100, "bytes_limit": 1000,
                   "peak_bytes_in_use": 300},
                  {"bytes_in_use": 50, "bytes_limit": 1000}],
    "one_reports": [{}, {"bytes_in_use": 7, "bytes_limit": 9,
                         "largest_free_block_bytes": 2}],
    "nothing": [{}],
    "garbage": [{"bytes_in_use": "x", "bytes_limit": 10}],
    "over_limit": [{"bytes_in_use": 20, "bytes_limit": 10}],
}


@pytest.mark.parametrize("reading", sorted(READINGS))
@pytest.mark.parametrize("pages", [None, (64, 16)])
def test_memory_plane_matches_the_reference(reading, pages):
    reset_both()
    set_monitor(True)
    try:
        out = {}
        for side, M in (("torch", TM), ("jax", JM)):
            if pages is not None:
                M.set_gauge("serving.pages.total", pages[0])
                M.set_gauge("serving.pages.in_use", pages[1])
            fn = lambda: [dict(d) for d in READINGS[reading]]  # noqa: E731
            out[side] = (M.memory.hbm_stats(fn), M.memory.headroom(fn),
                         M.snapshot())
        assert out["torch"] == out["jax"]
    finally:
        set_monitor(False)
        reset_both()


class _FakeCard:
    """``torch.cuda``'s readings of one card, set by the test: the
    driver's free and total bytes and the caching allocator's
    allocated, reserved and peak bytes."""

    def __init__(self, free, total, allocated, reserved, peak):
        self.free, self.total = free, total
        self.allocated, self.reserved, self.peak = allocated, reserved, peak

    def install(self, monkeypatch):
        import torch
        cuda = torch.cuda
        monkeypatch.setattr(cuda, "is_available", lambda: True)
        monkeypatch.setattr(cuda, "device_count", lambda: 1)
        monkeypatch.setattr(cuda, "current_device", lambda: 0)
        monkeypatch.setattr(cuda, "mem_get_info",
                            lambda i=None: (self.free, self.total))
        monkeypatch.setattr(cuda, "memory_allocated",
                            lambda i=None: self.allocated)
        monkeypatch.setattr(cuda, "memory_reserved",
                            lambda i=None: self.reserved)
        monkeypatch.setattr(cuda, "max_memory_allocated",
                            lambda i=None: self.peak)


GIB = 1 << 30


@pytest.mark.parametrize("outside_gib", [0, 1, 7])
def test_admittable_bytes_exclude_memory_outside_the_allocator(
        monkeypatch, outside_gib):
    """ROADMAP C5: on a card of 80 GiB whose allocator holds 30 GiB
    (20 GiB of it in live tensors) and whose CUDA context and other
    processes hold ``ctx`` more, ``bytes_limit`` stays the card's total
    but the admittable bytes are the driver's free plus the allocator's
    reserved-but-unallocated: the context is not admittable, and an
    allocation made outside the allocator lowers them by its size. The
    reference's ``hbm_free_bytes`` (limit minus in-use) is unchanged."""
    ctx = GIB // 2 + outside_gib * GIB
    card = _FakeCard(free=80 * GIB - 30 * GIB - ctx, total=80 * GIB,
                     allocated=20 * GIB, reserved=30 * GIB,
                     peak=25 * GIB)
    card.install(monkeypatch)
    reading = tdevmem.memory_stats()
    assert reading == {"bytes_in_use": 20 * GIB,
                       "peak_bytes_in_use": 25 * GIB,
                       "bytes_limit": 80 * GIB,
                       "bytes_free": 80 * GIB - 20 * GIB - ctx}
    assert tdevmem.all_memory_stats() == [reading]
    reset_both()
    set_monitor(True)
    try:
        hr = TM.memory.headroom()
        assert hr["hbm_free_bytes"] == 60 * GIB
        assert hr["est_admittable_bytes"] == 60 * GIB - ctx
        assert TM.snapshot()["gauges"]["device.hbm.bytes_free"] == \
            60 * GIB - ctx
        # the autoscaler's memory utilization counts the context as used
        from paddle_tpu_torch.monitor import slo as TS
        payload = TS.demand_model(queue_depth=0, live_slots=0,
                                  num_slots=4, pages_free_fraction=1.0,
                                  headroom=hr)
        assert payload["memory_utilization"] == round(
            1 - (60 * GIB - ctx) / (80 * GIB), 4)
    finally:
        set_monitor(False)
        reset_both()


def test_admittable_bytes_follow_the_cache_and_the_temp_reservation(
        monkeypatch):
    """Freed tensors stay admittable (the allocator's cache), a reading
    without ``bytes_free`` keeps the reference's answer, and the temp
    reservation comes off the capped free bytes."""
    card = _FakeCard(free=10 * GIB, total=80 * GIB, allocated=5 * GIB,
                     reserved=65 * GIB, peak=65 * GIB)
    card.install(monkeypatch)
    assert TM.memory.headroom()["est_admittable_bytes"] == 70 * GIB
    card.allocated = 65 * GIB
    assert TM.memory.headroom()["est_admittable_bytes"] == 10 * GIB
    monkeypatch.setattr(TM.programs, "max_temp_bytes", lambda: GIB)
    assert TM.memory.headroom()["est_admittable_bytes"] == 9 * GIB
    no_free = [{"bytes_in_use": 5 * GIB, "bytes_limit": 80 * GIB}]
    assert TM.memory.headroom(lambda: no_free)["est_admittable_bytes"] \
        == 74 * GIB


def test_device_reading_on_a_host_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tdevmem.all_memory_stats() == [{}]
    assert tdevmem.memory_stats() == {}
    st = TM.memory.hbm_stats()
    assert st["totals"] == {} and st["devices_reporting"] == 0
    # and the gauges stay unwritten: nothing reported, nothing fabricated
    reset_both()
    set_monitor(True)
    try:
        TM.memory.update_hbm_gauges()
        assert not any(k.startswith("device.hbm") for k in
                       TM.snapshot().get("gauges", {}))
    finally:
        set_monitor(False)
        reset_both()
