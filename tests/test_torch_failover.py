"""Port parity: exactly-once request failover
(``paddle_tpu_torch/inference/failover.py``, a port of
``paddle_tpu/inference/failover.py``) and the named-beat transport it
publishes on (``paddle_tpu_torch/distributed/heartbeat.py``).

The reference's mechanism tests, each run on the port and on the JAX
modules with the same inputs, their observable results compared: the
journal's payload (equal but for the pinned sampling seed, journaled as
``seed`` where the reference journals its PRNG ``key``), the
fingerprint, the bounded completion window, the refusal of a future
format, a failed publish that degrades without raising, the
coordinator's strand / dedup / backoff / quarantine / re-strand /
attempt bounds, and the circuit breaker's cycle. Then the engine seams:
journaling at submit and a completion marker at each terminal event
(completed, shed, expired), a resubmitted sampled request replaying its
tokens, and a journal written by the JAX engine, whose stranded greedy
requests the port's coordinator rebuilds and serves on a port engine
with the tokens of the JAX engine's uninterrupted serve.
"""
import gc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.distributed import heartbeat as jhb
from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.inference import failover as jfo
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.distributed import heartbeat as thb
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.inference import failover as tfo
from paddle_tpu_torch.models import llama as TL

TENG = importlib.import_module("paddle_tpu_torch.inference.engine")
SIDES = {"port": (tfo, thb), "jax": (jfo, jhb)}


class _Req:
    """Duck-typed request: the attributes either journal reads."""

    def __init__(self, rid, prompt=(1, 2, 3), max_new_tokens=4,
                 temperature=0.0, tenant="t0", priority=0,
                 deadline_s=None, prompt_spec=None):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.tenant = tenant
        self.priority = priority
        self.deadline_s = deadline_s
        self.prompt_spec = prompt_spec
        self.seed = None
        self.key = None


def _on_both(tmp_path, scenario):
    """``scenario(fo, hb, dir)`` on the port and on the JAX modules, each
    in its own directory; returns both results."""
    out = {}
    for side, (fo, hb) in SIDES.items():
        d = tmp_path / side
        d.mkdir()
        out[side] = scenario(fo, hb, str(d))
    return out["port"], out["jax"]


def _strip_wall(recs):
    return [{k: v for k, v in r.items() if k != "_t_strand_wall"}
            for r in recs]


# ---------------------------------------------------------------------------
# admission journal
# ---------------------------------------------------------------------------

def test_journal_round_trip_and_completion_marker(tmp_path):
    def scenario(fo, hb, d):
        j = fo.AdmissionJournal("r0", dir_path=d)
        j.admit(_Req(7, prompt=(4, 5), max_new_tokens=6, deadline_s=1.5,
                     priority=2, prompt_spec={"seed": 3, "rid": 7,
                                              "prompt_len": 2,
                                              "vocab": 32}))
        j.admit(_Req(8))
        first = fo.read_journal("r0", dir_path=d)
        j.finish(7, "completed", tokens=6)
        second = fo.read_journal("r0", dir_path=d)
        fo.sweep_journal("r0", dir_path=d)
        return first, second, fo.read_journal("r0", dir_path=d)

    (p1, p2, p3), (j1, j2, j3) = _on_both(tmp_path, scenario)
    assert (p1, p2, p3) == (j1, j2, j3)
    rec = p1["inflight"]["7"]
    assert p1["kind"] == tfo.JOURNAL_KIND == jfo.JOURNAL_KIND
    assert rec["prompt_spec"]["seed"] == 3 and "prompt" not in rec
    assert rec["idem"] == f"7:{rec['fingerprint']}"
    assert p1["inflight"]["8"]["prompt"] == [1, 2, 3]
    assert set(p2["inflight"]) == {"8"}
    assert p2["completed"]["7"] == {"state": "completed", "tokens": 6,
                                    "idem": rec["idem"]}
    assert p3 is None


def test_payload_equals_the_reference_but_for_the_seed(tmp_path):
    """A sampled request: the port journals its pinned ``seed``, the
    reference its PRNG ``key``; every other field is the same."""
    tj = tfo.AdmissionJournal("r0", dir_path=str(tmp_path / "p"))
    jj = jfo.AdmissionJournal("r0", dir_path=str(tmp_path / "j"))
    a, b = _Req(3, temperature=0.7), _Req(3, temperature=0.7)
    a.seed = 41
    b.key = np.asarray(jax.random.PRNGKey(41), np.uint32)
    tj.admit(a)
    jj.admit(b)
    tp, jp = tj.inflight["3"], jj.inflight["3"]
    assert tp.pop("seed") == 41 and "key" in jp and "key" not in tp
    jp.pop("key")
    assert tp == jp


def test_fingerprint_is_content_keyed():
    for fo in (tfo, jfo):
        a = fo.request_fingerprint(np.asarray([1, 2], np.int32), 4, 0.0)
        assert a == fo.request_fingerprint(np.asarray([1, 2]), 4, 0.0)
        c = fo.request_fingerprint(np.asarray([1, 3], np.int32), 4, 0.0)
        d = fo.request_fingerprint(np.asarray([1, 2], np.int32), 5, 0.0)
        assert len({a, c, d}) == 3
    # the port hashes an int64 prompt as the reference hashes int32
    assert tfo.request_fingerprint(np.arange(9, dtype=np.int64), 3, 0.5) \
        == jfo.request_fingerprint(np.arange(9, dtype=np.int32), 3, 0.5)


def test_completed_window_bounded(tmp_path):
    def scenario(fo, hb, d):
        j = fo.AdmissionJournal("r0", dir_path=d, max_completed=3)
        for rid in range(6):
            j.admit(_Req(rid))
            j.finish(rid, "completed", tokens=1)
        return list(j.completed)

    port, ref = _on_both(tmp_path, scenario)
    assert port == ref == ["3", "4", "5"]


def test_future_version_refused(tmp_path):
    """A payload of a future version is refused, whichever package wrote
    it."""
    for hb in (thb, jhb):
        hb.publish_named(tfo.journal_name("rz"),
                         {"kind": tfo.JOURNAL_KIND, "v": 99,
                          "inflight": {}, "completed": {}},
                         dir_path=str(tmp_path))
        assert tfo.read_journal("rz", dir_path=str(tmp_path)) is None
        assert jfo.read_journal("rz", dir_path=str(tmp_path)) is None


def test_publish_failure_degrades_not_raises(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("transport down")

    for fo, hb in SIDES.values():
        j = fo.AdmissionJournal("r0", dir_path=str(tmp_path))
        with monkeypatch.context() as m:
            m.setattr(hb, "publish_named", boom)
            j.admit(_Req(1))
            j.finish(1, "completed")
        assert j.publish_failures == 2


def test_publish_of_a_non_json_payload_reports_failure(tmp_path):
    """A payload ``json.dumps`` refuses (a numpy scalar) is a failed
    publish on both packages, never an exception."""
    for hb in (thb, jhb):
        assert hb.publish_named("n0", {"x": np.int64(3)},
                                dir_path=str(tmp_path)) is False
        assert hb.publish_named("n0", {"x": 3},
                                dir_path=str(tmp_path)) is True


def test_kv_leg_takes_an_explicit_client(tmp_path):
    """Without a file directory the payload rides the duck-typed client
    alone; the freshest ``seq`` wins across both legs."""

    class Store:
        def __init__(self):
            self.kv = {}

        def key_value_set(self, k, v, allow_overwrite=True):
            self.kv[k] = v

        def key_value_try_get(self, k):
            return self.kv[k]

        def key_value_delete(self, k):
            self.kv.pop(k, None)

    store = Store()
    assert thb._kv_client() is None
    assert thb.publish_named("rep", {"seq": 2, "a": 1}, client=store)
    assert thb.read_named("rep", client=store,
                          env_fallback=False) == {"seq": 2, "a": 1}
    thb.publish_named("rep", {"seq": 1, "a": 0}, dir_path=str(tmp_path))
    assert thb.read_named("rep", dir_path=str(tmp_path),
                          client=store)["a"] == 1
    thb.remove_named(str(tmp_path), "rep", client=store)
    assert thb.read_named("rep", dir_path=str(tmp_path),
                          client=store) is None


def test_named_beats_and_staleness(tmp_path):
    d = str(tmp_path)
    thb.touch_named(d, "alive")
    assert thb.stale_names(d, ["alive"], timeout=60.0) == {}
    stale = thb.stale_names(d, ["never"], timeout=0.5, started_at=0.0)
    assert "never" in stale
    stop = thb.start_named(d, "daemon", interval=0.05)
    try:
        for _ in range(100):
            if thb.read_named("daemon", dir_path=d) is not None:
                break
            stop.wait(0.02)
        assert thb.read_named("daemon", dir_path=d) is not None
    finally:
        stop.set()


# ---------------------------------------------------------------------------
# coordinator: strand / dedup / backoff / quarantine
# ---------------------------------------------------------------------------

def test_strand_with_lineage_and_backoff(tmp_path):
    def scenario(fo, hb, d):
        fo.AdmissionJournal("victim", dir_path=d).admit(_Req(3))
        c = fo.FailoverCoordinator(heartbeat_dir=d)
        n = c.note_replaced("victim", now=10.0)
        pending = _strip_wall(c.pending)
        early = c.due(10.0)
        ready = _strip_wall(c.due(10.3))
        return (n, pending, early, ready, c.outstanding(),
                c.note_replaced("victim", now=11.0), c.snapshot())

    port, ref = _on_both(tmp_path, scenario)
    assert port == ref
    n, pending, early, ready, left, again, snap = port
    assert n == 1 and early == [] and left == 0 and again == 0
    (rec,) = pending
    assert rec["recovered_from"] == ["victim"] and rec["attempts"] == 1
    assert rec["not_before"] == pytest.approx(10.25)
    assert [r["rid"] for r in ready] == [3]
    assert snap["counters"]["stranded"] == 1


def test_dedup_on_completion_marker(tmp_path):
    def scenario(fo, hb, d):
        j = fo.AdmissionJournal("victim", dir_path=d)
        j.admit(_Req(5))
        j.admit(_Req(6))
        payload = fo.read_journal("victim", dir_path=d)
        payload["completed"]["5"] = {"state": "completed", "tokens": 4}
        hb.publish_named(fo.journal_name("victim"), payload, dir_path=d)
        c = fo.FailoverCoordinator(heartbeat_dir=d)
        return (c.note_replaced("victim", now=0.0), dict(c.counters),
                [r["rid"] for r in c.pending])

    port, ref = _on_both(tmp_path, scenario)
    assert port == ref
    assert port[0] == 1 and port[1]["deduped"] == 1 and port[2] == [6]


def test_quarantine_ladder_and_hash_set(tmp_path):
    def scenario(fo, hb, d):
        c = fo.FailoverCoordinator(heartbeat_dir=d, quarantine_attempts=2)
        fo.AdmissionJournal("r0", dir_path=d).admit(_Req(9, (7, 7, 7)))
        c.note_replaced("r0", now=0.0)
        (rec,) = c.due(1.0)
        c.redispatched(rec, "r1", 1.0)
        j1 = fo.AdmissionJournal("r1", dir_path=d)
        j1.inflight["9"] = {k: v for k, v in rec.items()
                            if k != "_t_strand_wall"}
        j1._publish()
        n = c.note_replaced("r1", now=2.0)
        first = (n, c.terminal[9]["state"],
                 c.terminal[9]["recovered_from"])
        fo.AdmissionJournal("r2", dir_path=d).admit(_Req(55, (7, 7, 7)))
        c.note_replaced("r2", now=3.0)
        return first, c.terminal[55]["state"], dict(c.counters)

    port, ref = _on_both(tmp_path, scenario)
    assert port == ref
    assert port[0] == (1, "quarantined", ["r0", "r1"])
    assert port[1] == "quarantined" and port[2]["quarantined"] == 2


def test_restrand_after_survivor_death(tmp_path):
    def scenario(fo, hb, d):
        c = fo.FailoverCoordinator(heartbeat_dir=d, quarantine_attempts=5)
        fo.AdmissionJournal("r0", dir_path=d).admit(_Req(1))
        c.note_replaced("r0", now=0.0)
        (rec,) = c.due(1.0)
        c.redispatched(rec, "r1", 1.0)
        j1 = fo.AdmissionJournal("r1", dir_path=d)
        j1.inflight["1"] = {k: v for k, v in rec.items()
                            if k != "_t_strand_wall"}
        j1._publish()
        return c.note_replaced("r1", now=2.0), _strip_wall(c.pending)

    port, ref = _on_both(tmp_path, scenario)
    assert port == ref
    n, (again,) = port
    assert n == 1 and again["attempts"] == 2
    assert again["recovered_from"] == ["r0", "r1"]


def test_requeue_attempt_bound_and_hint_clamp(tmp_path):
    def scenario(fo, hb, d):
        c = fo.FailoverCoordinator(heartbeat_dir=d, max_attempts=3,
                                   backoff_cap_s=5.0)
        rec = {"rid": 4, "attempts": 1, "tenant": "t0"}
        c.requeue(dict(rec), 0.0, retry_after_s=60.0)
        clamped = c.pending[0]["not_before"]
        c.pending.clear()
        c.requeue(dict(rec, attempts=2), 0.0)
        return clamped, list(c.pending), c.terminal[4]["state"], \
            dict(c.counters)

    port, ref = _on_both(tmp_path, scenario)
    assert port == ref
    assert port[0] == pytest.approx(5.0) and port[1] == []
    assert port[2] == "shed" and port[3]["shed"] == 1


def test_resolve_expired_note_result_and_snapshot(tmp_path):
    def scenario(fo, hb, d):
        c = fo.FailoverCoordinator(heartbeat_dir=d)
        c.resolve({"rid": 2, "attempts": 1, "tenant": "t0"}, "expired")
        c.redispatched({"rid": 3, "attempts": 1}, "r0", 0.0)
        c.note_result(3, "completed")
        c.note_result(3, "completed")          # idempotent
        c.admission_result("r0", False, 0.0)
        return c.snapshot()

    port, ref = _on_both(tmp_path, scenario)
    assert port == ref
    assert port["terminal_by_state"] == {"expired": 1}
    assert port["counters"]["recovered"] == 1
    assert port["breakers"]["r0"]["state"] == "closed"


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------

def _breaker_cycle(fo):
    b = fo.CircuitBreaker(threshold=3, cooldown_s=2.0)
    seen = []
    for ok, t in ((False, 0.0), (False, 0.0), (True, 0.0), (False, 1.0),
                  (False, 1.0), (False, 1.0)):
        b.record(ok, t)
        seen.append(b.state)
    seen += [b.allows(2.0), b.allows(3.0), b.state]
    b.note_probe()
    seen.append(b.allows(3.0))
    b.record(True, 3.1)
    seen.append(b.as_dict())
    p = fo.CircuitBreaker(threshold=1, cooldown_s=1.0)
    p.record(False, 0.0)
    seen += [p.state, p.allows(1.5)]
    p.note_probe()
    p.record(False, 1.5)
    seen += [p.as_dict(), p.allows(2.0), p.allows(2.5)]
    return seen


def test_breaker_cycle_matches_the_reference():
    seen = _breaker_cycle(tfo)
    assert seen == _breaker_cycle(jfo)
    assert seen[5] == "open" and seen[6:9] == [False, True, "half_open"]
    assert seen[9] is False and seen[10]["state"] == "closed"
    assert seen[13]["opened"] == 2


def test_pick_replica_routes_around_open_breakers(tmp_path):
    def scenario(fo, hb, d):
        c = fo.FailoverCoordinator(heartbeat_dir=d, breaker_threshold=2,
                                   breaker_cooldown_s=100.0)
        for _ in range(2):
            c.admission_result("r1", False, 0.0)
        picks = [c.pick_replica(["r0", "r1", "r2"], rid, now=1.0)
                 for rid in range(6)]
        for n in ("r0", "r2"):
            c.admission_result(n, False, 0.0)
            c.admission_result(n, False, 0.0)
        fallback = c.pick_replica(["r0", "r1", "r2"], 0, now=1.0)
        c.note_replaced("r1", now=1.0)
        return picks, fallback, sorted(c.breakers)

    port, ref = _on_both(tmp_path, scenario)
    assert port == ref
    assert set(port[0]) == {"r0", "r2"} and port[1] in ("r0", "r1", "r2")
    assert "r1" not in port[2]


def test_active_coordinator_is_weakref(tmp_path):
    c = tfo.FailoverCoordinator(heartbeat_dir=str(tmp_path))
    tfo.set_active_coordinator(c)
    assert tfo.active_coordinator() is c
    del c
    gc.collect()
    assert tfo.active_coordinator() is None
    tfo.set_active_coordinator(None)


def test_rebuild_request_from_spec_inline_or_damaged():
    from paddle_tpu_torch.loadgen.traces import _trace_prompt
    spec = {"seed": 5, "rid": 2, "prompt_len": 12, "vocab": 64,
            "tenant": "a", "prefix_len": 4}
    r = tfo.rebuild_request({"rid": 2, "max_new_tokens": 3,
                             "temperature": 0.5, "seed": 9, "tenant": "a",
                             "priority": 1, "attempts": 2,
                             "recovered_from": ["A"], "prompt_spec": spec},
                            64, 1.5)
    np.testing.assert_array_equal(r.prompt,
                                  _trace_prompt(5, 2, 12, 64, "a", 4))
    assert (r.seed, r.priority, r.deadline_s, r._failover_attempts,
            r._recovered_from) == (9, 1, 1.5, 2, ["A"])
    r = tfo.rebuild_request({"rid": 3, "max_new_tokens": 2,
                             "prompt": [1, 2]}, 64, None)
    assert r.prompt.tolist() == [1, 2] and r.seed is None
    assert tfo.rebuild_request({"rid": 4, "max_new_tokens": 2}, 64,
                               None) is None
    assert tfo.rebuild_request({"rid": 5, "prompt": [1]}, 64, None) is None


# ---------------------------------------------------------------------------
# engine seams
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg = JL.llama_tiny(num_hidden_layers=1, dtype=jnp.float32)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(3))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TL.llama_tiny(num_hidden_layers=1), tp


_KW = dict(num_slots=2, max_len=24, page_size=4, decode_chunk=2)


def _engines(tiny, **kw):
    jcfg, jp, tcfg, tp = tiny
    return (ServingEngine(TL, tp, tcfg, device="cpu", **dict(_KW, **kw)),
            JEngine(JL, jp, jcfg, **dict(_KW, **kw)))


def _greedy(n_req, vocab=256):
    rng = np.random.default_rng(17)
    return [(i, rng.integers(0, vocab, 3 + i % 4).astype(np.int32),
             3 + i % 3) for i in range(n_req)]


def test_submit_journals_and_terminal_events_write_markers(tiny, tmp_path,
                                                           monkeypatch):
    """Completed, shed (drain) and expired (deadline) each write their
    marker, on the port as on the JAX engine, under one fake clock: the
    two journals end equal."""
    clock = [50.0]

    class Clock:
        @staticmethod
        def perf_counter():
            return clock[0]

    monkeypatch.setattr(TENG, "time", Clock)
    monkeypatch.setattr(
        importlib.import_module("paddle_tpu.inference.engine"), "time",
        Clock)
    payloads = {}
    for side, req_cls, eng in zip(("port", "jax"), (Request, JRequest),
                                  _engines(tiny, failover=True)):
        d = str(tmp_path / side)
        clock[0] = 50.0
        assert eng.attach_journal("rA", d) is not None
        for rid, prompt, new in _greedy(5):
            eng.submit(req_cls(rid=rid, prompt=prompt,
                               max_new_tokens=new + 6 * (rid == 1),
                               deadline_s=0.5 if rid == 1 else None))
        assert set(eng._journal.inflight) == {str(r) for r in range(5)}
        eng.step()
        clock[0] += 1.0
        eng.step()
        eng.begin_drain()
        eng.run()
        payloads[side] = (tfo if side == "port" else jfo).read_journal(
            "rA", dir_path=d)
    port, ref = payloads["port"], payloads["jax"]
    assert port == ref
    assert port["inflight"] == {}
    states = {rid: m["state"] for rid, m in port["completed"].items()}
    assert states["1"] == "expired" and port["completed"]["1"]["tokens"] > 0
    assert sorted(states.values()).count("shed") >= 1
    assert "completed" in states.values()


def test_flags_off_attach_is_noop(tiny, tmp_path):
    eng, _ = _engines(tiny)
    assert eng._failover is False
    assert eng.attach_journal("rB", str(tmp_path)) is None
    assert eng._journal is None


def test_resubmitted_sampled_request_replays_its_tokens(tiny, tmp_path):
    """Submission pins the sampling seed before the record is written; an
    object submitted again on another engine starts a new run and draws
    the same tokens; a request rebuilt from the journal does too."""
    a, _ = _engines(tiny, failover=True)
    a.attach_journal("rA", str(tmp_path))
    req = Request(rid=1, prompt=np.arange(1, 6, dtype=np.int32),
                  max_new_tokens=5, temperature=0.8, deadline_s=30.0)
    a.submit(req)
    assert req.seed is not None
    rec = dict(a._journal.inflight["1"])
    assert rec["seed"] == req.seed
    first = a.run()[1].tokens.tolist()
    req._preempt_count = 2
    b, _ = _engines(tiny, failover=True)
    b.submit(req)
    assert req._preempt_count == 0
    assert b.run()[1].tokens.tolist() == first
    rebuilt = tfo.rebuild_request(rec, 256, None)
    c, _ = _engines(tiny)
    assert c.run([rebuilt])[1].tokens.tolist() == first


def test_port_coordinator_recovers_a_jax_journal(tiny, tmp_path):
    """The JAX engine (replica A) journals eight greedy requests and is
    abandoned after some complete; the port's coordinator reads A's
    journal, strands the rest, rebuilds them and serves them on a port
    engine (replica B). Union of A's and B's outputs: each rid exactly
    once, with the tokens of the JAX engine's uninterrupted serve."""
    jcfg, jp, tcfg, tp = tiny
    reqs = _greedy(8)
    whole = JEngine(JL, jp, jcfg, **_KW).run(
        [JRequest(rid=r, prompt=p, max_new_tokens=n) for r, p, n in reqs])
    a = JEngine(JL, jp, jcfg, failover=True, **_KW)
    a.attach_journal("A", str(tmp_path))
    for r, p, n in reqs:
        a.submit(JRequest(rid=r, prompt=p, max_new_tokens=n))
    while len(a.outputs) < 3:
        a.step()
    done_a = {r: o.tokens.tolist() for r, o in a.outputs.items()}
    assert 0 < len(done_a) < len(reqs)
    del a
    coord = tfo.FailoverCoordinator(heartbeat_dir=str(tmp_path))
    stranded = coord.note_replaced("A", now=0.0)
    assert stranded == len(reqs) - len(done_a)
    b = ServingEngine(TL, tp, tcfg, device="cpu", failover=True, **_KW)
    b.attach_journal("B", str(tmp_path))
    for rec in coord.due(100.0):
        req = tfo.rebuild_request(rec, tcfg.vocab_size, None)
        b.submit(req)
        coord.redispatched(rec, "B", 100.0)
    out_b = b.run()
    b.cache.alloc.check_invariants()
    for rid, o in out_b.items():
        coord.note_result(rid, o.finish_reason)
    assert not set(done_a) & set(out_b)
    assert sorted(set(done_a) | set(out_b)) == [r for r, _, _ in reqs]
    for rid, o in out_b.items():
        assert o.tokens.tolist() == whole[rid].tokens.tolist(), rid
    for rid, toks in done_a.items():
        assert toks == whole[rid].tokens.tolist()
    c = coord.counters
    assert c["stranded"] == c["redispatched"] == c["recovered"] == stranded
    assert b._journal.completed.keys() == {str(r) for r in out_b}
    recorded = tfo.read_journal("B", dir_path=str(tmp_path))
    assert all(recorded["completed"][str(r)]["state"] == "completed"
               for r in out_b)
