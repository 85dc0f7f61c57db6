"""Port parity: the single-engine trace replay (``loadgen/replay.py``
``replay_trace``) and the SLO scorecard (``loadgen/scorecard.py``),
against the reference's, mirroring ``tests/test_loadgen.py``'s
``TestReplay`` / ``TestScorecardUnits`` / ``TestScorecardRoute`` (the
fleet replay is not ported).

- The reference's ``serving_trace_replay`` rung (``bench.py``) at its
  CPU configuration (``llama_tiny`` 2 layers, 4 slots, page 4, chunk 8,
  rate 48) and at its on-TPU geometry on ``llama_tiny`` (8 slots, page
  16, chunk 4, rate 40): the trace of seed 1616, the burst episode at
  0.55 s, the rid-shifted warm pass, then the measured replay, through
  both packages with the monitor on and one fake clock that each engine
  step advances 10 ms. The scorecard's ``deterministic`` block is equal,
  and so is its ``timing`` block. The on-TPU geometry's block is the
  one ``chip_smoke.py``'s ``[trace_replay]`` repeats on the card.
- Same-seed replays on fresh engines give identical terminal states and
  deterministic blocks; every submission ends in exactly one terminal
  state; sheds carry typed reasons and retry hints; token conservation;
  the drain episode; the scorecard's units and its last-card slot; the
  ``loadgen.replay.*`` counters.
"""
import dataclasses
import json

import numpy as np
import pytest

from _torch_monitor_common import (FakeClock, JM, TM, equal_flops,
                                   patch_clock, reset_both, set_monitor,
                                   tiny_pair)
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.inference.engine import EngineStats as JStats
from paddle_tpu.loadgen import Episode as JEpisode
from paddle_tpu.loadgen import build_scorecard as jbuild
from paddle_tpu.loadgen import replay_trace as jreplay
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.inference.engine import EngineStats
from paddle_tpu_torch.loadgen import (Episode, TenantSpec, build_scorecard,
                                      generate_trace, replay_trace)
from paddle_tpu_torch.loadgen import scorecard as sc
from paddle_tpu_torch.models import llama as TL

RUNGS = {
    # bench.py's serving_trace_replay rung: CPU configuration, and its
    # on-TPU geometry at llama_tiny
    "cpu": dict(slots=4, page=4, chunk=8, rate=48.0),
    "tpu_geometry": dict(slots=8, page=16, chunk=4, rate=40.0),
}


def rung_trace(rate):
    return generate_trace(
        1616, duration_s=1.0, rate=rate,
        tenants=[TenantSpec("interactive", share=1.0, priority=2),
                 TenantSpec("batch", share=2.0, priority=0)],
        prompt_len=(4, 16), max_new_tokens=(4, 24), alpha=1.3,
        burst=(0.5, 0.2, 2.0))


def _ticking(eng, clock):
    step = eng.step

    def ticked():
        clock.advance(0.01)
        return step()
    eng.step = ticked
    return eng


def _rung(eng, trace, episode_cls, build, stats_cls, slots):
    warm = dataclasses.replace(trace, requests=[
        dataclasses.replace(r, rid=r.rid + 500_000)
        for r in trace.requests])
    replay = jreplay if episode_cls is JEpisode else replay_trace
    replay(eng, warm, dt_per_step=0.01)
    eng.stats = stats_cls()
    result = replay(eng, trace, dt_per_step=0.01, episodes=[
        episode_cls("burst", at_s=0.55, n_requests=6 * slots)])
    return result, build(result)


@pytest.fixture(scope="module", params=sorted(RUNGS))
def rung(request):
    g = RUNGS[request.param]
    jcfg, jp, tcfg, tp = tiny_pair(2)
    kw = dict(num_slots=g["slots"], max_len=16 + 24, page_size=g["page"],
              decode_chunk=g["chunk"], priority_admission=True,
              max_queue=2 * g["slots"])
    trace = rung_trace(g["rate"])
    mp = pytest.MonkeyPatch()
    clock = patch_clock(mp, FakeClock())
    equal_flops(mp)
    reset_both()
    set_monitor(True)
    out = {}
    try:
        for side in ("torch", "jax"):
            JM.reset()
            TM.reset()
            clock.now = 1000.0
            if side == "torch":
                eng = ServingEngine(TL, tp, tcfg, device="cpu", **kw)
                out[side] = _rung(_ticking(eng, clock), trace, Episode,
                                  build_scorecard, EngineStats, g["slots"])
            else:
                eng = JEngine(JL, jp, jcfg, **kw)
                out[side] = _rung(_ticking(eng, clock), trace, JEpisode,
                                  jbuild, JStats, g["slots"])
            out[side] += (TM.snapshot() if side == "torch"
                          else JM.snapshot(),)
    finally:
        set_monitor(False)
        reset_both()
        mp.undo()
    return request.param, out


def test_deterministic_block_matches_the_reference(rung):
    name, out = rung
    j, t = out["jax"][1], out["torch"][1]
    assert json.dumps(t["deterministic"], sort_keys=True) == \
        json.dumps(j["deterministic"], sort_keys=True)
    det = t["deterministic"]
    assert det["terminal"].get("shed", 0) > 0 and \
        det["terminal"]["completed"] > 0


def test_timing_block_matches_under_a_fake_clock(rung):
    name, out = rung
    j, t = out["jax"][1]["timing"], out["torch"][1]["timing"]
    # the fleet block reads federated frames: none published on either
    # side, so both are unavailable
    assert t == j
    assert t["fleet"] == {"available": False}
    assert t["latency_ms"]["ttft_ms"]["count"] == \
        out["torch"][1]["deterministic"]["terminal"]["completed"]


def test_verdict_and_terminals_match(rung):
    name, out = rung
    (jres, jcard, jsnap), (tres, tcard, tsnap) = out["jax"], out["torch"]
    assert tcard["verdict"] == jcard["verdict"] == {"pass": True,
                                                    "reasons": []}
    assert tres.terminal == jres.terminal
    assert (tres.steps, tres.offered, tres.offered_tokens) == \
        (jres.steps, jres.offered, jres.offered_tokens)


def test_replay_counters_match(rung):
    name, out = rung
    jsnap, tsnap = out["jax"][2], out["torch"][2]
    assert {k: v for k, v in tsnap["counters"].items()
            if not k.startswith("jit.program.flops")} == \
        {k: v for k, v in jsnap["counters"].items()
         if not k.startswith("jit.program.flops")}
    res = out["torch"][0]
    c = tsnap["counters"]
    # the warm pass and the measured replay both count
    assert c["loadgen.replay.offered"] >= res.offered
    assert c["loadgen.scorecard.builds"] == 1


def test_chip_smoke_rung_gives_the_reference_block(rung):
    """``chip_smoke.trace_replay_rung``, which ``[trace_replay]`` runs on
    the card, gives the reference's deterministic block at the same
    geometry on the CPU."""
    import importlib.util
    import pathlib

    import torch
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_replay", path)
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    name, out = rung
    _, _, _, tp = tiny_pair(2)
    with C.monitor_on():
        _, card, _ = C.trace_replay_rung(torch, TL,
                                         TL.llama_tiny(num_hidden_layers=2),
                                         tp, "cpu", **RUNGS[name])
    assert json.dumps(card["deterministic"], sort_keys=True) == \
        json.dumps(out["jax"][1]["deterministic"], sort_keys=True)
    if name == "tpu_geometry":
        assert RUNGS[name] == C.TRACE_REPLAY


# -- the reference's single-engine replay cases on the port -----------------

def _mk_engine(**kw):
    cfg = TL.llama_tiny(num_hidden_layers=1)
    params = TL.init_params(cfg, seed=3, device="cpu")
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 24)
    kw.setdefault("page_size", 4)
    kw.setdefault("decode_chunk", 2)
    return ServingEngine(TL, params, cfg, device="cpu", **kw)


def _small_trace(seed=77):
    return generate_trace(seed, duration_s=0.5, rate=24.0,
                          tenants=[TenantSpec("interactive", priority=2),
                                   TenantSpec("batch", share=2.0)],
                          prompt_len=(3, 8), max_new_tokens=(2, 8))


def _one_replay():
    eng = _mk_engine(priority_admission=True, max_queue=3)
    return replay_trace(eng, _small_trace(), dt_per_step=0.02,
                        episodes=[Episode("burst", at_s=0.25,
                                          n_requests=10)])


@pytest.fixture(scope="module")
def replay_pair():
    return _one_replay(), _one_replay()


class TestReplay:
    def test_same_seed_identical_terminal_and_tokens(self, replay_pair):
        a, b = replay_pair
        assert a.trace.to_json() == b.trace.to_json()
        assert a.terminal_counts() == b.terminal_counts()
        assert a.useful_tokens() == b.useful_tokens()
        assert (a.offered, a.offered_tokens) == (b.offered,
                                                 b.offered_tokens)
        for rid in a.terminal:
            ra = {k: v for k, v in a.terminal[rid].items()
                  if k != "retry_after_s"}
            rb = {k: v for k, v in b.terminal[rid].items()
                  if k != "retry_after_s"}
            assert ra == rb, rid

    def test_scorecard_deterministic_block_identical(self, replay_pair):
        a, b = replay_pair
        assert json.dumps(build_scorecard(a)["deterministic"],
                          sort_keys=True) == json.dumps(
            build_scorecard(b)["deterministic"], sort_keys=True)

    def test_exactly_one_terminal_state_per_submission(self, replay_pair):
        res = replay_pair[0]
        assert res.offered == len(res.trace.requests) + 10
        assert len(res.terminal) == res.offered
        assert {r["state"] for r in res.terminal.values()} <= {
            "completed", "shed", "expired", "rejected"}

    def test_sheds_are_typed_with_retry_hints(self, replay_pair):
        sheds = [r for r in replay_pair[0].terminal.values()
                 if r["state"] == "shed"]
        assert sheds
        for rec in sheds:
            assert rec.get("retry_after_s") is not None and rec.get(
                "reason"), rec

    def test_scorecard_structure_and_verdict(self, replay_pair):
        card = json.loads(json.dumps(build_scorecard(replay_pair[0])))
        assert card["verdict"]["pass"], card["verdict"]
        det = card["deterministic"]
        assert det["trace"]["sha256"] == replay_pair[0].trace.sha256()
        assert det["engine_flags"]["priority_admission"] is True
        assert det["engine_flags"]["max_queue"] == 3
        assert sum(det["terminal"].values()) == \
            det["goodput"]["offered_requests"]
        assert det["shed_by_reason"]
        assert 0 < det["goodput"]["request_goodput"] < 1.0
        assert set(det["per_tenant"]) >= {"interactive", "batch", "burst"}
        assert 0 < det["fairness"]["jain_completion_index"] <= 1.0
        assert det["episodes"][0]["kind"] == "burst"
        assert "slo" not in det["episodes"][0]
        assert "wall_s" in card["timing"]

    def test_token_conservation(self, replay_pair):
        res = replay_pair[0]
        st = res.engine_stats["engine0"]
        assert st["tokens_generated"] - st["tokens_discarded"] == sum(
            r["tokens"] for r in res.terminal.values())

    def test_kill_episode_rejected_single_engine(self):
        with pytest.raises(ValueError, match="replay_fleet"):
            replay_trace(_mk_engine(), _small_trace(),
                         episodes=[Episode("kill", at_s=0.1)])

    def test_unknown_episode_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown episode"):
            Episode("explode", at_s=0.1)

    def test_drain_episode_sheds_queue_with_hints(self):
        res = replay_trace(_mk_engine(max_queue=8), _small_trace(5),
                           dt_per_step=0.02,
                           episodes=[Episode("drain", at_s=0.2)])
        card = build_scorecard(res)
        assert card["verdict"]["pass"], card["verdict"]
        assert card["deterministic"]["shed_by_reason"].get("draining")
        for rec in res.terminal.values():
            if rec["state"] == "shed":
                assert rec.get("retry_after_s") is not None, rec


class TestScorecardUnits:
    @pytest.mark.parametrize("reason,want", [
        ("engine is draining", "draining"),
        ("displaced by rid 7", "displaced"),
        ("SLO fast-burn alerting; priority<=0 work shed", "slo_burn"),
        ("queue full (8) and no lower-priority request to displace",
         "queue_full"), ("???", "other"), (None, "other")])
    def test_shed_reason_typing(self, reason, want):
        from paddle_tpu.loadgen import scorecard as jsc
        assert sc._shed_reason_type(reason) == \
            jsc._shed_reason_type(reason) == want

    def test_jain_index(self):
        assert sc._jain([1.0, 1.0, 1.0]) == 1.0
        assert sc._jain([]) is None
        assert abs(sc._jain([1.0, 0.0]) - 0.5) < 1e-9
        assert sc._jain([0.0, 0.0]) == 1.0

    def test_last_scorecard_lifecycle(self, replay_pair):
        sc.reset()
        assert sc.last_scorecard() is None
        card = build_scorecard(replay_pair[0])
        assert sc.last_scorecard() is card
        sc.reset()
        assert sc.last_scorecard() is None


class TestScorecardRoute:
    """The reference serves the last scorecard at ``/scorecard`` (its
    HTTP server waits for ROADMAP A7(d)); the data the route serves and
    the counters a replay feeds."""

    def test_replay_metrics_counted(self):
        reset_both()
        set_monitor(True)
        try:
            res = _one_replay()
            snap = TM.snapshot()["counters"]
            assert snap.get("loadgen.replay.offered") == res.offered
            assert snap.get("loadgen.replay.completed") == \
                res.terminal_counts().get("completed")
            assert snap.get("loadgen.replay.shed") == \
                res.terminal_counts().get("shed")
            assert snap.get("loadgen.replay.tokens.useful") == \
                res.useful_tokens()
            card = build_scorecard(res)
            assert TM.snapshot()["counters"].get(
                "loadgen.scorecard.builds") == 1
            assert sc.last_scorecard() is card
            assert card["timing"]["latency_ms"]["e2e_ms"]["count"] == \
                res.terminal_counts()["completed"]
            assert card["timing"]["slo"]["objectives"]
        finally:
            set_monitor(False)
            reset_both()

    def test_monitor_off_counts_nothing(self):
        reset_both()
        set_monitor(False)
        res = _one_replay()
        card = build_scorecard(res)
        assert TM.snapshot() == {}
        assert card["timing"]["latency_ms"] == {}
        assert np.all([r["state"] is not None
                       for r in res.terminal.values()])
