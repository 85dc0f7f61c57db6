"""Port parity: the mfu / comms / roofline planes
(``paddle_tpu_torch/monitor/{mfu,comms,roofline}.py``) against
``paddle_tpu/monitor/``'s (after ``tests/test_comms_roofline.py``).

- ``classify``, ``ridge_point``, ``model_error_threshold`` and ``mfu``
  give the reference's answers for the same FLOPs, bytes and peaks;
  ``roofline_snapshot`` over the same program records (FLOPs, bytes,
  hits, sampled execution times) in both registries gives the
  reference's verdicts, shares, calibration and gauges, the peaks set by
  the reference's environment overrides on both sides (exact: the same
  float arithmetic).
- The peak tables: an H100's name resolves FLOPs, HBM and NVLink from one
  row; the environment overrides win.
- ``lowered_flops`` counts one call with ``FlopCounterMode``;
  ``record_program_flops`` feeds the reference's metric names.
- comms: the placement transitions' kinds, the seams' counts (a
  redistribute and an object gather on a mesh of one rank),
  ``observe_latency``'s metric name, ``comm_summary``'s keys.
- The serving programs carry bytes from their shapes
  (``serving_program_bytes``), so after a serve ``/roofline`` answers
  200 with a verdict for every program.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu import monitor as JM
from paddle_tpu.monitor import mfu as jmfu
from paddle_tpu.monitor import programs as jprog
from paddle_tpu.monitor import roofline as jroof
from paddle_tpu_torch import monitor as TM
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.inference import engine as TENG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.monitor import comms as tcomms
from paddle_tpu_torch.monitor import mfu as tmfu
from paddle_tpu_torch.monitor import programs as tprog
from paddle_tpu_torch.monitor import roofline as troof

from _torch_monitor_common import reset_both, set_monitor

PEAKS = {"peak_flops_per_sec": 1e12, "peak_hbm_bytes_per_sec": 1e11,
         "peak_ici_bytes_per_sec": 1e10}


@pytest.fixture
def mon():
    reset_both()
    set_monitor(True)
    yield
    set_monitor(False)
    TM.server.stop_server()
    reset_both()


@pytest.mark.parametrize("flops,nbytes,comm", [
    (1e9, 1e7, 0), (1e7, 1e7, 0), (1e7, 1e7, 1e8), (0.0, 1e7, 0),
    (None, 1e7, 0), (1e7, None, 0), (0, 0, 0), (3e8, 2e7, 5e5)])
def test_classify_matches_the_reference(flops, nbytes, comm):
    assert troof.classify(flops, nbytes, comm, PEAKS) == \
        jroof.classify(flops, nbytes, comm, PEAKS)


def test_ridge_threshold_and_mfu_match_the_reference(monkeypatch):
    for pf, ph in ((1e12, 1e11), (0, 1e11), (989e12, 3.35e12)):
        assert troof.ridge_point(pf, ph) == jroof.ridge_point(pf, ph)
    for env in ("4", "2.5", "0.5", "x"):
        monkeypatch.setenv("PADDLE_TPU_ROOFLINE_ERROR_MAX", env)
        assert troof.model_error_threshold() == \
            jroof.model_error_threshold()
    for args in ((1e12, 2.0), (0, 2.0), (1e12, 0)):
        assert tmfu.mfu(*args, peak=1e13) == jmfu.mfu(*args, peak=1e13)


def _same_programs(mod):
    """Four programs: hit counts, one never sampled, one far off its
    model, one without bytes."""
    rows = [("decode", 4e9, 2e8, 5, [30.0, 50.0]),
            ("prefill", 8e11, 1e9, 1, [900.0]),
            ("verify", 2e9, 3e7, 0, []),
            ("nobytes", 1e9, None, 2, [0.5])]
    for i, (name, fl, by, hits, ms) in enumerate(rows):
        mod.record_program(("p", i), name, source="serving",
                           signature="f32[4]", flops=fl, bytes_accessed=by)
        for _ in range(hits):
            mod.note_hit(("p", i))
        for m in ms:
            mod.note_exec(("p", i), m)


def test_snapshot_matches_the_reference(mon, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("PADDLE_TPU_PEAK_HBM_GBS", "100")
    monkeypatch.setenv("PADDLE_TPU_PEAK_ICI_GBS", "10")
    _same_programs(tprog)
    _same_programs(jprog)
    t = troof.roofline_snapshot()
    j = jroof.roofline_snapshot(analyze=False)
    assert set(t) == set(j)
    keep = ("name", "invocations", "verdict", "t_modeled_s", "share",
            "model_error_ratio", "model_divergent", "arithmetic_intensity",
            "exec_samples", "collective_ops")
    assert [{k: p[k] for k in keep} for p in t["programs"]] == \
        [{k: p[k] for k in keep} for p in j["programs"]]
    assert t["calibration"] == j["calibration"]
    assert t["attribution"] == j["attribution"]
    for k in ("peak_flops_per_sec", "peak_hbm_bytes_per_sec",
              "peak_ici_bytes_per_sec", "hbm_source", "ici_source",
              "flops_source", "ridge_point_flops_per_byte"):
        assert t["peaks"][k] == j["peaks"][k], k
    assert set(t["comm"]) == set(j["comm"])
    tg, jg = TM.snapshot()["gauges"], JM.snapshot()["gauges"]
    for g in ("roofline.programs.classified",
              "roofline.model.max_error_ratio"):
        assert tg[g] == jg[g]
    assert t["calibration"]["divergent"]


def test_peak_tables_resolve_one_card_row(monkeypatch):
    for k in ("PADDLE_TPU_PEAK_FLOPS", "PADDLE_TPU_PEAK_HBM_GBS",
              "PADDLE_TPU_PEAK_ICI_GBS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tmfu, "_device_kind",
                        lambda device=None: ("NVIDIA H100 80GB HBM3", "gpu"))
    p = troof.resolve_peaks()
    assert (p["flops_source"], p["hbm_source"], p["ici_source"]) == \
        ("table",) * 3
    assert p["flops_generation"] == p["hbm_generation"] == "h100"
    assert p["peak_flops_per_sec"] == 989e12
    assert p["peak_hbm_bytes_per_sec"] == 3350e9
    assert p["peak_ici_bytes_per_sec"] == 450e9
    assert p["device_kind"] == "NVIDIA H100 80GB HBM3"
    monkeypatch.setenv("PADDLE_TPU_PEAK_HBM_GBS", "100")
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "2e12")
    assert troof.peak_hbm_bytes_per_sec() == 1e11
    assert tmfu.peak_flops() == 2e12
    monkeypatch.setattr(tmfu, "_device_kind",
                        lambda device=None: ("cpu", "cpu"))
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS")
    assert tmfu.resolve_peak("PADDLE_TPU_PEAK_FLOPS", tmfu.PEAK_FLOPS_TABLE,
                             1e12)["source"] == "nominal"


def test_lowered_flops_counts_one_call(mon):
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    assert tmfu.lowered_flops(torch.matmul, a, b) == 2 * 8 * 16 * 4
    assert tmfu.lowered_cost(torch.matmul, a, b)["bytes_accessed"] is None
    assert tmfu.lowered_flops(lambda: 1 / 0) is None
    tmfu.record_program_flops(1000)
    tmfu.record_program_flops(None)
    jmfu.record_program_flops(1000)
    t, j = TM.snapshot(), JM.snapshot()
    assert t["counters"]["jit.program.flops"] == \
        j["counters"]["jit.program.flops"] == 1000
    assert t["gauges"]["jit.program.last_flops"] == 1000
    # no call reports bytes: each of the three counts as unavailable
    assert t["counters"]["monitor.cost_analysis.unavailable"] == 3


def test_placement_kinds():
    from torch.distributed.tensor import Partial, Replicate, Shard
    cases = [((Shard(0),), (Replicate(),), ["all_gather"]),
             ((Partial(),), (Replicate(),), ["all_reduce"]),
             ((Partial(),), (Shard(1),), ["reduce_scatter"]),
             ((Shard(0),), (Shard(1),), ["all_to_all"]),
             ((Replicate(),), (Shard(0),), []),
             ((Shard(0), Partial()), (Replicate(), Replicate()),
              ["all_gather", "all_reduce"])]
    for src, dst, want in cases:
        assert tcomms.placement_kinds(src, dst) == want


def test_seams_count_collectives(mon):
    from torch.distributed.tensor import Shard

    from paddle_tpu_torch.distributed import spmd

    from _torch_mesh_common import one_rank_mesh
    with one_rank_mesh(("dp",)) as mesh:
        x = spmd.shard(torch.ones(4, 3), mesh, spmd.P("dp"))
        assert x.placements == (Shard(0),)
        spmd.replicate(x, mesh)
        spmd.full(x)
        tcomms.gather_object([None], {"k": 1})
    c = tcomms.counts()
    assert c["all_gather"]["count"] == 3
    assert c["all_gather"]["bytes"] >= 2 * 4 * 3 * 4
    snap = TM.snapshot()
    assert snap["histograms"]["comm.latency.all_gather_ms"]["count"] == 1
    assert snap["counters"]["comm.collectives.total"] == 3
    assert set(tcomms.comm_summary()) == {
        "kinds", "programs_analyzed", "programs_with_collectives"}
    set_monitor(False)
    tcomms.reset()
    with one_rank_mesh(("dp",)) as mesh:
        spmd.full(spmd.shard(torch.ones(4), mesh, spmd.P("dp")))
    assert tcomms.counts() == {}


def test_program_bytes_follow_the_shapes():
    c = TL.llama_tiny(num_hidden_layers=2)
    kw = dict(tokens=4, key_len=16, head_rows=4, seqs=4, weight_bytes=1000,
              kv_bytes_per_pos=8, act_bytes=4)
    one = TENG.serving_program_bytes(c, **kw)
    L, D, V = 2, c.hidden_size, c.vocab_size
    assert one == 1000 + L * (4 * 16 + 4) * 8 + (2 * L + 1) * 4 * D * 4 \
        + 4 * 4 * V
    assert TENG.serving_program_bytes(c, steps=3, **kw) == 3 * one


def test_roofline_route_classifies_every_serving_program(mon):
    cfg = TL.llama_tiny(num_hidden_layers=2)
    params = TL.init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(TL, params, cfg, device="cpu", num_slots=2,
                        max_len=32, page_size=4, decode_chunk=2)
    rng = np.random.default_rng(0)
    eng.run([Request(rid=i, prompt=rng.integers(0, 256, 5),
                     max_new_tokens=4) for i in range(3)])
    srv = TM.server.start_server(port=0)
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/roofline", timeout=30) as r:
        assert r.status == 200
        payload = json.loads(r.read())
    progs = payload["programs"]
    assert {p["name"].split("[")[0] for p in progs} >= {
        "serving.prefill", "serving.decode_chunk"}
    for p in progs:
        assert p["bytes_accessed"] and p["bytes_accessed"] > 0
        assert p["verdict"] in ("compute-bound", "hbm-bound"), p
    assert payload["attribution"]["verdict_counts"].get(
        "unclassified", 0) == 0
    assert TF.flag_value("enable_monitor")
