"""Port parity: the program registry (``monitor/programs.py``) and the
FLOPs the serving engine registers for each program.

- The shape formula (``inference.engine.serving_program_flops``) against
  ``torch.utils.flop_counter.FlopCounterMode``'s count of the same
  dispatch's plain path on the CPU, within 1%, for every program kind
  (prefill group, shared prefill, decode chunk, verify window) at
  ``llama_tiny`` and ``moe_tiny`` (dense and capacity dispatch). Where the
  formula and the counter disagree, the formula is at fault.
- The program names and hit counts of a serve equal to the reference
  engine's (``serving.prefill[g*,s*]``, ``serving.decode_chunk[c*]``, the
  shared-prefill and verify-window programs).
- The reference's loop-once count, pinned as reference behaviour: XLA's
  cost analysis counts a ``lax.scan`` body once, so JAX's FLOPs of
  ``serving.prefill[g1,s4]`` on the 2-layer ``llama_tiny`` stay below the
  matmul FLOPs of its 2 layers (589,824), while the port's count is at or
  above them. Nobody should "fix" the port toward the reference here.
"""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_monitor_common import (FakeClock, JM, TM, monitor_on,
                                   patch_clock, reset_both, serve_pair,
                                   set_monitor, tiny_pair)
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.inference import engine as TENG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import moe as TMOE

assert monitor_on                       # a fixture the tests take

KINDS = ("serving.prefill", "serving.prefill_shared",
         "serving.decode_chunk", "serving.spec_chunk")
PLANES = ("_prefill_plane", "_decode_plane", "_spec_plane")


def _family(name):
    if name == "llama":
        return TL, TL.llama_tiny(num_hidden_layers=2)
    cfg = TMOE.moe_tiny(dispatch_mode=name.split("_")[1])
    return TMOE, cfg


def _counted_serve(family, cfg):
    """A serve that dispatches every program kind, each plane call under
    ``FlopCounterMode``: ``[(program key, counted FLOPs)]``."""
    params = family.init_params(cfg, seed=1, device="cpu")
    eng = ServingEngine(family, params, cfg, device="cpu", num_slots=2,
                        max_len=64, page_size=4, decode_chunk=2,
                        prefix_cache=True, spec_decode=True)
    seen, last = [], []
    record = eng._record_serving_program

    def rec(spec_key, name, flops_fn, args):
        key = record(spec_key, name, flops_fn, args)
        last.append(key)
        return key

    eng._record_serving_program = rec
    for plane in PLANES:
        fn = getattr(eng, plane)

        def counted(*a, _fn=fn, **kw):
            with FlopCounterMode(display=False) as fc:
                out = _fn(*a, **kw)
            seen.append((last[-1], fc.get_total_flops()))
            return out
        setattr(eng, plane, counted)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 8)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 3)]),
               rng.integers(0, cfg.vocab_size, 5)]
    eng.run([Request(rid=i, prompt=p, max_new_tokens=20)
             for i, p in enumerate(prompts)])
    eng.run([Request(rid=9, prompt=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, 2)]), max_new_tokens=3)])
    return seen


@pytest.fixture(scope="module", params=["llama", "moe_dense",
                                        "moe_capacity"])
def counted(request):
    reset_both()
    set_monitor(True)
    try:
        family, cfg = _family(request.param)
        yield request.param, _counted_serve(family, cfg)
    finally:
        set_monitor(False)
        reset_both()


@pytest.mark.parametrize("kind", KINDS)
def test_formula_matches_the_flop_counter(counted, kind):
    name, seen = counted
    hits = [(k, n) for k, n in seen if k[2] == kind]
    assert hits, f"{name}: no {kind} dispatch"
    for key, n in hits:
        formula = TM.programs.flops_of(key)
        assert formula is not None, key
        assert n > 0
        assert abs(formula - n) / n < 0.01, (key, formula, n)


def test_formula_counts_every_layer_and_step():
    """The formula scales with the layer count and the chunk's steps."""
    c2, c4 = TL.llama_tiny(num_hidden_layers=2), \
        TL.llama_tiny(num_hidden_layers=4)
    kw = dict(tokens=8, key_len=16, head_rows=8)
    f = TENG.serving_program_flops
    head = 2 * 8 * c2.hidden_size * c2.vocab_size
    assert f(c4, **kw) - head == pytest.approx(2 * (f(c2, **kw) - head))
    assert f(c2, steps=4, **kw) == pytest.approx(4 * f(c2, **kw))


@pytest.fixture(scope="module")
def both_serves():
    """One serve of every kind on both engines, monitor on."""
    mp = pytest.MonkeyPatch()
    clock = patch_clock(mp, FakeClock())
    reset_both()
    set_monitor(True)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 256, 8).astype(np.int32)
    tails = [rng.integers(0, 256, n).astype(np.int32) for n in (3, 2)]
    script = [("sub", 0, 11, 20, {"prompt": np.concatenate([shared,
                                                              tails[0]])}),
              ("sub", 1, 5, 20, {}),
              ("sub", 2, 3, 3, {"pseed": 7}),
              ("step",), ("step",), ("step",), ("step",), ("step",),
              ("sub", 3, 10, 3, {"prompt": np.concatenate([shared,
                                                             tails[1]])})]
    try:
        yield serve_pair(tiny_pair(2), clock, script, num_slots=2,
                         max_len=64, page_size=4, decode_chunk=2,
                         prefix_cache=True, spec_decode=True)
    finally:
        set_monitor(False)
        reset_both()
        mp.undo()


def test_program_names_and_hits_match(both_serves):
    res = both_serves
    jp, tp = res["jax"][2]["programs"], res["torch"][2]["programs"]
    assert tp == jp
    kinds = {n.split("[")[0] for n, _, _ in jp}
    assert set(KINDS) <= kinds


def test_tokens_and_counters_match(both_serves):
    res = both_serves
    for rid, o in res["jax"][0].items():
        assert res["torch"][0][rid].tokens.tolist() == o.tokens.tolist()
    assert res["torch"][2]["snapshot"]["counters"] == \
        res["jax"][2]["snapshot"]["counters"]


def test_reference_counts_a_scan_body_once(monitor_on):
    """Reference behaviour, pinned: XLA's cost analysis counts the layer
    loop's body once, so JAX's registered FLOPs of a 2-layer prefill of
    4 tokens are below the matmul FLOPs of its 2 layers, while the
    port's count every layer."""
    from paddle_tpu.inference import Request as JRequest
    from paddle_tpu.inference import ServingEngine as JEngine
    from paddle_tpu.models import llama as JL
    jcfg, jp, tcfg, tp = tiny_pair(2)
    kw = dict(num_slots=1, max_len=16, page_size=4, decode_chunk=2)
    p = np.arange(4, dtype=np.int32)
    JEngine(JL, jp, jcfg, **kw).run(
        [JRequest(rid=0, prompt=p, max_new_tokens=2)])
    ServingEngine(TL, tp, tcfg, device="cpu", **kw).run(
        [Request(rid=0, prompt=p, max_new_tokens=2)])
    name = "serving.prefill[g1,s4]"
    jf = {r["name"]: r["flops"] for r in JM.programs.programs_snapshot()}
    tf = {r["name"]: r["flops"] for r in TM.programs.programs_snapshot()}
    layer_mm = 2 * 2 * 4 * 36_864          # 2 layers x 4 tokens x weights
    assert jf[name] < layer_mm <= tf[name]


def test_registry_bounded_and_reset(monitor_on):
    for M in (JM, TM):
        for i in range(300):
            M.programs.record_program(("k", i), f"p{i}", source="test",
                                      flops=1.0)
        assert len(M.programs.programs_snapshot()) == 256
        assert M.programs.evicted_count() == 44
        M.programs.note_hit(("k", 299))
        M.programs.note_exec(("k", 299), 2.5)
        rec = M.programs.programs_snapshot()[0]
        assert (rec["hits"], rec["exec_samples"], rec["exec_mean_ms"]) \
            == (1, 1, 2.5)
        assert M.programs.flops_of(("k", 0)) is None
        M.reset()
        assert M.programs.programs_snapshot() == []


def test_signature_of_names_dtypes_and_shapes():
    sig = TM.programs.signature_of(
        (torch.zeros(2, 3), torch.zeros(4, dtype=torch.int32),
         np.zeros((1, 2), np.int64)))
    assert sig == "float32[2,3], int32[4], int64[1,2]"
