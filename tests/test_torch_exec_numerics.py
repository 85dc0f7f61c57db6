"""Port parity: the sampled exec timing (``monitor/exectime.py``) and the
KV half of the numerics plane (``monitor/numerics.py``) as the serving
engine feeds them.

- Exec samples: the same serve on both engines at sample rates 0, 1 and
  16 takes the same samples (the ``jit.program.exec.samples`` counter,
  the ``jit.program.exec_ms`` histogram's count and each program's
  ``exec_samples``); rate 0 takes none. ``time_call`` and a recorder
  called with outputs wait through ``_block_until_ready``.
- KV numerics: ``record_kv_absmax`` / ``record_kv_quant`` snapshots equal
  JAX's on the same pool contents (one numpy pool copied into each
  engine's own layout; the port's pools carry a sink page), with
  full-precision and int8 pools, through each engine's
  ``_maybe_sample_kv_absmax`` (values within 1e-6 relative: float32
  reductions on both sides, rounded to 9 decimals by the plane); and
  the same sample counts on a served pool at KV sample rates 0, 1 and
  3.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_monitor_common import (FakeClock, JM, TM, monitor_on,
                                   patch_clock, reset_both, serve_pair,
                                   set_monitor, tiny_pair)
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.models import llama as TL

assert monitor_on                       # a fixture the tests take

TEX = importlib.import_module("paddle_tpu_torch.monitor.exectime")


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair(2)


def _script():
    return [("sub", r, 4 + r % 3, 5 + r % 4, {}) for r in range(5)]


_KW = dict(num_slots=2, max_len=32, page_size=4, decode_chunk=2)


@pytest.fixture(scope="module", params=[0, 1, 16, "kv0", "kv3"])
def sampled(request, tiny):
    rate = request.param
    mp = pytest.MonkeyPatch()
    clock = patch_clock(mp, FakeClock())
    reset_both()
    set_monitor(True)
    for M in (JM, TM):
        if isinstance(rate, str):
            M.numerics.set_kv_sample_rate(int(rate[2:]))
        else:
            M.exectime.set_sample_rate(rate)
            M.numerics.set_kv_sample_rate(1)
    try:
        yield rate, serve_pair(tiny, clock, _script(), **_KW)
    finally:
        set_monitor(False)
        reset_both()
        mp.undo()


def test_exec_sample_counts_match(sampled):
    rate, res = sampled
    js, ts = res["jax"][2]["snapshot"], res["torch"][2]["snapshot"]
    key = "jit.program.exec.samples"
    assert ts["counters"].get(key) == js["counters"].get(key)
    hist = "jit.program.exec_ms"
    assert (ts["histograms"].get(hist, {}).get("count")
            == js["histograms"].get(hist, {}).get("count"))
    assert res["torch"][2]["programs"] == res["jax"][2]["programs"]
    if rate == 0:
        assert key not in ts["counters"] and hist not in ts["histograms"]
    elif rate == 1:
        # every dispatch of every program is sampled
        assert ts["counters"][key] == sum(
            h + 1 for _, h, _ in res["torch"][2]["programs"])


def test_kv_sample_counts_match(sampled):
    rate, res = sampled
    jk, tk = res["jax"][2]["kv"], res["torch"][2]["kv"]
    assert (tk["samples"], tk["pages"], tk["sample_rate"]) == \
        (jk["samples"], jk["pages"], jk["sample_rate"])
    if rate == "kv0":
        assert tk["samples"] == 0 and tk["max"] is None
    else:
        assert tk["samples"] > 0
        for k in ("min", "max", "mean"):
            assert tk[k] == pytest.approx(jk[k], rel=1e-5), k


def test_tokens_match(sampled):
    rate, res = sampled
    for rid, o in res["jax"][0].items():
        assert res["torch"][0][rid].tokens.tolist() == o.tokens.tolist()


def _pools(quant, L=2, P=12, kv=2, ps=4, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    shape = (L, P, kv, ps, hd)
    if not quant:
        return {n: rng.standard_normal(shape).astype(np.float32)
                * rng.uniform(0.1, 3.0, (L, P, 1, 1, 1)).astype(np.float32)
                for n in ("k", "v")}
    out = {}
    for n in ("k", "v"):
        q = rng.integers(-127, 128, shape).astype(np.int8)
        q[:, ::3, 0, 0, 0] = 127              # some codes on the rail
        s = rng.uniform(0.001, 0.05, shape[:3]).astype(np.float32)
        out[n] = {"q": q, "s": s}
    return out


def _load(eng_j, eng_t, pools, quant):
    eng_j.cache.pool = {n: ({k: jnp.asarray(v) for k, v in leaf.items()}
                            if quant else jnp.asarray(leaf))
                        for n, leaf in pools.items()}
    for n, leaf in pools.items():
        dst = eng_t.cache.pool[n]
        if quant:
            for k in ("q", "s"):
                P = leaf[k].shape[1]
                dst[k][:, :P] = torch.as_tensor(leaf[k])
        else:
            dst[:, :leaf.shape[1]] = torch.as_tensor(leaf)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("live", [(0,), (0, 3, 5), tuple(range(12))],
                         ids=["one", "some", "all"])
def test_kv_absmax_matches_on_the_same_pool(tiny, monitor_on, quant, live):
    jcfg, jp, tcfg, tp = tiny
    kw = dict(num_slots=2, max_len=16, page_size=4, num_pages=12,
              kv_quant=quant)
    eng_j = JEngine(JL, jp, jcfg, **kw)
    eng_t = ServingEngine(TL, tp, tcfg, device="cpu", **kw)
    _load(eng_j, eng_t, _pools(quant, L=2, kv=jcfg.num_key_value_heads,
                               hd=jcfg.head_dim), quant)
    for eng in (eng_j, eng_t):
        for p in live:                        # pages the allocator holds
            eng.cache.alloc._ref[p] = 1
    out = {}
    for side, M, eng in (("jax", JM, eng_j), ("torch", TM, eng_t)):
        M.numerics.set_kv_sample_rate(1)
        eng._maybe_sample_kv_absmax()
        out[side] = (M.numerics.kv_snapshot(),
                     M.numerics.kv_quant_snapshot(),
                     M.snapshot())
    j, t = out["jax"], out["torch"]
    for a, b in ((t[0], j[0]), (t[1], j[1])):
        a = {k: v for k, v in a.items() if k != "recent"}
        b = {k: v for k, v in b.items() if k != "recent"}
        assert a == pytest.approx(b, rel=1e-6)
    assert [{k: v for k, v in r.items() if k != "unix_time"}
            for r in t[0]["recent"]] == pytest.approx(
        [{k: v for k, v in r.items() if k != "unix_time"}
         for r in j[0]["recent"]], rel=1e-6)
    assert t[2]["counters"] == j[2]["counters"]
    assert t[0]["pages"] == 2 * 2 * len(live)
    if quant:
        assert t[1]["samples"] == 1 and t[1]["clip_fraction"] > 0


def test_kv_sampling_skips_an_empty_pool(tiny, monitor_on):
    jcfg, jp, tcfg, tp = tiny
    eng = ServingEngine(TL, tp, tcfg, device="cpu", **_KW)
    TM.numerics.set_kv_sample_rate(1)
    eng._maybe_sample_kv_absmax()
    assert TM.numerics.kv_snapshot()["samples"] == 0


def test_rate_zero_adds_no_sample_and_no_wait(monitor_on, monkeypatch):
    calls = []
    monkeypatch.setattr(TEX, "_block_until_ready", calls.append)
    TM.exectime.set_sample_rate(0)
    assert all(TM.exectime.maybe_sample(("k",)) is None
               for _ in range(40))
    TM.exectime.set_sample_rate(4)
    recs = [TM.exectime.maybe_sample(("k",)) for _ in range(8)]
    assert [r is not None for r in recs] == [False, False, False, True] * 2
    recs[3](torch.zeros(2))
    recs[7](None)
    assert len(calls) == 1
    assert TM.snapshot()["counters"]["jit.program.exec.samples"] == 2


def test_time_call_and_last_sample_match(monitor_on, monkeypatch):
    clock = patch_clock(monkeypatch, FakeClock())
    out = {}
    for M in (JM, TM):
        def fn(x):
            clock.advance(0.004)
            return x
        res, ms = M.exectime.time_call(("p",), fn, np.ones(2))
        out[M] = (ms, M.exectime.take_last_sample_ms(),
                  M.exectime.take_last_sample_ms(), M.snapshot())
    assert out[TM][:2] == pytest.approx(out[JM][:2], rel=1e-9)
    assert out[TM][0] == pytest.approx(4.0, rel=1e-9)
    assert out[TM][3] == out[JM][3]
    assert out[TM][2] is None


def test_block_until_ready_synchronizes_cuda_outputs_only(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    TEX._block_until_ready((torch.zeros(2), {"a": [torch.ones(1)]}))
    assert synced == []
