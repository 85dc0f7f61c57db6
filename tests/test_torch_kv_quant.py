"""Port parity: int8 KV pages (the reference's ``FLAGS_serving_kv_quant``):
the int8 arm of paged decode attention
(``paddle_tpu_torch/kernels/paged_attention.py``), the int8 page pool and
its quantizing writes (``inference/paged.py``) and the engine's
``kv_quant`` switch (``inference/engine.py``).

Inputs come from ``np.random.default_rng(seed)`` and go to both packages;
weights are the JAX ``llama_tiny`` tree carried over through numpy; the
JAX Pallas kernel runs in interpret mode. Tolerances, float32 throughout:
attention ``2e-5`` (summation order; the Pallas kernel folds the scale
into its dots, the plain versions dequantize first); the quantized plain
version against the full-precision one on dequantized pages ``1e-6``
(the same products); codes exactly equal and scales within 1 ulp (one
division and one rounding, the same in both); after a prefill and three
decode steps, logits ``1e-5`` of their largest magnitude and at most
0.1% of the pool's codes off by one (float32 noise at a .5 boundary,
re-rounded on every append); greedy tokens exactly equal.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.inference import paged as JP
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.inference import paged as TP
from paddle_tpu_torch.kernels import paged_attention as TPA
from paddle_tpu_torch.models import llama as TL
from test_torch_paged import _split_combine

JPA = importlib.import_module("paddle_tpu.kernels.paged_attention")


@pytest.fixture(scope="module")
def tiny():
    """One float32 ``llama_tiny`` tree (the reference's own quantization
    case, ``PRNGKey(0)``), in both packages."""
    jcfg = JL.llama_tiny()
    jp = JL.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TL.llama_tiny(), tp


def _quant_case(*, B=4, nh=4, kv=2, hd=32, ps=32, P=12, maxp=3, seed=0):
    """int8 codes, positive scales with two never-written pages (scale
    0), lengths with a partial page, an empty slot, a page boundary and a
    full table; garbage and sentinel entries past each sequence's
    pages."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, nh, hd)).astype(np.float32)
    kc = rng.integers(-127, 128, (P, kv, ps, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (P, kv, ps, hd)).astype(np.int8)
    ks = rng.uniform(0.001, 0.03, (P, kv)).astype(np.float32)
    vs = rng.uniform(0.001, 0.03, (P, kv)).astype(np.float32)
    ks[[2, 7]] = 0.0
    vs[[2, 7]] = 0.0
    lengths = np.array([ps + 5, 0, 2 * ps, maxp * ps][:B], np.int32)
    bt = rng.integers(-5, 3 * P, (B, maxp)).astype(np.int32)
    bt[:, -1] = P
    for b, n in enumerate(lengths):
        used = -(-int(n) // ps)
        bt[b, :used] = rng.permutation(P)[:used]
    return q, kc, vc, ks, vs, bt, lengths


def test_int8_ref_matches_jax_ref_and_interpret_kernel():
    arrs = _quant_case()
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.as_tensor(a) for a in arrs]
    got = TPA.paged_attention_ref(t[0], t[1], t[2], t[5], t[6],
                                  k_scales=t[3], v_scales=t[4])
    want = JPA.paged_attention_ref(j[0], j[1], j[2], j[5], j[6],
                                   k_scales=j[3], v_scales=j[4])
    kern = JPA.ragged_paged_attention(j[0], j[1], j[2], j[5], j[6],
                                      k_scales=j[3], v_scales=j[4],
                                      interpret=True)
    assert got.dtype == torch.float32 and torch.all(got[1] == 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("ps", [16, 32])
def test_int8_ref_equals_full_precision_on_dequantized_pages(ps):
    q, kc, vc, ks, vs, bt, ln = (torch.as_tensor(a) for a in _quant_case(
        ps=ps, maxp=4, seed=1))
    got = TPA.paged_attention_ref(q, kc, vc, bt, ln, k_scales=ks,
                                  v_scales=vs)
    kd = kc.float() * ks[:, :, None, None]
    vd = vc.float() * vs[:, :, None, None]
    want = TPA.paged_attention_ref(q, kd, vd, bt, ln)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_int8_split_combine_model_matches_jax_kernel_interpret_and_ref():
    """The plain model of the kernel's split-then-combine with folded
    scales (``test_torch_paged._split_combine``), at the chunk of
    ``decode_split_plan`` for int8 pages of 32 (64 positions, 8 splits):
    lengths 0, 1, chunk - 1, chunk, chunk + 1 and the full table, four
    rows whose every split past the first is empty; against JAX's
    interpret-mode kernel and reference and the port's plain version."""
    B, ps, maxp = 6, 32, 16
    pps, splits = TPA.decode_split_plan(B, 2, ps, maxp)
    c = pps * ps
    assert (c, splits) == (64, 8)
    q, kc, vc, ks, vs, bt, _ = _quant_case(B=B, ps=ps, P=20, maxp=maxp,
                                           seed=2)
    lengths = np.array([0, 1, c - 1, c, c + 1, maxp * ps], np.int32)
    rng = np.random.default_rng(6)
    for b, n in enumerate(lengths):
        used = -(-int(n) // ps)
        bt[b, :used] = rng.permutation(20)[:used]
    j = [jnp.asarray(a) for a in (q, kc, vc, ks, vs, bt, lengths)]
    t = [torch.as_tensor(a) for a in (q, kc, vc, ks, vs, bt, lengths)]
    got = _split_combine(t[0], t[1], t[2], t[5], t[6], pps, k_scales=t[3],
                         v_scales=t[4])
    kern = JPA.ragged_paged_attention(j[0], j[1], j[2], j[5], j[6],
                                      k_scales=j[3], v_scales=j[4],
                                      interpret=True)
    want = JPA.paged_attention_ref(j[0], j[1], j[2], j[5], j[6],
                                   k_scales=j[3], v_scales=j[4])
    plain = TPA.paged_attention_ref(t[0], t[1], t[2], t[5], t[6],
                                    k_scales=t[3], v_scales=t[4])
    assert torch.all(got[0] == 0) and torch.isfinite(got).all()
    for other in (np.asarray(kern), np.asarray(want), plain.numpy()):
        np.testing.assert_allclose(got.numpy(), other, atol=2e-5, rtol=0)


def test_int8_wrapper_on_cpu_counts_the_quant_arm():
    q, kc, vc, ks, vs, bt, ln = (torch.as_tensor(a)
                                 for a in _quant_case(B=2))
    TK.reset_dispatch_stats()
    out = TK.dispatched_paged_attention(q, kc, vc, bt, ln, k_scales=ks,
                                        v_scales=vs)
    stats = TK.dispatch_stats()
    assert stats["paged_quant_ref"] == 1 and stats["paged_ref"] == 0
    assert stats["paged_quant"] == 0 and stats["paged"] == 0
    torch.testing.assert_close(out, TPA.paged_attention_ref(
        q, kc, vc, bt, ln, k_scales=ks, v_scales=vs))
    with pytest.raises(TE.InvalidArgumentError):
        TPA.ragged_paged_attention(q, kc, vc, bt, ln, k_scales=ks)


def test_supported_quant_guard():
    q = torch.zeros(2, 8, 128)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    codes16 = torch.zeros(4, 2, 16, 128, dtype=torch.int8)
    assert TPA.supported(q, codes16, bt, quant=True)       # no ps % 32 rule
    assert TPA.supported(q.bfloat16(), torch.zeros(4, 2, 64, 128,
                                                   dtype=torch.int8),
                         bt, quant=True)
    assert not TPA.supported(q, codes16, bt)               # int8, no scales
    assert not TPA.supported(q, torch.zeros(4, 2, 16, 128), bt, quant=True)
    assert TPA.supported(q.half(), codes16, bt, quant=True)  # float16 q
    assert not TPA.supported(q.double(), codes16, bt, quant=True)


# -- the int8 pool -----------------------------------------------------------

def test_kv_quantize_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(6, 2, 8, 16)) * 3).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, -0.5, 1.5, -2.5]          # halves: to even
    s = np.abs(x).max(axis=(-2, -1), keepdims=True) / 127.0
    s[1] = 0.0                                       # guarded divisor
    s[2] = 0.5
    got = TP._kv_quantize(torch.as_tensor(x), torch.as_tensor(s))
    want = np.asarray(JP._kv_quantize(jnp.asarray(x), jnp.asarray(s)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_leaf(q, s):
    return {"q": jnp.asarray(q), "s": jnp.asarray(s)}


def _pool_write_both(rng, P=9, kv=2, ps=8, hd=16, G=3, npad=2):
    """The same page grids written into a zero int8 pool by both
    packages (row 1 of the group is padding: a sentinel page)."""
    pages = rng.normal(size=(G, npad, kv, ps, hd)).astype(np.float32)
    rows = rng.permutation(P)[:G * npad].reshape(G, npad).astype(np.int32)
    rows[1, 1] = P
    jleaf = {"q": jnp.zeros((1, P, kv, ps, hd), jnp.int8),
             "s": jnp.zeros((1, P, kv), jnp.float32)}
    jleaf = JP._kv_pool_write(jleaf, jnp.asarray(pages)[None],
                              jnp.asarray(rows))
    # the port's leaf has a sink page past the P usable ones, where the
    # sentinel row's write lands; the comparison leaves it out
    tleaf = {"q": torch.zeros(P + 1, kv, ps, hd, dtype=torch.int8),
             "s": torch.zeros(P + 1, kv)}
    TP._kv_pool_write(tleaf, torch.as_tensor(pages),
                      torch.as_tensor(rows).long())
    return ({k: np.asarray(v[0]) for k, v in jleaf.items()},
            {k: v[:P] for k, v in tleaf.items()})


def _assert_leaf_equal(tleaf, jq, js):
    np.testing.assert_array_equal(tleaf["q"].numpy(), jq)
    np.testing.assert_array_max_ulp(tleaf["s"].numpy(), js, maxulp=1)


def test_quantizing_pool_write_matches_jax():
    j, t = _pool_write_both(np.random.default_rng(4))
    _assert_leaf_equal(t, j["q"], j["s"])
    assert (t["s"] > 0).sum() == 5 * 2                # 5 pages written


def test_quantizing_page_append_matches_jax():
    """Appends at slot 0 of a page that holds stale codes (zeroed before
    the new absmax), mid-page and at the last slot, after a prefill
    write."""
    rng = np.random.default_rng(5)
    j, t = _pool_write_both(rng)
    P, kv, ps, hd = t["q"].shape
    written = [int(p) for p in np.nonzero(t["s"][:, 0].numpy())[0]]
    rows = np.array(written[:3], np.int32)
    for off in ([0, 3, ps - 1], [1, 4, 0]):
        off = np.array(off, np.int32)
        val = (rng.normal(size=(3, kv, hd)) * 2).astype(np.float32)
        jl = JP._kv_page_append(_jax_leaf(j["q"], j["s"]),
                                jnp.asarray(rows), jnp.asarray(off),
                                jnp.asarray(val), P)
        j = {k: np.asarray(v) for k, v in jl.items()}
        TP._kv_page_append(t, torch.as_tensor(rows).long(),
                           torch.as_tensor(off).long(),
                           torch.as_tensor(val))
        _assert_leaf_equal(t, j["q"], j["s"])


def test_cow_copies_codes_and_scales_in_lockstep():
    c = TP.PagedKVCache(TL.llama_tiny(), num_pages=6, page_size=4,
                        max_pages_per_seq=3, device="cpu", kv_quant=True)
    assert c.pool["k"]["q"].dtype == torch.int8
    assert tuple(c.pool["k"]["s"].shape) == (2, 6 + 1, 2)   # + the sink
    pages = c.alloc.alloc(0, 6)
    c.pool["k"]["q"][:, pages[1]] = 7
    c.pool["k"]["s"][:, pages[1]] = 0.25
    c.alloc.advance(0, 6)
    c.alloc.fork(0, 1)
    _, cow = c.alloc.ensure(1, 7)
    c.apply_cow(cow)
    c.alloc.check_invariants()
    dst = c.alloc.seq_pages(1)[1]
    assert dst != pages[1]
    assert torch.all(c.pool["k"]["q"][:, dst] == 7)
    assert torch.all(c.pool["k"]["s"][:, dst] == 0.25)
    c.alloc.free(0)
    c.alloc.free(1)
    assert c.alloc.used_pages == 0


def test_prefill_then_decode_with_int8_pools_matches_jax(tiny):
    """A prefill group (two prompts ending inside a page, an
    all-sentinel dummy row, a row whose second page is the sentinel),
    then three decode steps with one inactive slot, on int8 pools."""
    jcfg, jp, tcfg, tp = tiny
    ps, P, maxp, S = 4, 10, 4, 8
    rng = np.random.default_rng(11)
    ids = rng.integers(0, jcfg.vocab_size, (4, S)).astype(np.int32)
    slen = np.array([7, 5, 1, 1], np.int32)
    rows = np.full((4, S // ps), P, np.int32)
    rows[0], rows[1], rows[3] = [3, 8], [1, 6], [0, P]
    jpool = JP.init_pool(jcfg, P, ps, kv_quant=True)
    jk, jv, jlog = JP.paged_prefill(JL, jp, jnp.asarray(ids), jcfg,
                                    jpool["k"], jpool["v"],
                                    jnp.asarray(rows), jnp.asarray(slen))
    pool = TP.init_pool(tcfg, P, ps, device="cpu", kv_quant=True)
    tlog = TP.paged_prefill(TL, tp, torch.as_tensor(ids).long(), tcfg,
                            pool["k"], pool["v"],
                            torch.as_tensor(rows).long(),
                            torch.as_tensor(slen))

    def check(tlog, jlog, live):
        want = np.asarray(jlog)[live]
        err = np.abs(tlog.numpy()[live] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err
        codes = off = 0
        for t, j in ((pool["k"], jk), (pool["v"], jv)):
            t = {k: v[:, :P] for k, v in t.items()}        # the sink aside
            d = np.abs(t["q"].numpy().astype(np.int32)
                       - np.asarray(j["q"]).astype(np.int32))
            assert d.max() <= 1
            off += int((d > 0).sum())
            codes += d.size
            np.testing.assert_allclose(t["s"].numpy(), np.asarray(j["s"]),
                                       rtol=1e-6, atol=0)
        assert off <= 1e-3 * codes, off

    check(tlog, jlog, slice(None))
    bt = np.full((3, maxp), P, np.int32)
    bt[0, :3], bt[1, :3] = [3, 8, 5], [1, 6, 2]
    lengths = np.array([8, 6, 0], np.int32)
    toks = np.array([17, 200, 3], np.int32)
    for _ in range(3):
        jk, jv, jlog = JP.paged_decode_step(
            JL, jp, jk, jv, jnp.asarray(bt), jnp.asarray(lengths),
            jnp.asarray(toks), jcfg)
        tlog = TP.paged_decode_step(TL, tp, pool["k"], pool["v"],
                                    torch.as_tensor(bt),
                                    torch.as_tensor(lengths),
                                    torch.as_tensor(toks).long(), tcfg)
        live = lengths > 0
        check(tlog, jlog, live)
        toks = np.asarray(jlog).argmax(-1).astype(np.int32)
        lengths = np.where(live, lengths + 1, 0).astype(np.int32)


# -- the engine --------------------------------------------------------------

# two slots and a 5-page pool of 4-token pages: requests queue, retire,
# and the growing sequences run the pool dry, which forces preemption
_ENGINE = dict(num_slots=2, max_len=16, page_size=4, num_pages=5,
               decode_chunk=2)


def _trace(lens, news, seed, vocab):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), m)
            for n, m in zip(lens, news)]


def _serve(engine_cls, req_cls, family, params, cfg, trace, **kw):
    eng = engine_cls(family, params, cfg, **kw)
    out = eng.run([req_cls(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m) in enumerate(trace)])
    eng.cache.alloc.check_invariants()
    assert eng.cache.alloc.used_pages == 0
    return eng, [out[i].tokens for i in range(len(trace))]


def test_engine_kv_quant_tokens_match_jax_through_preemption(tiny):
    jcfg, jp, tcfg, tp = tiny
    trace = _trace((4, 7, 3, 5, 6), (8, 5, 9, 6, 4), 5, jcfg.vocab_size)
    jeng, want = _serve(JEngine, JRequest, JL, jp, jcfg, trace,
                        kv_quant=True, **_ENGINE)
    TK.reset_dispatch_stats()
    eng, got = _serve(ServingEngine, Request, TL, tp, tcfg, trace,
                      kv_quant=True, device="cpu", **_ENGINE)
    stats = TK.dispatch_stats()
    assert stats["paged_quant_ref"] > 0 and stats["paged_ref"] == 0
    assert isinstance(eng.cache.pool["k"], dict)
    assert eng.stats.preempted >= 1
    assert eng.stats.preempted == jeng.stats.preempted
    for (_, m), a, b in zip(trace, got, want):
        np.testing.assert_array_equal(a, b)
        assert len(a) == m


def test_engine_kv_quant_tokens_equal_full_precision(tiny):
    """The reference's own case (``test_quantization.py``'s
    ``test_llama_greedy_fallback``): at this size int8 pages leave every
    greedy token of the full-precision pools unchanged, in both
    packages."""
    jcfg, jp, tcfg, tp = tiny
    trace = _trace((5, 9, 12), (6, 6, 6), 7, jcfg.vocab_size)
    kw = dict(num_slots=2, max_len=32, page_size=4, decode_chunk=3)
    _, want = _serve(JEngine, JRequest, JL, jp, jcfg, trace, kv_quant=True,
                     **kw)
    _, full = _serve(ServingEngine, Request, TL, tp, tcfg, trace,
                     device="cpu", **kw)
    _, got = _serve(ServingEngine, Request, TL, tp, tcfg, trace,
                    kv_quant=True, device="cpu", **kw)
    for a, b, c in zip(got, want, full):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("kv_quant,page", [(False, 16), (True, 32)])
def test_engine_default_page_size(kv_quant, page):
    tcfg = TL.llama_tiny()
    tp = TL.init_params(tcfg, seed=0, device="cpu")
    eng = ServingEngine(TL, tp, tcfg, num_slots=2, max_len=64,
                        kv_quant=kv_quant, device="cpu")
    assert eng.page_size == page
    bf16 = TP.PagedKVCache(tcfg, 8, page, 2, dtype=torch.bfloat16,
                           device="cpu")
    if kv_quant:
        # codes at 1 byte and 8 scale bytes a (page, kv head) against
        # 2-byte bfloat16 values: ~2x the tokens in the same bytes
        ratio = bf16.pool_bytes() / eng.cache.pool_bytes() * (
            eng.cache.num_pages / 8)
        assert 1.9 < ratio < 2.0
