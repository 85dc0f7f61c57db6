"""Port parity: the serving engine's prefix cache and n-gram speculative
decode (``paddle_tpu_torch/inference/engine.py``).

The port's ``ServingEngine(device="cpu")`` and the JAX ``ServingEngine``
serve the same seeded requests on the same carried-over float32
``llama_tiny`` (2 layers) weights, each option on. Greedy tokens must be
identical token for token, and so must the counters the options keep
(prefix lookups, hits, tokens saved, evictions; spec rounds, drafts,
acceptances; preemptions), the prefill and decode-step counts, and every
serve must leave the page allocator's refcounts consistent
(``check_invariants``). float32 on purpose: the options run other programs
than the plain path (the shared prefill, the verify window), whose
argmax agrees with the plain path's exactly only in float32 (the
reference's own tests pin the same).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.inference.engine import _Slot as JSlot
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.inference.engine import _Slot
from paddle_tpu_torch.models import llama as TL

PREFIX_STATS = ("prefix_lookups", "prefix_hits", "prefix_tokens_saved",
                "prefix_evictions")
SPEC_STATS = ("spec_rounds", "spec_drafted", "spec_accepted")


@pytest.fixture(scope="module")
def tiny():
    jcfg = JL.llama_tiny(num_hidden_layers=2, dtype=jnp.float32)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TL.llama_tiny(num_hidden_layers=2), tp


def _engines(tiny, **kw):
    jcfg, jp, tcfg, tp = tiny
    return (JEngine(JL, jp, jcfg, **kw),
            ServingEngine(TL, tp, tcfg, device="cpu", **kw))


def _prompts_with_prefix(rng, vocab, prefix_len, tails):
    prefix = rng.integers(0, vocab, (prefix_len,)).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, (n,))
                            .astype(np.int32)]) for n in tails]


def _same_stats(teng, jeng, keys):
    t, j = teng.stats.as_dict(), jeng.stats.as_dict()
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}


def test_options_off_are_inert(tiny):
    _, teng = _engines(tiny, num_slots=2, max_len=32, page_size=4,
                       decode_chunk=3)
    assert teng._prefix is None and not teng._spec_decode
    assert not teng._priority_admission and teng._tenant_cap == 0
    assert not teng._slo_preemption
    sd = teng.stats.as_dict()
    assert all(sd[k] == 0 for k in PREFIX_STATS + SPEC_STATS)
    rng = np.random.default_rng(7)
    out = teng.run([Request(rid=0, prompt=rng.integers(0, 256, 9),
                            max_new_tokens=4)])
    assert len(out[0].tokens) == 4
    sd = teng.stats.as_dict()
    assert all(sd[k] == 0 for k in PREFIX_STATS + SPEC_STATS)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_cache_on_token_parity_and_hits(tiny, kv_quant):
    """The reference's two-prompt serial case (8 shared tokens, tails of 3
    and 5): retirement of the first seeds the radix, the second forks two
    cached pages and prefills only its tail. Tokens equal the JAX
    cache-on engine's and the port's cache-off ones; with int8 pages the
    JAX int8 engine's."""
    rng = np.random.default_rng(7)
    prompts = _prompts_with_prefix(rng, 256, 8, (3, 5))
    kw = dict(num_slots=2, max_len=32, page_size=4, decode_chunk=3,
              kv_quant=kv_quant)

    def run(eng, req):
        outs = {}
        for i, p in enumerate(prompts):     # serial: retire seeds radix
            outs.update(eng.run([req(rid=i, prompt=p, max_new_tokens=4)]))
        eng.cache.alloc.check_invariants()
        return {i: o.tokens.tolist() for i, o in outs.items()}

    jeng, teng = _engines(tiny, prefix_cache=True, **kw)
    _, toff = _engines(tiny, **kw)
    got, want = run(teng, Request), run(jeng, JRequest)
    assert got == want
    assert got == run(toff, Request)
    _same_stats(teng, jeng, PREFIX_STATS + (
        "tokens_prefilled", "decode_steps", "admitted", "completed"))
    assert teng.stats.prefix_lookups == 2
    assert teng.stats.prefix_hits == 1
    assert teng.stats.prefix_tokens_saved == 8
    assert teng.stats.tokens_prefilled == toff.stats.tokens_prefilled - 8
    assert teng.stats.decode_steps == toff.stats.decode_steps
    # the second request's cached pages are the first one's: the radix
    # holds the committed pages, and nothing else stays referenced
    assert teng._prefix.nodes > 0
    assert teng.cache.alloc.used_pages == teng._prefix.nodes


def test_spec_greedy_identity(tiny):
    """A repetitive prompt: the greedy generation goes periodic, so the
    bigram drafts are accepted. Port spec-on tokens equal port spec-off
    tokens and the JAX spec-on engine's, with the same rounds, drafts and
    acceptances."""
    rng = np.random.default_rng(13)
    rep = np.tile(rng.integers(0, 256, (4,)).astype(np.int32), 3)
    kw = dict(num_slots=1, max_len=64, page_size=4, decode_chunk=2)
    jeng, teng = _engines(tiny, spec_decode=True, **kw)
    _, toff = _engines(tiny, **kw)
    got = teng.run([Request(rid=0, prompt=rep, max_new_tokens=28)])
    want = jeng.run([JRequest(rid=0, prompt=rep, max_new_tokens=28)])
    off = toff.run([Request(rid=0, prompt=rep, max_new_tokens=28)])
    np.testing.assert_array_equal(got[0].tokens, want[0].tokens)
    np.testing.assert_array_equal(got[0].tokens, off[0].tokens)
    _same_stats(teng, jeng,
                SPEC_STATS + ("decode_steps", "tokens_generated"))
    assert teng.stats.spec_rounds > 0
    assert 0 < teng.stats.spec_accepted <= teng.stats.spec_drafted
    teng.cache.alloc.check_invariants()


def test_spec_never_fires_for_sampled(tiny):
    _, teng = _engines(tiny, num_slots=1, max_len=48, page_size=4,
                       decode_chunk=2, spec_decode=True)
    p = np.random.default_rng(17).integers(0, 256, (5,))
    out = teng.run([Request(rid=0, prompt=p, max_new_tokens=12,
                            temperature=0.7, seed=3)])
    assert len(out[0].tokens) == 12
    assert teng.stats.spec_rounds == 0     # sampled: the sequential path


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("C", [4, 8])
def test_draft_for_matches_the_reference(seed, C):
    """``_draft_for`` (host only) against the reference's on the same slot
    states, drafted twice per slot as the context grows, so the
    incremental fold is held too."""
    rng = np.random.default_rng(seed)
    prompt = np.tile(rng.integers(0, 6, (5,)), 3)[:int(rng.integers(3, 15))]
    tokens = rng.integers(0, 6, (int(rng.integers(1, 9)),)).tolist()
    slots = (_Slot(Request(rid=0, prompt=prompt.astype(np.int64),
                           max_new_tokens=64)),
             JSlot(JRequest(rid=0, prompt=prompt.astype(np.int32),
                            max_new_tokens=64), np.zeros((64, 2))))
    more = rng.integers(0, 6, (5,)).tolist()
    for extra in (tokens, more):
        for s in slots:
            s.tokens.extend(extra)
            s.pending = s.tokens[-1]
        got = ServingEngine._draft_for(None, slots[0], C)
        want = JEngine._draft_for(None, slots[1], C)
        np.testing.assert_array_equal(got, want)
        assert slots[0].ng == slots[1].ng
        assert slots[0].ng_n == slots[1].ng_n


def test_starved_pool_prefix_spec_and_preemption(tiny):
    """Prefix cache and spec decode together in a pool too small for the
    traffic: three prefix families over ten requests, so admissions evict
    cold radix leaves, sequences fork cached pages, the grid preempts and
    re-prefills, and full grids take verify rounds. Tokens, preemptions,
    evictions and every option counter equal the JAX engine's, and the
    tokens equal the port's options-off serve."""
    rng = np.random.default_rng(23)
    fams = [rng.integers(0, 256, (8,)).astype(np.int32) for _ in range(3)]
    prompts = [np.concatenate([fams[i % 3], rng.integers(
        0, 256, (2 + i % 4,)).astype(np.int32)]) for i in range(10)]
    kw = dict(num_slots=2, max_len=32, page_size=4, num_pages=14,
              decode_chunk=2)
    jeng, teng = _engines(tiny, prefix_cache=True, spec_decode=True, **kw)
    _, toff = _engines(tiny, **kw)
    got = teng.run([Request(rid=i, prompt=p, max_new_tokens=18)
                    for i, p in enumerate(prompts)])
    want = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=18)
                     for i, p in enumerate(prompts)])
    off = toff.run([Request(rid=i, prompt=p, max_new_tokens=18)
                    for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
        np.testing.assert_array_equal(got[i].tokens, off[i].tokens)
        assert got[i].preemptions == want[i].preemptions
    _same_stats(teng, jeng, PREFIX_STATS + SPEC_STATS + (
        "preempted", "tokens_prefilled", "decode_steps", "completed"))
    s = teng.stats
    assert s.preempted > 0 and s.prefix_evictions > 0
    assert s.prefix_hits > 0 and s.spec_rounds > 0
    teng.cache.alloc.check_invariants()
