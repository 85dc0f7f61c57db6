"""Port parity: the continuous-batching serving engine
(``paddle_tpu_torch/inference/engine.py``).

The port's ``ServingEngine(device="cpu")`` and the JAX ``ServingEngine``
serve the same seeded trace on the same carried-over ``llama_tiny``
weights in float32. Greedy tokens must be identical, through queueing,
retirement and a preemption that the small page pool forces; the port
is also held to the JAX ring-buffer ``generate``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import Request as JRequest
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import Request, ServingEngine
from paddle_tpu_torch.inference.engine import RequestRejected
from paddle_tpu_torch.models import llama as TL


@pytest.fixture(scope="module")
def tiny():
    jcfg = JL.llama_tiny()
    jp = JL.init_params(jcfg, jax.random.PRNGKey(9))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TL.llama_tiny(), tp


def _trace(seed, lens, news, vocab):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), m)
            for n, m in zip(lens, news)]


# two slots and a 5-page pool of 4-token pages: requests queue, retire,
# and the growing sequences run the pool dry, which forces preemption
_ENGINE = dict(num_slots=2, max_len=16, page_size=4, num_pages=5,
               decode_chunk=2)


@pytest.mark.parametrize("watermark", [0.0, 0.4])
def test_engine_tokens_identical_to_jax_engine(tiny, watermark):
    """Also with an admission watermark (2 of 5 pages held back unless
    the engine is idle), which changes when requests are admitted."""
    jcfg, jp, tcfg, tp = tiny
    trace = _trace(5, (4, 7, 3, 5, 6), (8, 5, 9, 6, 4), jcfg.vocab_size)
    jeng = JEngine(JL, jp, jcfg, watermark=watermark, **_ENGINE)
    jout = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=m)
                     for i, (p, m) in enumerate(trace)])
    teng = ServingEngine(TL, tp, tcfg, device="cpu", watermark=watermark,
                         **_ENGINE)
    tout = teng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                     for i, (p, m) in enumerate(trace)])
    assert teng.stats.preempted >= 1
    assert teng.stats.preempted == jeng.stats.preempted
    assert teng.stats.admitted == jeng.stats.admitted
    for i, (_, m) in enumerate(trace):
        np.testing.assert_array_equal(tout[i].tokens, jout[i].tokens)
        assert len(tout[i].tokens) == m
        assert tout[i].preemptions == jout[i].preemptions
    teng.cache.alloc.check_invariants()
    assert teng.cache.alloc.used_pages == 0
    s = teng.stats
    assert s.completed == len(trace)
    assert s.tokens_generated - s.tokens_discarded == sum(
        m for _, m in trace)
    assert 0.0 < s.occupancy() <= 1.0


def test_engine_tokens_identical_to_jax_generate(tiny):
    """Three slots, four long generations and an EOS stop, held to the
    ring-buffer generate. Once the EOS request retires the grid is full
    with long runs, so the 4x turbo chunk engages."""
    jcfg, jp, tcfg, tp = tiny
    trace = _trace(7, (5, 8, 11, 6), (20, 18, 17, 19), jcfg.vocab_size)
    want = [np.asarray(JL.generate(jp, jnp.asarray(p)[None, :], jcfg,
                                   max_new_tokens=m))[0]
            for p, m in trace]
    eos = int(want[0][6])
    eng = ServingEngine(TL, tp, tcfg, num_slots=3, max_len=32, page_size=4,
                        decode_chunk=2, device="cpu")
    chunks = []
    pick = eng._pick_chunk
    eng._pick_chunk = lambda live: chunks.append(pick(live)) or chunks[-1]
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m,
                           eos_token_id=eos if i == 0 else None)
                   for i, (p, m) in enumerate(trace)])
    got0 = out[0].tokens
    assert got0[-1] == eos and len(got0) <= 7
    np.testing.assert_array_equal(got0, want[0][:len(got0)])
    for i in range(1, len(trace)):
        np.testing.assert_array_equal(out[i].tokens, want[i])
    assert eng.turbo_chunk in chunks
    assert eng.cache.alloc.used_pages == 0


def test_temperature_sampling_replays_under_preemption(tiny):
    """A sampled request draws from a seed per (request, token index), so
    the same trace gives the same tokens with or without preemption."""
    _, _, tcfg, tp = tiny
    trace = _trace(3, (4, 6, 5), (8, 7, 8), tcfg.vocab_size)

    def run(num_pages):
        eng = ServingEngine(TL, tp, tcfg, num_slots=2, max_len=16,
                            page_size=4, num_pages=num_pages,
                            decode_chunk=2, device="cpu")
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m,
                               temperature=0.9, seed=100 + i)
                       for i, (p, m) in enumerate(trace)])
        return eng.stats.preempted, [out[i].tokens for i in range(3)]

    pre_small, small = run(5)
    pre_big, big = run(8)
    assert pre_small >= 1 and pre_big == 0
    for a, b in zip(small, big):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("temperature", [0.7, 1.5])
def test_sampled_tokens_follow_the_tempered_softmax(temperature):
    """``_sample_rows`` over 4000 rows of the same logits, each row drawn
    from its own seed: every token's count lies within five binomial
    deviations of 4000 * softmax(logits / t), and the token of
    probability 0 (logit -inf) is never drawn."""
    from paddle_tpu_torch.inference.engine import _sample_rows, _token_seed
    n = 4000
    row = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -float("inf"), 0.3, 1.5])
    toks = _sample_rows(row.expand(n, -1), [temperature] * n,
                        [_token_seed(s, 0) for s in range(n)])
    counts = np.bincount(toks.numpy(), minlength=row.numel())
    p = torch.softmax(row.double() / temperature, dim=-1).numpy()
    assert counts[5] == 0
    bound = 5 * np.sqrt(n * p * (1 - p)) + 1
    assert (np.abs(counts - n * p) <= bound).all(), (counts, n * p)


@pytest.mark.parametrize("kw", [
    dict(prompt=np.zeros((0,), np.int32), max_new_tokens=2),
    dict(prompt=np.array([1, 300]), max_new_tokens=2),
    dict(prompt=np.array([[1, 2]]), max_new_tokens=2),
    dict(prompt=np.array([1.5]), max_new_tokens=2),
    dict(prompt=np.array([1, 2]), max_new_tokens=0),
    dict(prompt=np.array([1, 2]), max_new_tokens=2.5),
    dict(prompt=np.array([1, 2]), max_new_tokens=15),
    dict(prompt=np.array([1, 2]), max_new_tokens=2,
         temperature=float("nan")),
])
def test_malformed_submission_rejected(tiny, kw):
    _, _, tcfg, tp = tiny
    eng = ServingEngine(TL, tp, tcfg, num_slots=1, max_len=16, page_size=4,
                        device="cpu")
    with pytest.raises(RequestRejected):
        eng.submit(Request(rid=0, **kw))
    assert not eng.queue and eng.cache.alloc.used_pages == 0


def test_params_on_another_device_refused(tiny):
    _, _, tcfg, tp = tiny
    with pytest.raises(ValueError):
        ServingEngine(TL, tp, tcfg, device=torch.device("meta"))


def test_serving_a_grad_tree_builds_no_graph(tiny):
    """The engine runs its device work in inference mode: a parameter
    tree that requires grad gives the same greedy tokens as a plain one,
    its ``.grad`` stays unset, and no attention backward is set up."""
    from paddle_tpu_torch import kernels as TK
    _, _, tcfg, tp = tiny
    trace = _trace(11, (4, 6, 5), (6, 5, 7), tcfg.vocab_size)
    grad_tp = TL._map(lambda p: p.detach().clone().requires_grad_(), tp)
    outs = []
    for params in (tp, grad_tp):
        eng = ServingEngine(TL, params, tcfg, device="cpu", **_ENGINE)
        TK.reset_dispatch_stats()
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                       for i, (p, m) in enumerate(trace)])
        assert TK.dispatch_stats()["flash_ref"] > 0
        outs.append([out[i].tokens for i in range(len(trace))])
        assert not eng.cache.pool["k"].requires_grad
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert all(p.grad is None and p.requires_grad
               for p in TL._leaves(grad_tp))
