"""Port parity: ring-cache generation (``paddle_tpu_torch/models/llama.py``
``init_cache`` / ``prefill`` / ``decode_step`` / ``generate`` /
``beam_search`` / ``make_sampler``) against ``paddle_tpu/models/llama.py``
on ``llama_tiny`` with the JAX weights carried over
(``params_from_numpy``), on the CPU.

Tolerances: float32 logits within ``1e-5`` (absolute; the logits are of
size ~0.1-1, summation order only) and cache contents within ``1e-6``;
bfloat16 logits within ``1e-2`` of the largest (4.2e-3 measured; both
round every product and activation to bfloat16, at places that differ by
one rounding).
Greedy and beam tokens are equal exactly in float32; beam scores within
``1e-5``. Sampled tokens are never compared (a JAX key is not a torch
generator): the sampler's filter is held to the support of JAX's draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as JL
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.models import llama as TL


@pytest.fixture(scope="module")
def tiny():
    jcfg = JL.llama_tiny()
    jp = JL.init_params(jcfg, jax.random.PRNGKey(1))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TL.llama_tiny(), tp


def _ids(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


def test_prefill_and_decode_steps_match_jax(tiny):
    """Logits of the prefill and of 3 decode steps, and the cache after
    the prefill and after the steps (the port writes in place). The
    prefill's attention goes through the flash wrapper."""
    jcfg, jp, tcfg, tp = tiny
    ids = _ids((2, 6))
    jcache = JL.init_cache(jcfg, 2, 10)
    jcache, jlog = JL.prefill(jp, jnp.asarray(ids), jcfg, jcache)
    TK.reset_dispatch_stats()
    cache = TL.init_cache(tcfg, 2, 10, device="cpu")
    cache, log = TL.prefill(tp, torch.as_tensor(ids), tcfg, cache)
    assert TK.dispatch_stats()["flash_ref"] == tcfg.num_hidden_layers
    assert cache["pos"] == 6 and int(jcache["pos"]) == 6
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-6)
    for step in range(3):
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        jcache, jlog = JL.decode_step(jp, jcache, jnp.asarray(tok), jcfg)
        cache, log = TL.decode_step(tp, cache, torch.as_tensor(tok), tcfg)
        assert cache["pos"] == 7 + step
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   atol=1e-5, err_msg=f"step {step}")
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-6)
        assert not cache[name][:, :, 9:].any()   # never written


def test_prefill_and_decode_bf16_match_jax():
    jcfg = JL.llama_tiny(dtype=jnp.bfloat16)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(2))
    tcfg = TL.llama_tiny(dtype=torch.bfloat16)
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    ids = _ids((2, 5), seed=3)
    jcache, jlog = JL.prefill(jp, jnp.asarray(ids), jcfg,
                              JL.init_cache(jcfg, 2, 8))
    cache, log = TL.prefill(tp, torch.as_tensor(ids), tcfg,
                            TL.init_cache(tcfg, 2, 8, device="cpu"))
    assert cache["k"].dtype == torch.bfloat16
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for _ in range(2):
        jcache, jlog2 = JL.decode_step(jp, jcache, jnp.asarray(tok), jcfg)
        cache, log2 = TL.decode_step(tp, cache, torch.as_tensor(tok), tcfg)
    for got, want in ((log, jlog), (log2, jlog2)):
        want = _np(want)
        assert np.abs(_np(got) - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("case", ["plain", "eos", "eos_negative_pad",
                                  "one_token", "no_tokens"])
def test_generate_greedy_matches_jax(tiny, case):
    jcfg, jp, tcfg, tp = tiny
    ids = _ids((3, 7))
    new = {"one_token": 1, "no_tokens": 0}.get(case, 6)
    kw = {}
    if case.startswith("eos"):
        # an EOS that the greedy run of row 0 emits at its 3rd token
        plain = np.asarray(JL.generate(jp, jnp.asarray(ids), jcfg,
                                       max_new_tokens=new))
        kw = dict(eos_token_id=int(plain[0, 2]),
                  pad_token_id=-1 if case == "eos_negative_pad" else 0)
    want = np.asarray(JL.generate(jp, jnp.asarray(ids), jcfg,
                                  max_new_tokens=new, **kw))
    got = TL.generate(tp, ids, tcfg, max_new_tokens=new, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, new)
    np.testing.assert_array_equal(got.numpy(), want)
    if case.startswith("eos"):
        assert (want[0, 3:] == kw["pad_token_id"]).all()


def test_generate_max_len_check(tiny):
    _, _, tcfg, tp = tiny
    with pytest.raises(TE.PreconditionNotMetError, match="max_len"):
        TL.generate(tp, _ids((1, 5)), tcfg, max_new_tokens=4, max_len=8)
    got = TL.generate(tp, _ids((1, 5)), tcfg, max_new_tokens=4, max_len=12)
    assert tuple(got.shape) == (1, 4)


@pytest.mark.parametrize("num_beams,length_penalty,eos", [
    (1, 0.0, False), (3, 0.0, False), (3, 1.0, False), (3, 0.0, True),
    (3, 1.0, True)])
def test_beam_search_matches_jax(tiny, num_beams, length_penalty, eos):
    """With EOS some beams freeze: their only continuation is the pad at
    zero score, which makes exact ties among the frozen totals."""
    jcfg, jp, tcfg, tp = tiny
    ids = _ids((2, 5), seed=4)
    kw = dict(max_new_tokens=5, num_beams=num_beams,
              length_penalty=length_penalty)
    if eos:
        plain = np.asarray(JL.generate(jp, jnp.asarray(ids), jcfg,
                                       max_new_tokens=5))
        kw.update(eos_token_id=int(plain[1, 1]), pad_token_id=-1)
    wt, ws = JL.beam_search(jp, jnp.asarray(ids), jcfg, **kw)
    gt, gs = TL.beam_search(tp, ids, tcfg, **kw)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)
    if num_beams == 1:
        np.testing.assert_array_equal(
            gt.numpy(), TL.generate(tp, ids, tcfg, max_new_tokens=5,
                                    **{k: v for k, v in kw.items()
                                       if k in ("eos_token_id",
                                                "pad_token_id")}).numpy())


def test_beam_search_no_tokens(tiny):
    jcfg, jp, tcfg, tp = tiny
    wt, ws = JL.beam_search(jp, jnp.asarray(_ids((2, 3))), jcfg,
                            max_new_tokens=0, num_beams=2)
    gt, gs = TL.beam_search(tp, _ids((2, 3)), tcfg, max_new_tokens=0,
                            num_beams=2)
    assert tuple(gt.shape) == (2, 0)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_top_k_stable_takes_ties_in_index_order():
    """The beam and router selection against ``lax.top_k`` on rows full
    of exact ties (frozen beams, -inf rows)."""
    x = np.array([[0.0, -np.inf, 0.0, 1.0, 0.0, -np.inf],
                  [-np.inf] * 6,
                  [2.0, 2.0, 2.0, 2.0, 1.0, 2.0]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 4)
    gv, gi = TL._top_k_stable(torch.as_tensor(x), 4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("width", ["int8", "int4"])
def test_generate_weight_only_trees_match_jax(tiny, width):
    jcfg, jp, tcfg, tp = tiny
    jq = JL.quantize_weights(jp, width)
    tq = TL.params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    ids = _ids((2, 6), seed=5)
    want = np.asarray(JL.generate(jq, jnp.asarray(ids), jcfg,
                                  max_new_tokens=5))
    np.testing.assert_array_equal(
        TL.generate(tq, ids, tcfg, max_new_tokens=5).numpy(), want)
    wt, _ = JL.beam_search(jq, jnp.asarray(ids), jcfg, max_new_tokens=4,
                           num_beams=2)
    gt, _ = TL.beam_search(tq, ids, tcfg, max_new_tokens=4, num_beams=2)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.6), (8, 0.5),
                                         (None, 1.0)])
def test_sampling_filter_holds_jax_draws(top_k, top_p):
    """Every token of 256 JAX draws (one key each) at temperature 0.8 lies
    in the set the port's filter keeps; the kept set is no larger than
    top-k asks."""
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(3, 64)) * 2).astype(np.float32)
    temp = 0.8
    sample = JL.make_sampler(temp, top_k=top_k, top_p=top_p)
    keys = jax.random.split(jax.random.PRNGKey(0), 256)
    draws = np.asarray(jax.vmap(lambda k: sample(jnp.asarray(logits), k))(
        keys))                                          # [256, 3]
    kept = torch.isfinite(TL.sampling_filter(
        torch.as_tensor(logits) / temp, top_k, top_p)).numpy()
    for row in range(3):
        assert kept[row, draws[:, row]].all(), row
        if top_k is not None:
            assert kept[row].sum() <= top_k
    if top_k is None and top_p == 1.0:
        assert kept.all()
    got = TL.make_sampler(temp, top_k=top_k, top_p=top_p)(
        torch.as_tensor(logits), torch.Generator().manual_seed(0))
    assert got.dtype == torch.int32
    assert kept[np.arange(3), got.numpy()].all()


def test_sampler_greedy_top_k_one_and_top_p_check():
    logits = torch.as_tensor(np.random.default_rng(7).normal(
        size=(4, 50)).astype(np.float32))
    arg = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.testing.assert_close(TL.make_sampler(0.0)(logits), arg)
    gen = torch.Generator().manual_seed(1)
    for _ in range(5):
        torch.testing.assert_close(
            TL.make_sampler(1.3, top_k=1)(logits, gen), arg)
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(TE.InvalidArgumentError, match="top_p"):
            TL.make_sampler(0.7, top_p=bad)


def test_sampled_generate_follows_its_generator(tiny):
    """The same seed gives the same draws; tokens lie in the top-k set of
    their step's logits (checked against the greedy path at top_k=1)."""
    _, _, tcfg, tp = tiny
    ids = _ids((2, 4), seed=8)
    a = TL.generate(tp, ids, tcfg, max_new_tokens=5, temperature=1.0,
                    top_k=20, generator=3)
    b = TL.generate(tp, ids, tcfg, max_new_tokens=5, temperature=1.0,
                    top_k=20, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b)
    one = TL.generate(tp, ids, tcfg, max_new_tokens=5, temperature=1.0,
                      top_k=1, generator=9)
    torch.testing.assert_close(one, TL.generate(tp, ids, tcfg,
                                                max_new_tokens=5))
