"""Port parity: the rest of the paged data plane (``inference/paged.py``):
``_kv_pool_gather``, ``paged_prefill_shared`` and ``paged_verify_window``,
each against the JAX package on the same numpy inputs, for float32 pools
and int8 pools (codes with per-page scales).

Weights are one float32 ``llama_tiny`` tree (``PRNGKey(0)``) carried over
through numpy. The port's pools have a sink page past the ``P`` usable
ones; here it holds large finite garbage, which a sentinel entry of a
block table makes the port read where JAX reads page ``P - 1``: the
attention mask must keep both out of every compared result. Tolerances,
float32 throughout: logits ``1e-5`` of their largest magnitude
(summation order); full-precision pool pages ``1e-6``; int8 codes equal
except at most 0.1% off by one (float32 noise at a .5 boundary) and
scales ``1e-6`` relative; the gather exactly equal (the same products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import paged as JP
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.inference import paged as TP
from paddle_tpu_torch.models import llama as TL

PS, P = 8, 16
SINK_GARBAGE = 1e3


@pytest.fixture(scope="module")
def tiny():
    jcfg = JL.llama_tiny()
    jp = JL.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TL.llama_tiny(), tp


def _pools(cfg, quant, seed):
    """One pool pair ``(jax, port)`` with the same random contents in the
    ``P`` usable pages; the port's sink page holds large finite
    garbage."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_hidden_layers, P, cfg.num_key_value_heads, PS,
             cfg.head_dim)

    def leaf():
        if quant:
            q = rng.integers(-127, 128, shape).astype(np.int8)
            s = (rng.random(shape[:3]) * 0.02 + 1e-3).astype(np.float32)
            return {"q": q, "s": s}
        return rng.normal(size=shape).astype(np.float32)

    def port(a):
        sink = np.full((a.shape[0], 1) + a.shape[2:],
                       127 if a.dtype == np.int8 else SINK_GARBAGE, a.dtype)
        return torch.as_tensor(np.concatenate([a, sink], axis=1))

    np_pool = {"k": leaf(), "v": leaf()}
    jpool = jax.tree.map(jnp.asarray, np_pool)
    tpool = jax.tree.map(port, np_pool)
    return jpool, tpool


def _usable(leaf):
    if isinstance(leaf, dict):
        return {k: v[:, :P].numpy() for k, v in leaf.items()}
    return leaf[:, :P].numpy()


def _same_pool(tleaf, jleaf):
    if isinstance(tleaf, dict):
        got, want = _usable(tleaf), jax.tree.map(np.asarray, jleaf)
        diff = np.abs(got["q"].astype(np.int32) - want["q"].astype(np.int32))
        assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size
        np.testing.assert_allclose(got["s"], want["s"], rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(_usable(tleaf), np.asarray(jleaf),
                                   rtol=0, atol=1e-6)


def _close_logits(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_kv_pool_gather_matches_jax(tiny, quant):
    """Rows of any shape, sentinel entries included: every non-sentinel
    row equal to JAX's; the sentinel reads the sink (finite garbage)."""
    jcfg, _, tcfg, _ = tiny
    jpool, tpool = _pools(tcfg, quant, seed=1)
    rows = np.array([[0, 5, P], [P, 15, 3]], np.int32)
    for name in ("k", "v"):
        jleaf = jax.tree.map(lambda a: a[1], jpool[name])
        tleaf = TP._layer_leaf(tpool[name], 1)
        want = np.asarray(JP._kv_pool_gather(jleaf, jnp.asarray(rows),
                                             jnp.float32))
        got = TP._kv_pool_gather(tleaf, torch.as_tensor(rows).long(),
                                 torch.float32)
        assert got.shape == want.shape == (2, 3, 2, PS, 16)
        real = rows < P
        np.testing.assert_array_equal(got.numpy()[real], want[real])
        assert torch.isfinite(got).all()
    bf = TP._kv_pool_gather(TP._layer_leaf(tpool["k"], 0),
                            torch.as_tensor(rows).long(), torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def _shared_case(cfg):
    """Three rows over one cached prefix of two pages (pages 0 and 1):
    a full tail of two pages, a tail of 7 tokens whose second page is the
    sentinel, and a group-padding dummy row of sentinel pages."""
    rng = np.random.default_rng(5)
    S = 2 * PS
    ids = rng.integers(0, cfg.vocab_size, (3, S)).astype(np.int32)
    slen = np.array([S, 7, 1], np.int32)
    ids[1, 7:] = 0
    ctx_rows = np.array([[0, 1]] * 3, np.int32)
    page_rows = np.array([[2, 3], [4, P], [P, P]], np.int32)
    return ids, slen, ctx_rows, page_rows


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_prefill_shared_matches_jax(tiny, quant):
    jcfg, jp, tcfg, tp = tiny
    jpool, tpool = _pools(tcfg, quant, seed=2)
    ids, slen, ctx_rows, page_rows = _shared_case(tcfg)
    jk, jv, jlog = JP.paged_prefill_shared(
        JL, jp, jnp.asarray(ids), jcfg, jpool["k"], jpool["v"],
        jnp.asarray(page_rows), jnp.asarray(slen), jnp.asarray(ctx_rows))
    tlog = TP.paged_prefill_shared(
        TL, tp, torch.as_tensor(ids).long(), tcfg, tpool["k"], tpool["v"],
        torch.as_tensor(page_rows).long(), torch.as_tensor(slen),
        torch.as_tensor(ctx_rows).long())
    _close_logits(tlog.numpy(), jlog)
    _same_pool(tpool["k"], jk)
    _same_pool(tpool["v"], jv)


def test_prefill_shared_matches_the_full_prefill(tiny):
    """Prompts of prefix ++ tail through one ``paged_prefill`` against the
    prefix through ``paged_prefill`` and the tails through
    ``paged_prefill_shared`` over its pages: the same logits and the same
    tail pages."""
    _, _, cfg, tp = tiny
    rng = np.random.default_rng(6)
    ctx, S = 2 * PS, 2 * PS
    prefix = rng.integers(0, cfg.vocab_size, ctx)
    tails = rng.integers(0, cfg.vocab_size, (2, S))
    full = torch.as_tensor(np.concatenate(
        [np.tile(prefix, (2, 1)), tails], axis=1)).long()
    slen = torch.tensor([ctx + S, ctx + 5])
    pool = TP.init_pool(cfg, P, PS, device="cpu")
    want = TP.paged_prefill(TL, tp, full, cfg, pool["k"], pool["v"],
                            torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]]),
                            slen)
    shared = TP.init_pool(cfg, P, PS, device="cpu")
    TP.paged_prefill(TL, tp, full[:1, :ctx], cfg, shared["k"], shared["v"],
                     torch.tensor([[0, 1]]), torch.tensor([ctx]))
    got = TP.paged_prefill_shared(
        TL, tp, full[:, ctx:], cfg, shared["k"], shared["v"],
        torch.tensor([[2, 3], [6, 7]]), slen - ctx,
        torch.tensor([[0, 1], [0, 1]]))
    _close_logits(got.numpy(), want.numpy())
    for name in ("k", "v"):
        np.testing.assert_allclose(shared[name][:, [2, 3, 6, 7]].numpy(),
                                   pool[name][:, [2, 3, 6, 7]].numpy(),
                                   rtol=0, atol=1e-5)


def _verify_case():
    """Four rows of a window of C = 5 over tables of 4 pages: a window
    inside one page, one that crosses a page edge, a dead row (its pages
    real, its writes dropped) and a dead row of sentinel pages."""
    bt = np.full((4, 4), P, np.int32)
    bt[0, :2] = [0, 1]
    bt[1, :3] = [2, 3, 4]
    bt[2, :2] = [5, 6]
    kv_len = np.array([1, 12, 9, 3], np.int32)
    live = np.array([True, True, False, False])
    return bt, kv_len, live


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_verify_window_matches_jax(tiny, quant):
    jcfg, jp, tcfg, tp = tiny
    jpool, tpool = _pools(tcfg, quant, seed=3)
    bt, kv_len, live = _verify_case()
    toks = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (4, 5)).astype(np.int32)
    jk, jv, jlog = JP.paged_verify_window(
        JL, jp, jnp.asarray(toks), jcfg, jpool["k"], jpool["v"],
        jnp.asarray(bt), jnp.asarray(kv_len), jnp.asarray(live))
    tlog = TP.paged_verify_window(
        TL, tp, torch.as_tensor(toks).long(), tcfg, tpool["k"], tpool["v"],
        torch.as_tensor(bt), torch.as_tensor(kv_len), torch.as_tensor(live))
    assert tlog.shape == (4, 5, tcfg.vocab_size)
    # rows 0-2 read real pages only (row 3 reads the sink, JAX page P - 1)
    _close_logits(tlog.numpy()[:3], np.asarray(jlog)[:3])
    _same_pool(tpool["k"], jk)
    _same_pool(tpool["v"], jv)


def test_verify_window_greedy_equals_sequential_decode(tiny):
    """Prompts prefilled into float32 pages, then C = 4 greedy
    ``paged_decode_step``s on one copy of the pool and one
    ``paged_verify_window`` of the same tokens on another: the window's
    argmax gives the sequential tokens, token for token, and its logits
    the sequential logits. (On int8 pages the sequential appends round a
    page again at every token and the window once, so only float32 is
    exact, as in the reference.)"""
    _, _, cfg, tp = tiny
    C = 4
    rng = np.random.default_rng(8)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 2 * PS))).long()
    slen = torch.tensor([13, 16, 6])
    rows = torch.tensor([[0, 1], [3, 4], [6, P]])
    bt = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, P]], dtype=torch.int32)
    pool = TP.init_pool(cfg, P, PS, device="cpu")
    logits = TP.paged_prefill(TL, tp, ids, cfg, pool["k"], pool["v"], rows,
                              slen)
    window = jax.tree.map(torch.clone, pool)
    tok = logits.argmax(-1)
    drafted, seq_logits, n = [tok], [], slen.clone()
    for _ in range(C):
        n = n + 1
        out = TP.paged_decode_step(TL, tp, pool["k"], pool["v"], bt,
                                   n.int(), drafted[-1], cfg)
        seq_logits.append(out)
        drafted.append(out.argmax(-1))
    got = TP.paged_verify_window(
        TL, tp, torch.stack(drafted[:C], 1), cfg, window["k"], window["v"],
        bt, slen.int(), torch.ones(3, dtype=torch.bool))
    assert torch.equal(got.argmax(-1), torch.stack(drafted[1:], 1))
    _close_logits(got.numpy(), torch.stack(seq_logits, 1).numpy())
