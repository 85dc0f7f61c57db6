"""Port parity: paged decode attention, the page allocator and the paged
prefill/decode data plane (``paddle_tpu_torch/inference/paged.py``).

Inputs come from ``np.random.default_rng(seed)`` and go to both packages;
weights are the JAX ``llama_tiny`` tree carried over through numpy.
Tolerances: float32 ``atol=1e-5`` (summation order only), bfloat16
``atol=2e-2`` on attention outputs and ``5e-2`` on logits (bf16 rounding
at different points in the two frameworks).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import paged as JP
from paddle_tpu.models import llama as JL
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.inference import paged as TP
from paddle_tpu_torch.kernels import paged_attention as TPA
from paddle_tpu_torch.models import llama as TL

JPA = importlib.import_module("paddle_tpu.kernels.paged_attention")

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _case(dt, *, B=4, nh=4, kv=2, hd=32, ps=8, P=12, maxp=4, seed=0):
    """Lengths: a partial last page, an empty slot, a page boundary, and
    a full table. Entries past each sequence's pages hold garbage: the
    sentinel P, negatives and values far past P."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, nh, hd)).astype(np.float32)
    kp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
    lengths = np.array([13, 0, 2 * ps, maxp * ps][:B], np.int32)
    bt = rng.integers(-5, 3 * P, (B, maxp)).astype(np.int32)
    bt[:, -1] = P                                     # sentinel column
    for b, n in enumerate(lengths):
        used = -(-int(n) // ps)
        bt[b, :used] = rng.permutation(P)[:used]
    return q, kp, vp, bt, lengths


def _both(arrs, dt):
    q, kp, vp, bt, ln = arrs
    j = (jnp.asarray(q, _JDT[dt]), jnp.asarray(kp, _JDT[dt]),
         jnp.asarray(vp, _JDT[dt]), jnp.asarray(bt), jnp.asarray(ln))
    t = (torch.as_tensor(q).to(_TDT[dt]), torch.as_tensor(kp).to(_TDT[dt]),
         torch.as_tensor(vp).to(_TDT[dt]), torch.as_tensor(bt),
         torch.as_tensor(ln))
    return j, t


@pytest.mark.parametrize("dt,ps,tol", [("float32", 8, 1e-5),
                                       ("bfloat16", 16, 2e-2)])
def test_paged_ref_matches_jax_kernel_interpret_and_ref(dt, ps, tol):
    (jq, jk, jv, jbt, jln), (tq, tk, tv, tbt, tln) = _both(
        _case(dt, ps=ps), dt)
    got = TPA.paged_attention_ref(tq, tk, tv, tbt, tln)
    kern = JPA.ragged_paged_attention(jq, jk, jv, jbt, jln, interpret=True)
    ref = JPA.paged_attention_ref(jq, jk, jv, jbt, jln)
    assert got.dtype == _TDT[dt]
    assert torch.isfinite(got.float()).all()
    assert torch.all(got[1] == 0)                      # length 0: zero row
    np.testing.assert_allclose(_np(got), _np(kern), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=0)


def test_paged_wrapper_on_cpu_takes_plain_version():
    _, (tq, tk, tv, tbt, tln) = _both(_case("float32", B=2), "float32")
    TK.reset_dispatch_stats()
    out = TK.dispatched_paged_attention(tq, tk, tv, tbt, tln)
    assert TK.dispatch_stats()["paged_ref"] == 1
    assert TK.dispatch_stats()["paged"] == 0
    torch.testing.assert_close(out, TPA.paged_attention_ref(tq, tk, tv,
                                                            tbt, tln))


def test_paged_supported_guard():
    q = torch.zeros(2, 8, 128)
    assert TPA.supported(q, torch.zeros(4, 2, 16, 128),
                         torch.zeros(2, 3, dtype=torch.int32))
    assert not TPA.supported(q, torch.zeros(4, 3, 16, 128),
                             torch.zeros(2, 3, dtype=torch.int32))
    assert not TPA.supported(torch.zeros(2, 8, 12), torch.zeros(4, 2, 16, 12),
                             torch.zeros(2, 3, dtype=torch.int32))
    assert not TPA.supported(torch.zeros(2, 32, 128),
                             torch.zeros(4, 2, 16, 128),
                             torch.zeros(2, 3, dtype=torch.int32))


class TestAllocatorLockstep:
    """The port's PageAllocator makes the reference's decisions: the same
    operations give the same pages, copy-on-write pairs and block rows."""

    def test_lockstep_with_reference(self):
        j = JP.PageAllocator(num_pages=8, page_size=4, max_pages_per_seq=4)
        t = TP.PageAllocator(num_pages=8, page_size=4, max_pages_per_seq=4)
        ops = [("alloc", 0, 6), ("alloc", 1, 3), ("advance", 0, 6),
               ("fork", 0, 2), ("ensure", 2, 9), ("advance", 2, 3),
               ("ensure", 0, 8), ("alloc", 3, 16), ("free", 1),
               ("alloc", 3, 5), ("free", 2), ("ensure", 3, 12),
               ("free", 0), ("free", 3)]
        for op, *args in ops:
            assert getattr(j, op)(*args) == getattr(t, op)(*args), op
            assert j.free_pages == t.free_pages
            for sid in list(t._seqs):
                np.testing.assert_array_equal(j.block_row(sid),
                                              t.block_row(sid))
            t.check_invariants()
        assert t.used_pages == 0

    def test_oom_returns_none_and_guards_raise(self):
        a = TP.PageAllocator(num_pages=3, page_size=4, max_pages_per_seq=3)
        assert a.alloc(0, 8) == [0, 1]
        assert a.alloc(1, 12) is None and a.free_pages == 1
        assert a.ensure(0, 12) == ([2], [])
        assert a.ensure(0, 12) == ([], [])
        with pytest.raises(TE.PreconditionNotMetError):
            a.alloc(0, 4)                              # already allocated
        with pytest.raises(TE.PreconditionNotMetError):
            a.advance(0, 13)                           # past capacity
        a.free(0)
        a.check_invariants()
        assert a.free_pages == 3

    def test_cow_copies_pool_pages(self):
        c = TP.PagedKVCache(TL.llama_tiny(), num_pages=6, page_size=4,
                            max_pages_per_seq=3, device="cpu")
        pages = c.alloc.alloc(0, 6)
        c.pool["k"][:, pages[1]] = 7.0
        c.alloc.advance(0, 6)
        c.alloc.fork(0, 1)
        _, cow = c.alloc.ensure(1, 7)
        c.apply_cow(cow)
        dst = c.alloc.seq_pages(1)[1]
        assert dst != pages[1]
        assert torch.all(c.pool["k"][:, dst] == 7.0)


def _tiny(dt):
    jcfg = JL.llama_tiny(dtype=_JDT[dt])
    jp = JL.init_params(jcfg, jax.random.PRNGKey(3))
    tp = TL.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, TL.llama_tiny(dtype=_TDT[dt]), tp


@pytest.mark.parametrize("dt,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_prefill_then_decode_logits_and_pool_match_jax(dt, tol):
    """A group of four rows is prefilled into the pool: two prompts that
    end inside a page, an all-sentinel dummy row, and a row whose second
    page is the sentinel. Then two decode steps run over the slot grid
    with one inactive slot. Logits and every pool page agree."""
    jcfg, jp, tcfg, tp = _tiny(dt)
    ps, P, maxp, S = 4, 10, 4, 8
    rng = np.random.default_rng(11)
    ids = rng.integers(0, jcfg.vocab_size, (4, S)).astype(np.int32)
    slen = np.array([7, 5, 1, 1], np.int32)
    ids[0, 7:] = 0
    ids[1, 5:] = 0
    rows = np.full((4, S // ps), P, np.int32)
    rows[0] = [3, 8]
    rows[1] = [1, 6]
    rows[3] = [0, P]
    jk = jnp.zeros((2, P, 2, ps, 16), _JDT[dt])
    jv = jnp.zeros_like(jk)
    jk, jv, jlog = JP.paged_prefill(JL, jp, jnp.asarray(ids), jcfg, jk, jv,
                                    jnp.asarray(rows), jnp.asarray(slen))
    pool = TP.init_pool(tcfg, P, ps, device="cpu")
    tlog = TP.paged_prefill(TL, tp, torch.as_tensor(ids).long(), tcfg,
                            pool["k"], pool["v"],
                            torch.as_tensor(rows).long(),
                            torch.as_tensor(slen))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(_np(pool["k"]), _np(jk), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(pool["v"]), _np(jv), atol=tol, rtol=0)

    bt = np.full((3, maxp), P, np.int32)
    bt[0, :2], bt[1, :2] = [3, 8], [1, 6]
    bt[0, 2], bt[1, 2] = 5, 2                # the next page of each
    lengths = np.array([8, 6, 0], np.int32)
    toks = np.array([17, 200, 3], np.int32)
    for _ in range(2):
        jk, jv, jlog = JP.paged_decode_step(
            JL, jp, jk, jv, jnp.asarray(bt), jnp.asarray(lengths),
            jnp.asarray(toks), jcfg)
        tlog = TP.paged_decode_step(TL, tp, pool["k"], pool["v"],
                                    torch.as_tensor(bt),
                                    torch.as_tensor(lengths),
                                    torch.as_tensor(toks).long(), tcfg)
        live = lengths > 0
        np.testing.assert_allclose(tlog.numpy()[live],
                                   np.asarray(jlog)[live], atol=tol, rtol=0)
        np.testing.assert_allclose(_np(pool["k"]), _np(jk), atol=tol, rtol=0)
        np.testing.assert_allclose(_np(pool["v"]), _np(jv), atol=tol, rtol=0)
        toks = np.asarray(jlog).argmax(-1).astype(np.int32)
        lengths = np.where(live, lengths + 1, 0).astype(np.int32)
