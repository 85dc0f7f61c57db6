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


def _chip_smoke():
    """``chip_smoke.py`` at the repo root, imported by path."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_paged", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("pdt", ["bfloat16", "float16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rounded_p_reference_matches_jax_kernel_interpret(pdt, seed):
    """``chip_smoke.paged_ref_round_p``, the reference the card's mixed
    pairs are held to, against the Pallas kernel in interpret mode:
    float32 q over 2-byte pages, sequences of at most one page (there the
    kernel's running max is the row's max), within 1e-5 (float32
    summation order). The plain version, which keeps p float32, is off
    by the rounding, more than ten times that."""
    rng = np.random.default_rng(seed)
    B, nh, kv, hd, ps, P, maxp = 4, 8, 2, 64, 32, 6, 2
    q = rng.normal(size=(B, nh, hd)).astype(np.float32)
    kp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
    ln = np.array([13, 0, ps, 27], np.int32)
    bt = rng.integers(-5, 3 * P, (B, maxp)).astype(np.int32)
    bt[:, 0] = rng.permutation(P)[:B]
    kern = np.asarray(JPA.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp, getattr(jnp, pdt)),
        jnp.asarray(vp, getattr(jnp, pdt)), jnp.asarray(bt),
        jnp.asarray(ln), interpret=True))
    args = (torch.as_tensor(q), torch.as_tensor(kp).to(getattr(torch, pdt)),
            torch.as_tensor(vp).to(getattr(torch, pdt)), torch.as_tensor(bt),
            torch.as_tensor(ln))
    got = _chip_smoke().paged_ref_round_p(torch, *args)
    assert got.dtype == torch.float32 and torch.all(got[1] == 0)
    np.testing.assert_allclose(got.numpy(), kern, atol=1e-5, rtol=0)
    plain = TPA.paged_attention_ref(*args).numpy()
    assert np.abs(plain - kern).max() > 1e-4


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
    np.testing.assert_allclose(_np(pool["k"][:, :P]), _np(jk), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(pool["v"][:, :P]), _np(jv), atol=tol, rtol=0)

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
        np.testing.assert_allclose(_np(pool["k"][:, :P]), _np(jk), atol=tol, rtol=0)
        np.testing.assert_allclose(_np(pool["v"][:, :P]), _np(jv), atol=tol, rtol=0)
        toks = np.asarray(jlog).argmax(-1).astype(np.int32)
        lengths = np.where(live, lengths + 1, 0).astype(np.int32)


# -- the decode kernel's split plan (flash-decoding) ------------------------

CSRC = TPA.__file__.rsplit("/kernels/", 1)[0] + "/csrc/paged_decode.cu"


@pytest.mark.parametrize("ps", [1, 16, 32, 64])
@pytest.mark.parametrize("B,kv,positions", [(1, 8, 2048), (8, 8, 2048),
                                             (32, 8, 2048), (2, 1, 48),
                                             (5, 2, 96), (3, 4, 4096)])
def test_decode_split_plan_rules(ps, B, kv, positions):
    """Chunks of whole pages, at least one page, at most MAX_SPLIT_PAGES
    and about SPLIT_POSITIONS positions (halved, not below
    MIN_SPLIT_POSITIONS, while the grid is small); the splits cover the
    table and none lies wholly past it; the grid fits CUDA's limits."""
    maxp = max(1, positions // ps)
    pps, splits = TPA.decode_split_plan(B, kv, ps, maxp)
    assert 1 <= pps <= min(maxp, TPA.MAX_SPLIT_PAGES)
    assert splits * pps >= maxp and (splits - 1) * pps < maxp
    chunk = pps * ps
    assert chunk <= max(TPA.SPLIT_POSITIONS, ps)
    if pps < min(maxp, TPA.SPLIT_POSITIONS // ps):      # it was halved
        assert chunk >= TPA.MIN_SPLIT_POSITIONS or pps == 1
        assert B * kv * -(-maxp // (2 * pps)) < TPA.TARGET_BLOCKS
    assert splits < 2 ** 31 and B * kv <= 65535 * 65535


@pytest.mark.parametrize("B,ps,maxp,want", [(8, 16, 128, (8, 16)),
                                            (8, 32, 64, (4, 16)),
                                            (16, 16, 128, (16, 8)),
                                            (32, 16, 128, (32, 4)),
                                            (32, 32, 64, (16, 4)),
                                            (1, 16, 128, (4, 32)),
                                            (1, 32, 64, (2, 32))])
def test_decode_split_plan_at_serving_shapes(B, ps, maxp, want):
    """The serving tables (2048 positions, 8 kv heads, bf16 pages of 16
    and int8 pages of 32): 128-position chunks at the main path's B 8,
    512 at B 32, 64 for one sequence, so the grid holds more blocks than
    the H100 has SMs (132) even at B 1."""
    plan = TPA.decode_split_plan(B, 8, ps, maxp)
    assert plan == want
    assert B * 8 * plan[1] > 132


def test_decode_split_constants_match_the_source():
    text = open(CSRC).read()
    assert f"MAX_SPLIT_PAGES = {TPA.MAX_SPLIT_PAGES};" in text
    # the combine pass and the split kernel share one name stem, which
    # the serving profile classes as decode time
    assert "paged_decode_kernel(" in text
    assert "paged_decode_combine_kernel(" in text


def _split_combine(q, kp, vp, bt, lengths, pps, k_scales=None,
                   v_scales=None):
    """A plain model of the kernel's split-then-combine: each chunk of
    ``pps`` pages gives its own running max ``m_i``, sum ``l_i`` and
    unnormalised ``acc_i`` (an empty chunk: ``-inf``, 0, 0); then ``out
    = sum_i e^(m_i - m) acc_i / sum_i e^(m_i - m) l_i``. int8 scales fold
    as in the kernel: the k scale multiplies a page's scores, the v
    scale its probabilities."""
    B, nh, hd = q.shape
    P, kv, ps, _ = kp.shape
    maxp = bt.shape[1]
    g = nh // kv
    idx = bt.clamp(0, P - 1).long()
    k = kp[idx].float()                               # [B, maxp, kv, ps, hd]
    v = vp[idx].float()
    s = torch.einsum("bkgd,bmkpd->bkgmp", q.float().reshape(B, kv, g, hd),
                     k) / np.sqrt(hd)
    vsc = torch.ones(B, kv, 1, maxp, 1)
    if k_scales is not None:
        s = s * k_scales[idx].permute(0, 2, 1)[:, :, None, :, None]
        vsc = v_scales[idx].permute(0, 2, 1)[:, :, None, :, None]
    pos = torch.arange(maxp * ps).reshape(maxp, ps)
    ms, ls, accs = [], [], []
    for first in range(0, maxp, pps):
        live = (pos < lengths.long()[:, None, None]) & \
            (pos >= first * ps) & (pos < (first + pps) * ps)
        live = live[:, None, None]                    # [B, 1, 1, maxp, ps]
        sc = torch.where(live, s, -torch.inf)
        m = sc.amax(dim=(-2, -1), keepdim=True)
        mu = torch.where(torch.isinf(m), 0.0, m)
        p = torch.where(live, torch.exp(sc - mu), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=(-2, -1), keepdim=True))
        accs.append(torch.einsum("bkgmp,bmkpd->bkgd", p * vsc, v))
    m = torch.stack(ms).amax(0)
    mu = torch.where(torch.isinf(m), 0.0, m)
    w = [torch.where(torch.isinf(mi), 0.0, torch.exp(mi - mu)) for mi in ms]
    den = sum(wi * li for wi, li in zip(w, ls))[..., 0]
    num = sum(wi[..., 0] * ai for wi, ai in zip(w, accs))
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out.reshape(B, nh, hd).to(q.dtype)


def _split_case(dt, ps=16, maxp=32, seed=4):
    """Lengths 0, 1, chunk - 1, chunk, chunk + 1 and the full table, the
    chunk of ``decode_split_plan`` at this shape (64 positions, 8
    splits): four rows whose every split past the first is empty."""
    B, nh, kv, hd = 6, 4, 2, 32
    pps, splits = TPA.decode_split_plan(B, kv, ps, maxp)
    c = pps * ps
    rng = np.random.default_rng(seed)
    P = maxp * 3
    q = rng.normal(size=(B, nh, hd)).astype(np.float32)
    kp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
    lengths = np.array([0, 1, c - 1, c, c + 1, maxp * ps], np.int32)
    bt = rng.integers(-5, 3 * P, (B, maxp)).astype(np.int32)
    for b, n in enumerate(lengths):
        used = -(-int(n) // ps)
        bt[b, :used] = rng.permutation(P)[:used]
    return (q, kp, vp, bt, lengths), pps, splits


@pytest.mark.parametrize("dt,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_split_combine_model_matches_jax_kernel_interpret_and_ref(dt, tol):
    arrs, pps, splits = _split_case(dt)
    assert splits == 8 and pps * 16 == 64
    (jq, jk, jv, jbt, jln), (tq, tk, tv, tbt, tln) = _both(arrs, dt)
    got = _split_combine(tq, tk, tv, tbt, tln, pps)
    kern = JPA.ragged_paged_attention(jq, jk, jv, jbt, jln, interpret=True)
    ref = JPA.paged_attention_ref(jq, jk, jv, jbt, jln)
    assert torch.isfinite(got.float()).all()
    assert torch.all(got[0] == 0)                      # length 0: zero row
    np.testing.assert_allclose(_np(got), _np(kern), atol=tol, rtol=0)
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=0)
    np.testing.assert_allclose(
        _np(got), _np(TPA.paged_attention_ref(tq, tk, tv, tbt, tln)),
        atol=tol, rtol=0)


@pytest.mark.parametrize("q_shape,q_dt,pages,p_dt,bt_shape,quant,want", [
    ((2, 8, 128), torch.float32, (4, 2, 16, 128), torch.float32, (2, 3),
     False, True),
    ((2, 8, 128), torch.float32, (4, 3, 16, 128), torch.float32, (2, 3),
     False, False),                                   # heads % kv
    ((2, 8, 12), torch.float32, (4, 2, 16, 12), torch.float32, (2, 3),
     False, False),                                   # head_dim % 8
    ((2, 32, 128), torch.float32, (4, 2, 16, 128), torch.float32, (2, 3),
     False, False),                                   # group * D > 1024
    ((2, 16, 128), torch.bfloat16, (4, 2, 16, 128), torch.bfloat16, (2, 3),
     False, True),                                    # group * D = 1024
    ((2, 4, 136), torch.float32, (4, 2, 16, 136), torch.float32, (2, 3),
     False, False),                                   # head_dim > 128
    ((1, 4, 8), torch.bfloat16, (3, 2, 1, 8), torch.bfloat16, (1, 5),
     False, True),                                    # ps 1, head_dim 8
    ((3, 6, 24), torch.float32, (9, 2, 3, 24), torch.float32, (3, 30),
     False, True),                                    # odd ps and D / 8
    ((2, 4, 32), torch.float32, (4, 1, 300, 32), torch.float32, (2, 2),
     False, True),                                    # ps above 256
    ((2, 64, 16), torch.float32, (4, 1, 16, 16), torch.float32, (2, 3),
     False, True),                                    # group 64
    ((2, 8, 128), torch.float16, (4, 2, 16, 128), torch.float16, (2, 3),
     False, False),                                   # float16
    ((2, 8, 128), torch.bfloat16, (4, 2, 16, 128), torch.float64, (2, 3),
     False, False),                                   # float64 pages
    ((2, 8, 128), torch.float32, (4, 2, 16, 128), torch.int8, (2, 3),
     True, True),                                     # int8, ps 16
    ((2, 8, 40), torch.bfloat16, (4, 2, 64, 40), torch.int8, (2, 3),
     True, True),                                     # int8, D % 16 != 0
    ((2, 8, 128), torch.float32, (4, 2, 16, 128), torch.int8, (2, 3),
     False, False),                                   # int8, no scales
    ((2, 8, 128), torch.float32, (4, 2, 16, 128), torch.float32, (2, 3),
     True, False),                                    # scales, no int8
    ((2, 8, 128), torch.float32, (4, 2, 16, 128), torch.float32, (3, 3),
     False, False),                                   # table rows != B
    ((2, 8, 128), torch.float32, (4, 2, 16, 128), torch.float32, (2, 0),
     False, False),                                   # empty table
    ((2, 8, 128), torch.bfloat16, (4, 2, 16, 128), torch.float32, (2, 3),
     False, True),                                    # float32 pages, bf16 q
    ((2, 8, 128), torch.float32, (4, 2, 16, 128), torch.bfloat16, (2, 3),
     False, True),                                    # bf16 pages, f32 q
    ((2, 8, 64), torch.float32, (4, 2, 16, 64), torch.float16, (2, 3),
     False, True),                                    # float16 pages
    ((2, 8, 24), torch.bfloat16, (4, 2, 8, 24), torch.float16, (2, 3),
     False, True),                                    # float16, bf16 q
    ((2, 8, 128), torch.float16, (4, 2, 16, 128), torch.float32, (2, 3),
     False, False),                                   # float16 q
])
def test_supported_takes_the_same_shapes(q_shape, q_dt, pages, p_dt,
                                         bt_shape, quant, want):
    """The split kernel takes exactly the shapes the kernel before it
    took: any page size, head_dim % 8 == 0 up to 128, group * head_dim
    <= 1024, float32 / bfloat16 q with pages of float32, bfloat16 or
    float16 (the Pallas kernel's page types), or int8 pages with
    scales."""
    assert TPA.supported(torch.zeros(q_shape, dtype=q_dt),
                         torch.zeros(pages, dtype=p_dt),
                         torch.zeros(bt_shape, dtype=torch.int32),
                         quant=quant) is want


def test_launch_passes_the_split_plan_and_scratch(monkeypatch):
    """The wrapper hands the C entry the plan's pages_per_split and a
    float32 scratch of splits * B * heads * (head_dim + 2) values (none
    with one split); a nonzero return raises."""
    calls = []

    class Lib:
        def paged_decode(self, *a):
            calls.append(a)
            return self.rc

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    made = []
    empty = torch.empty

    def spy_empty(*a, **kw):
        t = empty(*a, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", spy_empty)
    lib = Lib()
    lib.rc = 0
    for B, maxp in ((3, 32), (3, 2)):
        q = torch.zeros(B, 8, 64)
        kp = torch.zeros(70, 2, 16, 64)
        bt = torch.zeros(B, maxp, dtype=torch.int32)
        ln = torch.zeros(B, dtype=torch.int32)
        made.clear()
        TPA._launch(lib, q, kp, kp, bt, ln, torch.empty_like(q), 0.125)
        pps, splits = TPA.decode_split_plan(B, 2, 16, maxp)
        a = calls[-1]
        assert a[6:15] == (a[6], B, 8, 2, 16, 64, 70, maxp, pps)
        assert a[16:18] == (0, 0)            # q and page type codes
        if splits > 1:
            scratch = [t for t in made if t.data_ptr() == a[6]]
            assert scratch and scratch[0].dtype == torch.float32
            assert scratch[0].numel() == splits * B * 8 * (64 + 2)
        else:
            assert a[6] is None
    for qdt, pdt, codes in ((torch.bfloat16, torch.float32, (1, 0)),
                            (torch.float32, torch.bfloat16, (0, 1)),
                            (torch.bfloat16, torch.float16, (1, 2))):
        TPA._launch(lib, q.to(qdt), kp.to(pdt), kp.to(pdt), bt, ln,
                    torch.empty_like(q.to(qdt)), 0.125)
        assert calls[-1][16:18] == codes
    lib.rc = 1
    with pytest.raises(TE.UnavailableError):
        TPA._launch(lib, q, kp, kp, bt, ln, torch.empty_like(q), 0.125)
