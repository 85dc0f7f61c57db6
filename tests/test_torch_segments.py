"""Port parity: segment-masked (sequence-packed) flash attention.

The same numpy inputs go through the JAX package's Pallas
``flash_attention_segments`` in interpret mode (tiles of 32 x 32, the
CUDA kernels' own) and ``jax.vjp`` of it, and through the port's plain
versions ``segment_attention_ref`` / ``segment_attention_bwd_ref``, which
the port's wrappers run for CPU tensors. Tolerances: float32 forward
``rtol=atol=1e-5`` (summation order only); float32 gradients
``rtol=1e-4, atol=5e-4`` (the reference's own, ``tests/test_packing.py``);
bfloat16 forward ``3e-2`` (one bf16 rounding of p before the reference's
p.v product, which the port keeps in float32).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import attention as JATT
from paddle_tpu_torch import kernels as TK
from paddle_tpu_torch.kernels import flash_attention as TFA
from paddle_tpu_torch.nn.functional import attention as TATT

JFA = importlib.import_module("paddle_tpu.kernels.flash_attention")


def _rows(rows, s):
    """(segment_ids, positions) [B, S] int32 from per-row document
    lengths; the rest of each row is padding (-1)."""
    seg = np.full((len(rows), s), -1, np.int32)
    pos = np.zeros((len(rows), s), np.int32)
    for r, lens in enumerate(rows):
        o = 0
        for i, n in enumerate(lens):
            seg[r, o:o + n] = i
            pos[r, o:o + n] = np.arange(n)
            o += n
    return seg, pos


def _noncontiguous(b, s, seed=9):
    """Random segment ids (padding included) and positions per token: the
    tile predicate is only conservative here, never exact."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 3, (b, s)).astype(np.int32),
            rng.integers(0, s, (b, s)).astype(np.int32))


def _cu_layout():
    """``Sq != Sk``: q and k sides from different ``cu_seqlens`` (64
    query tokens, 96 keys, both with a padding tail)."""
    cq, ck = np.array([0, 20, 50]), np.array([0, 30, 80])
    segs = []
    for cu, t in ((cq, 64), (ck, 96)):
        seg = TATT.segment_ids_from_cu_seqlens(torch.as_tensor(cu), t)
        pos = TATT._local_positions(torch.as_tensor(cu), seg, t)
        segs += [seg.numpy().astype(np.int32)[None],
                 pos.numpy().astype(np.int32)[None]]
    sq, pq, sk, pk = segs
    return sq, sk, pq, pk


def _layout(name):
    """(seg_q, seg_k, pos_q, pos_k) numpy [B, S] of a named layout."""
    if name == "cross":       # documents across tile edges, padding tail,
        seg, pos = _rows([[50, 40, 30], [128]], 128)   # a full-row doc
    elif name == "aligned":   # tile-aligned documents: skippable tiles
        seg, pos = _rows([[32, 64, 32], [64, 64]], 128)
    elif name == "padtail":   # the reference's grad layout
        seg, pos = _rows([[30, 20, 10], [40, 24]], 64)
    elif name == "noncontig":
        seg, pos = _noncontiguous(2, 64)
    elif name == "sq_ne_sk":
        return _cu_layout()
    return seg, seg, pos, pos


def _qkv(seed, b, sq, sk, H=4, KVH=2, D=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, H, D)).astype(np.float32),
            rng.normal(size=(b, sk, KVH, D)).astype(np.float32),
            rng.normal(size=(b, sk, KVH, D)).astype(np.float32),
            rng.normal(size=(b, sq, H, D)).astype(np.float32))


def _jax_out_and_grads(q, k, v, dout, segs, causal, dtype=jnp.float32):
    def f(q, k, v):
        return JFA.flash_attention_segments(
            q, k, v, *segs, causal=causal, interpret=True, block_q=32,
            block_k=32)
    out, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                         for g in vjp(jnp.asarray(dout,
                                                                  dtype))]


def _port(q, k, v, dout, segs, causal):
    t = [torch.as_tensor(a) for a in (q, k, v, dout)]
    ts = [torch.as_tensor(a) for a in segs]
    out, lse = TFA.segment_attention_ref(*t[:3], *ts, causal=causal)
    grads = TFA.segment_attention_bwd_ref(*t[:3], out, lse, t[3], *ts,
                                          causal=causal)
    return out, lse, grads


@pytest.mark.parametrize("layout,causal", [
    ("cross", True), ("cross", False), ("aligned", True),
    ("padtail", True), ("noncontig", True), ("sq_ne_sk", True)])
def test_plain_versions_match_jax_kernel_and_vjp(layout, causal):
    segs = _layout(layout)
    b, sq = segs[0].shape
    q, k, v, dout = _qkv(0, b, sq, segs[1].shape[1])
    want_out, want_g = _jax_out_and_grads(q, k, v, dout, segs, causal)
    out, lse, grads = _port(q, k, v, dout, segs, causal)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=5e-4)
    # padding rows: exact zeros in out and dq, lse -inf; padding keys:
    # exact zero dk / dv
    pad_q = torch.as_tensor(segs[0] < 0)
    pad_k = torch.as_tensor(segs[1] < 0)
    assert torch.all(out[pad_q] == 0) and torch.all(grads[0][pad_q] == 0)
    assert torch.all(lse.transpose(1, 2)[pad_q] == float("-inf"))
    assert torch.all(grads[1][pad_k] == 0) and torch.all(grads[2][pad_k] == 0)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_bf16_forward_matches_jax_kernel():
    segs = _layout("cross")
    q, k, v, dout = _qkv(1, 2, 128, 128)
    want, _ = _jax_out_and_grads(q, k, v, dout, segs, True, jnp.bfloat16)
    t = [torch.as_tensor(a).bfloat16() for a in (q, k, v)]
    out, _ = TFA.segment_attention_ref(
        *t, *(torch.as_tensor(a) for a in segs), causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


def test_single_document_row_equals_dense_flash():
    """One full-row document is dense causal attention: the segment
    plain versions equal the dense ones."""
    q, k, v, dout = _qkv(2, 2, 96, 96)
    t = [torch.as_tensor(a) for a in (q, k, v, dout)]
    seg = torch.zeros(2, 96, dtype=torch.int32)
    pos = torch.arange(96).expand(2, 96)
    out, lse, grads = _port(q, k, v, dout, (seg, seg, pos, pos), True)
    dout_, dlse = TFA.flash_attention_ref(*t[:3], causal=True)
    torch.testing.assert_close(out, dout_, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, dlse, rtol=1e-5, atol=1e-5)
    dgrads = TFA.flash_attention_bwd_ref(*t[:3], dout_, dlse, t[3],
                                         causal=True)
    for g, w in zip(grads, dgrads):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_function_gradients_equal_plain_backward():
    """``flash_attention_segments`` with inputs that need a gradient goes
    through ``_FlashSegAttention``; on CPU tensors both wrappers take the
    plain versions, counted ``varlen_ref`` / ``varlen_bwd_ref``."""
    segs = _layout("padtail")
    q, k, v, dout = _qkv(3, 2, 64, 64)
    ts = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    TK.reset_dispatch_stats()
    out = TFA.flash_attention_segments(
        *ts, *(torch.as_tensor(a) for a in segs), causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ts, torch.as_tensor(dout))
    stats = TK.dispatch_stats()
    assert stats["varlen_ref"] == 1 and stats["varlen_bwd_ref"] == 1
    assert stats["varlen"] == 0 and stats["varlen_bwd"] == 0
    assert stats["flash_ref"] == 0
    for g, w in zip(got, _port(q, k, v, dout, segs, True)[2]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with torch.no_grad():
        assert TFA.flash_attention_segments(
            *ts, *(torch.as_tensor(a) for a in segs),
            causal=True).grad_fn is None


_SIZES = {"cross": (128, 128), "aligned": (128, 128), "padtail": (64, 64),
          "noncontig": (64, 64), "sq_ne_sk": (64, 96)}


def _dividing(blocks):
    """(layout, (block_q, block_k)) pairs where the tiles divide S, as the
    reference needs: the CUDA-core tile (32), the tensor-core route's
    (128 x 128 forward, 64 x 64 backward), smaller and mixed ones."""
    return [(layout, (bq, bk)) for layout, (sq, sk) in _SIZES.items()
            for bq, bk in blocks if sq % bq == 0 and sk % bk == 0]


# the reference needs the tile to divide S: Sk = 96 of "sq_ne_sk" leaves
# out 64 and 128, S = 64 of "padtail" and "noncontig" leaves out 128
@pytest.mark.parametrize("layout,block", [
    (layout, block) for layout, (sq, sk) in _SIZES.items()
    for block in (16, 32, 64, 128) if sq % block == 0 and sk % block == 0])
def test_count_skipped_blocks_matches_jax(layout, block):
    segs = _layout(layout)
    for causal in (True, False):
        assert TFA.count_skipped_blocks(*(torch.as_tensor(a) for a in segs),
                                        block, block, causal) == \
            JFA.count_skipped_blocks(*segs, block, block, causal)


@pytest.mark.parametrize("layout,tiles", _dividing([(64, 32), (32, 64),
                                                    (128, 64)]))
def test_count_skipped_blocks_matches_jax_on_mixed_tiles(layout, tiles):
    segs = _layout(layout)
    for causal in (True, False):
        assert TFA.count_skipped_blocks(*(torch.as_tensor(a) for a in segs),
                                        *tiles, causal) == \
            JFA.count_skipped_blocks(*segs, *tiles, causal)


@pytest.mark.parametrize("layout,tiles", _dividing(
    [(32, 32), (64, 64), (128, 128)]))
def test_tile_stats_first_six_rows_match_jax(layout, tiles):
    """The stats' first six rows are the reference's ``_seg_block_stats``
    (the two rows after them are the port's own)."""
    segs = _layout(layout)
    got, stride = TFA._seg_block_stats(*(torch.as_tensor(a) for a in segs),
                                       *tiles)
    want, jstride = JFA._seg_block_stats(*(jnp.asarray(a) for a in segs),
                                         *tiles)
    assert stride == jstride and got.shape[0] == 8
    np.testing.assert_array_equal(got[:6].numpy(), np.asarray(want))


def _ragged(layout):
    """The layout less its last five tokens: S divides no tile."""
    return [torch.as_tensor(a)[:, :-5] for a in _layout(layout)]


def _pairs(segs, causal, tq, tk):
    """(visible [B, nq, tq, nk, tk], present [...]): visible token pairs
    and pairs of real (not past-the-edge) tokens, tile by tile."""
    b, sq = segs[0].shape
    sk = segs[1].shape[1]
    nq, nk = -(-sq // tq), -(-sk // tk)
    pad = (0, nk * tk - sk, 0, nq * tq - sq)
    vis = torch.nn.functional.pad(TFA._seg_mask(*segs, causal), pad)
    real = torch.nn.functional.pad(torch.ones(b, sq, sk, dtype=torch.bool),
                                   pad)
    return (vis.reshape(b, nq, tq, nk, tk), real.reshape(b, nq, tq, nk, tk),
            nq, nk)


@pytest.mark.parametrize("layout", ["cross", "noncontig", "sq_ne_sk"])
def test_tile_skipping_is_conservative(layout):
    """Every tile pair that holds a visible token pair runs, at the
    CUDA-core tiles (32) and the tensor-core route's (128 forward, 64
    backward), also where S does not divide the tile (a ragged last
    tile) and for layouts where the predicate is not exact."""
    segs = _ragged(layout)
    b = segs[0].shape[0]
    for tiles in ((32, 32), (64, 64), (128, 128)):
        for causal in (True, False):
            stats, stride = TFA._seg_block_stats(*segs, *tiles)
            vis, _, nq, nk = _pairs(segs, causal, *tiles)
            run = TFA._tiles_run(stats, stride, b, nq, nk, causal)
            needed = vis.any(4).any(2)
            assert not bool((needed & ~run).any())
            skipped, total = TFA.count_skipped_blocks(*segs, *tiles, causal)
            assert total == b * nq * nk and skipped == int((~run).sum())


@pytest.mark.parametrize("tiles", [(32, 32), (64, 64), (128, 128)])
@pytest.mark.parametrize("layout", ["cross", "aligned", "noncontig",
                                    "sq_ne_sk"])
def test_full_tiles_see_every_pair(layout, tiles):
    """A tile pair that the stats' last two rows mark as needing no
    element mask (``_tiles_full``) runs, and every pair of real tokens in
    it is visible, also in a ragged last tile; on tile-aligned documents
    some pairs are full, so the mark is not vacuous."""
    segs = _ragged(layout) if layout != "aligned" else [
        torch.as_tensor(a) for a in _layout(layout)]
    b = segs[0].shape[0]
    for causal in (True, False):
        stats, stride = TFA._seg_block_stats(*segs, *tiles)
        vis, real, nq, nk = _pairs(segs, causal, *tiles)
        full = TFA._tiles_full(stats, stride, b, nq, nk, causal)
        run = TFA._tiles_run(stats, stride, b, nq, nk, causal)
        assert not bool((full & ~run).any())
        unseen = (real & ~vis).any(4).any(2)
        assert not bool((full & unseen).any())
        if layout == "aligned" and tiles == (32, 32):
            assert bool(full.any())


def test_segment_ids_from_cu_seqlens_match_jax():
    for cu, t in (([0, 3, 7, 12], 12), ([0, 5, 9], 16), ([0, 16], 16)):
        got = TATT.segment_ids_from_cu_seqlens(torch.tensor(cu), t)
        want = JATT.segment_ids_from_cu_seqlens(jnp.asarray(cu), t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            TATT._local_positions(torch.tensor(cu), got, t).numpy(),
            np.asarray(JATT._local_positions(jnp.asarray(cu), want, t)))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_unpadded_matches_jax(causal):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(48, 2, 16)).astype(np.float32)
    v = rng.normal(size=(48, 2, 16)).astype(np.float32)
    cq, ck = np.array([0, 10, 25, 36]), np.array([0, 12, 30, 48])
    want, none = JATT.flash_attn_unpadded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cq),
        jnp.asarray(ck), causal=causal)
    assert none is None
    TK.reset_dispatch_stats()
    got, none = TATT.flash_attn_unpadded(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(cq), torch.as_tensor(ck), causal=causal)
    assert none is None and TK.dispatch_stats()["varlen_ref"] == 1
    want = np.asarray(getattr(want, "_data", want))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[36:] == 0)              # past cu_seqlens_q[-1]


def test_flash_attn_varlen_qkvpacked_matches_unpadded():
    rng = np.random.default_rng(5)
    qkv = torch.as_tensor(rng.normal(size=(30, 3, 2, 16)).astype(np.float32))
    cu = torch.tensor([0, 12, 30])
    got, _ = TATT.flash_attn_varlen_qkvpacked(qkv, cu, cu, causal=True)
    want, _ = TATT.flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu,
                                       cu, causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_attn_unpadded_raises_as_jax_does():
    q = np.zeros((8, 2, 16), np.float32)
    cu = np.array([0, 4, 9])                      # 9 > T = 8
    cases = ((dict(), ValueError), (dict(dropout=0.1), NotImplementedError),
             (dict(return_softmax=True), NotImplementedError))
    for kw, err in cases:
        with pytest.raises(err):
            JATT.flash_attn_unpadded(jnp.asarray(q), jnp.asarray(q),
                                     jnp.asarray(q), jnp.asarray(cu),
                                     jnp.asarray(cu), **kw)
        with pytest.raises(err):
            TATT.flash_attn_unpadded(torch.as_tensor(q), torch.as_tensor(q),
                                     torch.as_tensor(q), torch.as_tensor(cu),
                                     torch.as_tensor(cu), **kw)


def test_sdpa_raw_segment_path():
    """``segment_ids`` without ``positions`` takes the global arange;
    ``attn_mask`` or dropout with ``segment_ids`` raise as in the
    reference."""
    q, k, v, _ = _qkv(6, 2, 64, 64)
    seg, pos = _rows([[64], [40, 24]], 64)
    t = [torch.as_tensor(a) for a in (q, k, v)]
    got = TATT.sdpa_raw(*t, is_causal=True, segment_ids=torch.as_tensor(seg))
    glob = np.tile(np.arange(64, dtype=np.int32), (2, 1))
    want = TFA.segment_attention_ref(
        *t, *(torch.as_tensor(a) for a in (seg, seg, glob, glob)),
        causal=True)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    local = TATT.sdpa_raw(*t, is_causal=True,
                          segment_ids=torch.as_tensor(seg),
                          positions=torch.as_tensor(pos))
    # contiguous packing: the local order is the global one
    torch.testing.assert_close(local, got, rtol=0, atol=0)
    for kw in (dict(attn_mask=torch.ones(64, 64, dtype=torch.bool)),
               dict(dropout_p=0.1)):
        with pytest.raises(NotImplementedError, match="segment_ids"):
            TATT.sdpa_raw(*t, segment_ids=torch.as_tensor(seg), **kw)


def test_gather_rope_rows_matches_jax():
    cos, sin = TATT.rope_tables(16, 8)
    pos = np.array([[0, 1, 2, 0, 1], [3, 4, 0, 1, 2]], np.int32)
    jc, js = JATT.gather_rope_rows(jnp.asarray(cos.numpy()),
                                   jnp.asarray(sin.numpy()), pos)
    tc, ts = TATT.gather_rope_rows(cos, sin, torch.as_tensor(pos))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_segments_supported_rules():
    q, k = torch.zeros(2, 64, 4, 32), torch.zeros(2, 48, 2, 32)
    sq, sk = torch.zeros(2, 64, dtype=torch.int32), torch.zeros(
        2, 48, dtype=torch.int64)
    assert TFA.segments_supported(q, k, k, sq, sk, sq, sk)
    assert not TFA.segments_supported(q, k, k, sq, sq, sq, sq)   # [B, Sk]
    assert not TFA.segments_supported(q, k, k, sq.float(), sk, sq, sk)
    assert not TFA.segments_supported(q, k, k, sq.numpy(), sk, sq, sk)
    d24 = torch.zeros(2, 64, 2, 24)                 # D % 8, <= 256: taken
    assert TFA.segments_supported(d24, d24, d24, sq, sq, sq, sq)
    for d in (12, 264):                             # refused
        bad = torch.zeros(2, 64, 2, d)
        assert not TFA.segments_supported(bad, bad, bad, sq, sq, sq, sq)
    with pytest.raises(ValueError, match="tiles_ran"):  # a CUDA counter
        TFA.flash_attention_segments_fwd(
            q, torch.zeros(2, 64, 2, 32), torch.zeros(2, 64, 2, 32), sq, sq,
            sq, sq, tiles_ran=torch.zeros(1, dtype=torch.int32))
