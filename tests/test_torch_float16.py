"""The float16 arms of the kernel wrappers on the CPU: the plain versions
the port runs for CPU tensors against the JAX package's Pallas kernels in
interpret mode on the same float16 inputs (the Pallas kernels keep any
float type), and the wrappers' domains.

Tolerances: flash outputs within 2e-3 (float16 outputs of size ~1: the
kernel rounds P to float16 before P.V against its running max, the plain
version the normalized probabilities, each one float16 rounding of
2^-11 relative), lse within 1e-4 of the float32 arm's; gradients
within 5e-3 of each tensor's max (dS and P rounded to float16 in the
Pallas backward, not in the plain one); decode within 2e-3 plus float16's unit roundoff of max |v| where
the pages are not q's type (the Pallas kernel rounds p to the page
type).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as TFA
from paddle_tpu_torch.kernels import paged_attention as TPA
from paddle_tpu_torch.kernels import rms_norm as TRN

JFA = importlib.import_module("paddle_tpu.kernels.flash_attention")
JPA = importlib.import_module("paddle_tpu.kernels.paged_attention")

OUT_TOL, LSE_TOL, GRAD_TOL = 2e-3, 1e-4, 5e-3


def _qkv(seed, d, sq=32, sk=32, H=4, KVH=2, B=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, s, n, d)).astype(np.float16)
                 for s, n in ((sq, H), (sk, KVH), (sk, KVH), (sq, H)))


def _vjp(f, q, k, v, dout):
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return out, vjp(jnp.asarray(dout))


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("d", [64, 72, 128, 40])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_float16_plain_versions_match_pallas(d, causal):
    q, k, v, dout = _qkv(d, d)
    out_j, grads_j = _vjp(
        lambda q, k, v: JFA.flash_attention(
            q, k, v, causal=causal, interpret=True, block_q=16,
            block_k=16), q, k, v, dout)
    tq, tk, tv, tg = (torch.as_tensor(a) for a in (q, k, v, dout))
    out, lse = TFA.flash_attention_ref(tq, tk, tv, causal=causal)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(out_j, np.float32), atol=OUT_TOL)
    # the float32 lse of the float16 inputs, as the float32 arm's
    _, lse32 = TFA.flash_attention_ref(tq.float(), tk.float(), tv.float(),
                                       causal=causal)
    np.testing.assert_allclose(lse.numpy(), lse32.numpy(), atol=LSE_TOL)
    grads = TFA.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg,
                                        causal=causal)
    for g, w in zip(grads, grads_j):
        assert g.dtype == torch.float16
        assert _rel(g, w) <= GRAD_TOL


def _packed(b, s):
    seg = np.full((b, s), -1, np.int32)
    pos = np.zeros((b, s), np.int32)
    for r, lens in enumerate(([10, 14, 5], [20, 9])[:b]):
        o = 0
        for i, n in enumerate(lens):
            seg[r, o:o + n], pos[r, o:o + n] = i, np.arange(n)
            o += n
    return seg, pos


@pytest.mark.parametrize("d", [64, 128])
def test_segment_float16_plain_versions_match_pallas(d):
    q, k, v, dout = _qkv(100 + d, d)
    seg, pos = _packed(2, 32)
    segs = (seg, seg, pos, pos)

    def f(q, k, v):
        return JFA.flash_attention_segments(q, k, v, *segs, causal=True,
                                            interpret=True, block_q=16,
                                            block_k=16)
    out_j, grads_j = _vjp(f, q, k, v, dout)
    tq, tk, tv, tg = (torch.as_tensor(a) for a in (q, k, v, dout))
    ts = [torch.as_tensor(a) for a in segs]
    out, lse = TFA.segment_attention_ref(tq, tk, tv, *ts, causal=True)
    assert out.dtype == torch.float16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(out_j, np.float32), atol=OUT_TOL)
    grads = TFA.segment_attention_bwd_ref(tq, tk, tv, out, lse, tg, *ts,
                                          causal=True)
    for g, w in zip(grads, grads_j):
        assert g.dtype == torch.float16 and _rel(g, w) <= GRAD_TOL
    pad = torch.as_tensor(seg < 0)
    assert torch.all(out[pad] == 0) and torch.all(grads[0][pad] == 0)


@pytest.mark.parametrize("pdt,extra", [("float16", 0.0),
                                       ("float32", 0.0),
                                       ("bfloat16", 2.0 ** -8)])
def test_decode_float16_q_matches_pallas(pdt, extra):
    rng = np.random.default_rng(5)
    B, nh, kv, hd, ps, P, maxp = 3, 8, 2, 64, 16, 10, 4
    q = rng.normal(size=(B, nh, hd)).astype(np.float32)
    kp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(P, kv, ps, hd)).astype(np.float32)
    ln = np.array([13, 0, 50], np.int32)
    bt = np.stack([rng.permutation(P)[:maxp] for _ in range(B)]).astype(
        np.int32)
    kern = np.asarray(JPA.ragged_paged_attention(
        jnp.asarray(q, jnp.float16), jnp.asarray(kp, getattr(jnp, pdt)),
        jnp.asarray(vp, getattr(jnp, pdt)), jnp.asarray(bt),
        jnp.asarray(ln), interpret=True), np.float32)
    tq = torch.as_tensor(q).half()
    tk, tv = (torch.as_tensor(a).to(getattr(torch, pdt)) for a in (kp, vp))
    got = TPA.paged_attention_ref(tq, tk, tv, torch.as_tensor(bt),
                                  torch.as_tensor(ln))
    assert got.dtype == torch.float16 and torch.all(got[1] == 0)
    tol = OUT_TOL + extra * float(np.abs(vp).max())
    np.testing.assert_allclose(got.float().numpy(), kern, atol=tol)


def test_decode_float16_q_over_int8_pages_matches_pallas():
    rng = np.random.default_rng(6)
    B, nh, kv, hd, ps, P, maxp = 2, 4, 2, 64, 32, 6, 2
    q = rng.normal(size=(B, nh, hd)).astype(np.float16)
    codes = rng.integers(-127, 128, (P, kv, ps, hd)).astype(np.int8)
    vcodes = rng.integers(-127, 128, (P, kv, ps, hd)).astype(np.int8)
    ks = (rng.random((P, kv)) / 50).astype(np.float32)
    vs = (rng.random((P, kv)) / 50).astype(np.float32)
    ln = np.array([40, 7], np.int32)
    bt = np.stack([rng.permutation(P)[:maxp] for _ in range(B)]).astype(
        np.int32)
    kern = np.asarray(JPA.ragged_paged_attention(
        *(jnp.asarray(a) for a in (q, codes, vcodes, bt, ln)),
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
        interpret=True), np.float32)
    got = TPA.paged_attention_ref(
        *(torch.as_tensor(a) for a in (q, codes, vcodes, bt, ln)),
        k_scales=torch.as_tensor(ks), v_scales=torch.as_tensor(vs))
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), kern, atol=OUT_TOL)


def test_wrappers_take_float16():
    """``supported`` / ``supported_bwd`` / ``segments_supported`` and the
    RMSNorm and decode domains take float16; the tensor-core route takes
    it at ``TC_DIMS``."""
    for d in (8, 64, 72, 128, 256):
        q = torch.zeros(1, 8, 4, d, dtype=torch.float16)
        k = torch.zeros(1, 8, 2, d, dtype=torch.float16)
        assert TFA.supported(q, k, k) and TFA.supported_bwd(q, k, k)
        seg = torch.zeros(1, 8, dtype=torch.int32)
        assert TFA.segments_supported(q, k, k, seg, seg, seg, seg)
        assert TFA.tensor_core_route(q) is (d in TFA.TC_DIMS)
        assert TFA.seg_tiles(q) == ((128, 128) if d in TFA.TC_DIMS
                                    else (32, 32))
    for xdt in (torch.float16, torch.float32, torch.bfloat16):
        for wdt in (torch.float16, torch.float32, torch.bfloat16):
            assert TRN.supported(torch.zeros(4, 64, dtype=xdt),
                                 torch.zeros(64, dtype=wdt))
    bt = torch.zeros(2, 3, dtype=torch.int32)
    for pdt in (torch.float16, torch.float32, torch.bfloat16):
        assert TPA.supported(torch.zeros(2, 8, 64, dtype=torch.float16),
                             torch.zeros(4, 2, 16, 64, dtype=pdt), bt)
    assert not TPA.supported(torch.zeros(2, 8, 64, dtype=torch.float64),
                             torch.zeros(4, 2, 16, 64), bt)
