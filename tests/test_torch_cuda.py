"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; without a CUDA device every test here skips (decided in
a fixture, never at import). On a machine with an H100, from the repo
root:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: bfloat16 outputs ``2e-2`` (one bf16 rounding of values of
size ~1), float32 ``1e-4`` (summation order and the fast exponential).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import fused_ce as CE
from paddle_tpu_torch.kernels import paged_attention as PA
from paddle_tpu_torch.kernels import rms_norm as RN
from paddle_tpu_torch.models import llama as L
from paddle_tpu_torch.nn.functional import attention as ATT

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("sq,sk,causal", [(48, 48, True), (33, 70, True),
                                          (70, 33, True), (40, 40, False)])
def test_flash_kernel_matches_plain(dev, dtype, tol, sq, sk, causal):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, sq, 8, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(2, sk, 2, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(2, sk, 2, 64, generator=g, device=dev).to(dtype)
    K.reset_dispatch_stats()
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert K.dispatch_stats()["flash"] == 1
    ref, ref_lse = FA.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


def _bwd_inputs(dev, dtype, sq, sk, causal, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(2, s, h, 64, generator=g, device=dev)
                     .to(dtype) for s, h in ((sq, 8), (sk, 2), (sk, 2),
                                             (sq, 8)))
    out, lse = FA.flash_attention_ref(q, k, v, causal=causal)
    return q, k, v, out.contiguous(), lse, dout


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("sq,sk,causal", [(48, 48, True), (32, 80, True),
                                          (80, 33, True), (40, 40, False)])
def test_flash_bwd_kernel_matches_plain(dev, dtype, tol, sq, sk, causal):
    """dq / dk / dv against the plain version on the same card tensors,
    as max abs error over each reference's max |.|; rows that see no key
    (sq > sk, causal) get exact zeros."""
    args = _bwd_inputs(dev, dtype, sq, sk, causal)
    K.reset_dispatch_stats()
    got = FA.flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    assert K.dispatch_stats()["flash_bwd"] == 1
    want = FA.flash_attention_bwd_ref(*args, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), err
    if sq > sk and causal:
        assert torch.all(got[0][:, :sq - sk] == 0)


@pytest.mark.parametrize("d", [64, 72, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(48, 48), (33, 70), (70, 33), (200, 200),
                                   (1000, 1000)])
@pytest.mark.parametrize("heads", [(8, 2), (16, 16)])
def test_tensor_core_kernels_match_plain(dev, d, causal, sq, sk, heads):
    """The tensor-core route (bf16, D 64 / 72 / 128) against the plain
    versions, with grouped kv heads and with as many kv heads as query
    heads (DeepSeekMoE-16B's 16 / 16): out within 2e-2, lse within 1e-3
    on rows that see a key, dq / dk / dv within 2e-2 of each reference's
    max |.|; rows that see no key get a zero output, lse = -inf and an
    exact zero dq."""
    g = torch.Generator(device=dev).manual_seed(d + sq + sk)
    h, kvh = heads
    q, k, v, dout = (torch.randn(2, s, n, d, generator=g, device=dev)
                     .bfloat16() for s, n in ((sq, h), (sk, kvh), (sk, kvh),
                                              (sq, h)))
    K.reset_dispatch_stats()
    out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    st = K.dispatch_stats()
    assert st["flash"] == st["flash_tc"] == 1, st
    assert st["flash_bwd"] == st["flash_bwd_tc"] == 1, st
    ref, ref_lse = FA.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    seen = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[seen], ref_lse[seen], atol=1e-3, rtol=0)
    assert torch.all(lse[~seen] == float("-inf"))
    want = FA.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        err = float((a.float() - w.float()).abs().max())
        assert err <= 2e-2 * float(w.float().abs().max()), err
    if causal and sq > sk:
        assert torch.all(out[:, :sq - sk] == 0)
        assert torch.all(got[0][:, :sq - sk] == 0)


@pytest.mark.parametrize("scale", [-0.1, 0.0, 0.2])
def test_tensor_core_kernels_take_any_scale(dev, scale):
    """The tensor-core forward takes each row's maximum on the raw scores:
    a negative or zero scale must give the plain version's result too."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, dout = (torch.randn(2, 200, h, 128, generator=g, device=dev)
                     .bfloat16() for h in (8, 2, 2, 8))
    out, lse = FA.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                 scale=scale)
    torch.cuda.synchronize()
    ref, ref_lse = FA.flash_attention_ref(q, k, v, causal=True, scale=scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    want = FA.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True,
                                      scale=scale)
    for a, w in zip(got, want):
        err = float((a.float() - w.float()).abs().max())
        assert err <= 2e-2 * float(w.float().abs().max()), err


def test_attention_gradient_flows_on_the_card(dev):
    """A loss through sdpa_raw on CUDA tensors reaches q, k and v through
    the backward kernels, as it does through the plain version."""
    q, k, v, _, _, dout = _bwd_inputs(dev, torch.float32, 48, 48, True, 3)
    for t in (q, k, v):
        t.requires_grad_(True)
    K.reset_dispatch_stats()
    (ATT.sdpa_raw(q, k, v, is_causal=True) * dout).sum().backward()
    torch.cuda.synchronize()
    assert K.dispatch_stats()["flash_bwd"] == 1
    assert K.dispatch_stats()["flash_bwd_ref"] == 0
    for t in (q, k, v):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
    want = FA.flash_attention_bwd_ref(
        q.detach(), k.detach(), v.detach(),
        *FA.flash_attention_fwd(q.detach(), k.detach(), v.detach(),
                                causal=True), dout, causal=True)
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad, w, atol=1e-4, rtol=0)


def test_fused_ce_bf16_card_matches_cpu(dev):
    """bfloat16 blockwise cross entropy on the card (float32-output
    cuBLAS products) against the CPU (float32 operands): loss to 1e-4,
    dx / dhead to one bf16 rounding, 8e-3 of each reference's max |.|."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(64, 256, generator=g).bfloat16()
    head = (0.3 * torch.randn(1000, 256, generator=g)).bfloat16()
    labels = torch.randint(0, 1000, (64,), generator=g)
    labels[::5] = -100
    out = {}
    for where in ("cpu", dev):
        tx = x.to(where).detach().requires_grad_()
        th = head.to(where).detach().requires_grad_()
        loss = CE.fused_cross_entropy(tx, th, labels.to(where),
                                      vocab_chunk=384)
        loss.backward()
        out[str(where)] = [t.detach().float().cpu()
                           for t in (loss, tx.grad, th.grad)]
    got, want = out[str(dev)], out["cpu"]
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 8e-3 * float(b.abs().max())


PAGED_CASES = ["edge", "split_edges", "b1_full", "b32", "nan_past_length"]


def _decode_case(dev, case, dtype, quant, ps, seed=3, heads=(8, 2, 64)):
    """Inputs of one decode case, ``heads`` = (query heads, kv heads,
    head dim), and the plain
    version's pages and scales. ``edge``: lengths 0, 1, ps - 1, ps,
    ps + 1 and a full table of 4 pages. The others use a table of 2048
    positions: lengths at the edges of the split plan's chunk
    (``decode_split_plan``) up to the full table; one sequence over the
    full table; 32 sequences; and NaN (full precision) or -128 codes
    (int8) in every slot past a sequence's length in its last page,
    with the table's sentinel entries naming a page no sequence owns
    whose values (or, for int8, scales) are NaN, against the plain
    version on zeros there. int8 pages 0 and 5 are never written (scale
    0)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    NH, KVH, D = heads
    maxp = 4 if case == "edge" else 2048 // ps
    full = maxp * ps

    def chunk(b):
        return PA.decode_split_plan(b, KVH, ps, maxp)[0] * ps

    c = chunk(8)
    lengths = {
        "edge": [0, 1, ps - 1, ps, ps + 1, full],
        "split_edges": [c - 1, c, c + 1, 2 * c - 1, 2 * c + 1, 0, full - 1,
                        full],
        "b1_full": [full],
        "b32": [0, 1, full, chunk(32) - 1, chunk(32), chunk(32) + 1]
        + torch.randint(1, full + 1, (26,),
                        generator=torch.Generator().manual_seed(5)).tolist(),
        "nan_past_length": [1, ps - 1, ps + 1, c - 1, c + 1, 700, full - 1,
                            0],
    }[case]
    B = len(lengths)
    P = sum(-(-n // ps) for n in lengths) + 8
    q = torch.randn(B, NH, D, generator=g, device=dev).to(dtype)
    if quant:
        kp, vp = (torch.randint(-127, 128, (P, KVH, ps, D), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (0.02 * torch.rand(P, KVH, generator=g, device=dev)
                  for _ in range(2))
        ks[[0, 5]] = 0.0
        vs[[0, 5]] = 0.0
    else:
        kp, vp = (torch.randn(P, KVH, ps, D, generator=g, device=dev)
                  .to(dtype) for _ in range(2))
        ks = vs = None
    # each sequence's own pages, then the sentinel P - 1 (the last page,
    # which no sequence owns) and garbage (-3 names page 0)
    bt = torch.full((B, maxp), P - 1, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(4))
    nxt = 0
    for b, n in enumerate(lengths):
        used = -(-n // ps)
        bt[b, :used] = perm[nxt:nxt + used]
        nxt += used
        if used < maxp - 1:
            bt[b, -1] = -3
    bt = bt.to(dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ref = [kp, vp, ks, vs]
    if case == "nan_past_length":
        bad = -128 if quant else float("nan")
        kp, vp, kz, vz = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        for b, n in enumerate(lengths):
            if n % ps:
                page = int(bt[b, n // ps])
                for t, v in ((kp, bad), (vp, bad), (kz, 0), (vz, 0)):
                    t[page, :, n % ps:] = v
        if quant:
            ks, vs, ksz, vsz = ks.clone(), vs.clone(), ks.clone(), vs.clone()
            ks[-1] = vs[-1] = float("nan")
            ksz[-1] = vsz[-1] = 0.0
            ref = [kz, vz, ksz, vsz]
        else:
            kp[-1] = vp[-1] = float("nan")
            kz[-1] = vz[-1] = 0.0
            ref = [kz, vz, None, None]
    return q, kp, vp, ks, vs, bt, ln, ref


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("heads", [(8, 2, 64), (16, 16, 128)])
def test_paged_kernel_matches_plain(dev, dtype, tol, case, heads):
    """Grouped kv heads, and DeepSeekMoE-16B's 16 / 16 heads of 128 (one
    query head a kv head, its own split plan)."""
    q, kp, vp, _, _, bt, ln, (kr, vr, _, _) = _decode_case(
        dev, case, dtype, False, 16, heads=heads)
    K.reset_dispatch_stats()
    out = PA.ragged_paged_attention(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    assert K.dispatch_stats()["paged"] == 1
    ref = PA.paged_attention_ref(q, kr, vr, bt, ln)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    for b in torch.nonzero(ln == 0).flatten().tolist():
        assert torch.all(out[b] == 0)


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("ps", [16, 32, 64])
def test_paged_int8_kernel_matches_plain(dev, dtype, tol, ps, case):
    q, kc, vc, ks, vs, bt, ln, (kr, vr, ksr, vsr) = _decode_case(
        dev, case, dtype, True, ps)
    K.reset_dispatch_stats()
    out = PA.ragged_paged_attention(q, kc, vc, bt, ln, k_scales=ks,
                                    v_scales=vs)
    torch.cuda.synchronize()
    assert K.dispatch_stats()["paged_quant"] == 1
    ref = PA.paged_attention_ref(q, kr, vr, bt, ln, k_scales=ksr,
                                 v_scales=vsr)
    assert out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    for b in torch.nonzero(ln == 0).flatten().tolist():
        assert torch.all(out[b] == 0)


@pytest.mark.parametrize("case", ["edge", "split_edges", "b32"])
def test_paged_int8_kernel_equals_full_precision_kernel(dev, case):
    """float32: the int8 arm (scales folded into the scores and p)
    against the full-precision kernel on the densely dequantized
    pages."""
    q, kc, vc, ks, vs, bt, ln, _ = _decode_case(dev, case, torch.float32,
                                                True, 32)
    out = PA.ragged_paged_attention(q, kc, vc, bt, ln, k_scales=ks,
                                    v_scales=vs)
    dense = PA.ragged_paged_attention(
        q, (kc.float() * ks[:, :, None, None]).contiguous(),
        (vc.float() * vs[:, :, None, None]).contiguous(), bt, ln)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, dense, atol=1e-4, rtol=0)


def test_paged_decode_mixed_page_dtypes(dev):
    """Every mixed (q, page) pair of the decode kernel (float32 q over
    bf16 / float16 pages, bf16 q over float32 / float16 pages) against the
    plain version at the edge shapes (D 64 / 128, groups 1-8) and the main
    serving shape, within ``chip_smoke.mixed_tol``, bf16 q against
    ``chip_smoke.paged_ref_round_p`` and float32 q over 2-byte pages
    within ``chip_smoke.MIXED_RMS_BAND`` (the pairs with 2-byte pages
    round p as the Pallas kernel does); bf16 q over float32 pages of
    bf16 values equals the bf16 arm bit for bit; launches count
    ``paged_mixed``."""
    C = _chip_smoke()
    main_lengths, _ = C.decode_wave_lengths(C._main_requests(32000))
    K.reset_dispatch_stats()
    worst, margin = C.paged_mixed_checks(torch, dev, PA, main_lengths, 128)
    st = K.dispatch_stats()
    assert set(worst) == set(C.MIXED_PAIRS) and margin <= 1.0
    # 5 shapes: each pair, the bit-for-bit pair and the bf16 arm
    assert st["paged_mixed"] == 5 * (len(C.MIXED_PAIRS) + 1), st
    assert st["paged"] == st["paged_mixed"] + 5, st


@pytest.mark.parametrize("quant", [False, True])
def test_paged_kernel_repeats_bit_for_bit(dev, quant):
    """No atomics: two launches on the same inputs give the same bits."""
    q, kp, vp, ks, vs, bt, ln, _ = _decode_case(dev, "b32", torch.bfloat16,
                                                quant, 16)
    kw = {"k_scales": ks, "v_scales": vs} if quant else {}
    a = PA.ragged_paged_attention(q, kp, vp, bt, ln, **kw)
    b = PA.ragged_paged_attention(q, kp, vp, bt, ln, **kw)
    assert torch.equal(a, b)


@pytest.mark.parametrize("width", ["int8", "int4"])
def test_weight_dequant_card_equals_cpu(dev, width):
    """The one-pass dequantization on the card gives the CPU's bf16
    weights bit for bit (an f32 product, one rounding)."""
    g = torch.Generator().manual_seed(10)
    w = L.quant_packed(torch.randn(3, 64, 48, generator=g), 1, width)
    want = L._dequant({k: v[1] for k, v in w.items()}, -2, torch.bfloat16)
    got = L._dequant({k: v[1].to(dev) for k, v in w.items()}, -2,
                     torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), want)


def test_bf16_head_logits_card_matches_cpu(dev):
    """The float32-output head product on the card (cuBLAS) against
    float32 operands on the CPU: logits to 1e-5 of the largest, and the
    gradients of both bf16 operands to one bf16 rounding."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 5, 256, generator=g).bfloat16()
    head = (0.1 * torch.randn(1000, 256, generator=g)).bfloat16()
    gl = torch.randn(2, 5, 1000, generator=g)
    out = {}
    for where in ("cpu", dev):
        tx = x.to(where).detach().requires_grad_()
        th = head.to(where).detach().requires_grad_()
        logits = L._head_logits(tx, th)
        assert logits.dtype == torch.float32
        logits.backward(gl.to(where))
        out[str(where)] = [t.detach().float().cpu()
                           for t in (logits, tx.grad, th.grad)]
    got, want = out[str(dev)], out["cpu"]
    assert float((got[0] - want[0]).abs().max()) <= \
        1e-5 * float(want[0].abs().max())
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) <= 8e-3 * float(b.abs().max())


def _seg_layout(dev, b, sq, sk, kind):
    """(seg_q, seg_k, pos_q, pos_k) int32 on the card: documents of
    assorted lengths with a padding tail ("packed"), random ids and
    positions per token ("random"), or q / k sides of different
    documents ("cu", Sq != Sk)."""
    g = torch.Generator().manual_seed(5)
    if kind == "random":
        seg_q = torch.randint(-1, 3, (b, sq), generator=g)
        pos_q = torch.randint(0, sq, (b, sq), generator=g)
        seg_k = torch.randint(-1, 3, (b, sk), generator=g)
        pos_k = torch.randint(0, sk, (b, sk), generator=g)
    else:
        def side(s, lens):
            seg = torch.full((b, s), -1)
            pos = torch.zeros(b, s, dtype=torch.long)
            o = 0
            for i, n in enumerate(lens):
                seg[:, o:o + n], pos[:, o:o + n] = i, torch.arange(n)
                o += n
            return seg, pos
        seg_q, pos_q = side(sq, [sq // 3, sq // 2 - 5, sq // 8])
        seg_k, pos_k = (side(sk, [sk // 4, sk // 2, sk // 5])
                        if kind == "cu" else (seg_q, pos_q))
    return tuple(t.to(torch.int32).to(dev)
                 for t in (seg_q, seg_k, pos_q, pos_k))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("sq,sk,causal,kind", [
    (96, 96, True, "packed"), (100, 100, False, "packed"),
    (64, 64, True, "random"), (70, 90, True, "cu")])
def test_segment_kernels_match_plain(dev, dtype, tol, sq, sk, causal, kind):
    """The segment forward (out, lse) and backward (dq / dk / dv, as max
    abs error over each reference's max |.|) against their plain
    versions on the same card tensors; padding rows and keys get exact
    zeros."""
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v, dout = (torch.randn(2, s, h, 64, generator=g, device=dev)
                     .to(dtype) for s, h in ((sq, 8), (sk, 2), (sk, 2),
                                             (sq, 8)))
    segs = _seg_layout(dev, 2, sq, sk, kind)
    K.reset_dispatch_stats()
    out, lse = FA.flash_attention_segments_fwd(q, k, v, *segs, causal=causal)
    grads = FA.flash_attention_segments_bwd(q, k, v, out, lse, dout, *segs,
                                            causal=causal)
    torch.cuda.synchronize()
    stats = K.dispatch_stats()
    assert stats["varlen"] == 1 and stats["varlen_bwd"] == 1
    tc = int(dtype == torch.bfloat16)        # D 64: bf16 on the tensor cores
    assert stats["varlen_tc"] == tc and stats["varlen_bwd_tc"] == tc, stats
    ref, ref_lse = FA.segment_attention_ref(q, k, v, *segs, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    seen = torch.isfinite(ref_lse)
    assert torch.equal(seen, torch.isfinite(lse))
    torch.testing.assert_close(lse[seen], ref_lse[seen], atol=1e-3, rtol=0)
    want = FA.segment_attention_bwd_ref(q, k, v, out, lse, dout, *segs,
                                        causal=causal)
    for got, w in zip(grads, want):
        err = float((got.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), err
    pad_q, pad_k = segs[0] < 0, segs[1] < 0
    assert torch.all(out[pad_q] == 0) and torch.all(grads[0][pad_q] == 0)
    assert torch.all(grads[1][pad_k] == 0) and torch.all(grads[2][pad_k] == 0)


def _check_segment_kernels(q, k, v, dout, segs, causal, scale=None,
                           tol=2e-2):
    """Both segment kernels against their plain versions: out within
    ``tol``, lse within 1e-3 on rows that see a key (-inf on the others),
    dq / dk / dv within ``tol`` of each reference's max |.|; padding rows
    and keys exact zeros."""
    out, lse = FA.flash_attention_segments_fwd(q, k, v, *segs, causal=causal,
                                               scale=scale)
    grads = FA.flash_attention_segments_bwd(q, k, v, out, lse, dout, *segs,
                                            causal=causal, scale=scale)
    torch.cuda.synchronize()
    ref, ref_lse = FA.segment_attention_ref(q, k, v, *segs, causal=causal,
                                            scale=scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    seen = torch.isfinite(ref_lse)
    assert torch.equal(seen, torch.isfinite(lse))
    torch.testing.assert_close(lse[seen], ref_lse[seen], atol=1e-3, rtol=0)
    want = FA.segment_attention_bwd_ref(q, k, v, out, lse, dout, *segs,
                                        causal=causal, scale=scale)
    for got, w in zip(grads, want):
        assert got.dtype == w.dtype and got.shape == w.shape
        err = float((got.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), err
    pad_q, pad_k = segs[0] < 0, segs[1] < 0
    assert torch.all(out[pad_q] == 0) and torch.all(grads[0][pad_q] == 0)
    assert torch.all(grads[1][pad_k] == 0) and torch.all(grads[2][pad_k] == 0)


@pytest.mark.parametrize("d", [64, 72, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,kind", [
    (1000, 1000, "packed"), (200, 200, "random"), (70, 90, "cu"),
    (300, 260, "cu"), (128, 128, "packed")])
def test_tensor_core_segment_kernels_match_plain(dev, d, causal, sq, sk,
                                                 kind):
    """The segment kernels' tensor-core route (bf16, D 64 / 72 / 128) against
    their plain versions: ragged S with a padding tail, random ids and
    positions per token (where the skip predicate is only conservative),
    and Sq != Sk; each launch counted on the route."""
    g = torch.Generator(device=dev).manual_seed(d + sq + sk)
    q, k, v, dout = (torch.randn(2, s, h, d, generator=g, device=dev)
                     .bfloat16() for s, h in ((sq, 8), (sk, 2), (sk, 2),
                                              (sq, 8)))
    segs = _seg_layout(dev, 2, sq, sk, kind)
    K.reset_dispatch_stats()
    _check_segment_kernels(q, k, v, dout, segs, causal)
    st = K.dispatch_stats()
    assert st["varlen"] == st["varlen_tc"] == 1, st
    assert st["varlen_bwd"] == st["varlen_bwd_tc"] == 1, st


@pytest.mark.parametrize("scale", [-0.1, 0.0, 0.2])
def test_tensor_core_segment_kernels_take_any_scale(dev, scale):
    """A negative or zero scale gives the plain version's result on the
    segment route too (the forward takes row maxima on raw scores)."""
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v, dout = (torch.randn(2, 300, h, 128, generator=g, device=dev)
                     .bfloat16() for h in (8, 2, 2, 8))
    segs = _seg_layout(dev, 2, 300, 300, "packed")
    _check_segment_kernels(q, k, v, dout, segs, True, scale=scale)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 32),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 72),
                                     (torch.bfloat16, 128)])
def test_segment_tiles_skipped_match_count(dev, dtype, d):
    """The forward kernel computes exactly the tiles that
    ``count_skipped_blocks`` leaves at its route's tiles
    (``seg_tiles``), on every head."""
    segs = _seg_layout(dev, 2, 1000, 1000, "packed")
    q = torch.randn(2, 1000, 4, d, device=dev).to(dtype)
    k = torch.randn(2, 1000, 2, d, device=dev).to(dtype)
    assert FA.seg_tiles(q) == ((128, 128) if dtype == torch.bfloat16
                               else (FA.SEG_BLOCK, FA.SEG_BLOCK))
    for causal in (True, False):
        ran = torch.zeros(1, dtype=torch.int32, device=dev)
        FA.flash_attention_segments_fwd(q, k, k, *segs, causal=causal,
                                        tiles_ran=ran)
        skipped, total = FA.count_skipped_blocks(*segs, *FA.seg_tiles(q),
                                                 causal)
        assert int(ran) == 4 * (total - skipped)


def test_single_document_segments_equal_dense_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, dout = (torch.randn(2, 80, h, 64, generator=g, device=dev)
                     .bfloat16() for h in (8, 2, 2, 8))
    seg = torch.zeros(2, 80, dtype=torch.int32, device=dev)
    pos = torch.arange(80, dtype=torch.int32, device=dev).expand(2, 80)
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    out = FA.flash_attention_segments(*ts, seg, seg, pos, pos, causal=True)
    grads = torch.autograd.grad(out, ts, dout)
    dense_ts = [t.detach().requires_grad_() for t in (q, k, v)]
    dense = FA.flash_attention(*dense_ts, causal=True)
    dense_grads = torch.autograd.grad(dense, dense_ts, dout)
    torch.testing.assert_close(out.float(), dense.float(), atol=2e-2, rtol=0)
    for a, b in zip(grads, dense_grads):
        assert float((a.float() - b.float()).abs().max()) <= \
            2e-2 * float(b.float().abs().max())


# head dims of the CUDA-core route beyond the tensor cores' 64 / 128:
# under 16, not a multiple of 16, above 128 (8 threads a row); bf16 at 72
# takes the tensor cores (test_tensor_core_kernels_match_plain), float32
# at 72 stays here
CUDA_CORE_DIMS = [8, 24, 40, 72, 136, 192, 256]
CUDA_CORE_CASES = [(d, dtype, tol) for d in CUDA_CORE_DIMS
                   for dtype, tol in ((torch.bfloat16, 2e-2),
                                      (torch.float32, 1e-4))
                   if not (dtype == torch.bfloat16 and d in FA.TC_DIMS)]


@pytest.mark.parametrize("d,dtype,tol", CUDA_CORE_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_pair_at_every_head_dim(dev, d, dtype, tol, causal):
    """The dense pair on the CUDA-core route at head dims that are not
    64 / 128, bf16 at 72 aside (GQA 8 / 2, Sq != Sk, ragged S): out
    within ``tol``, lse within 1e-3 on rows that see a key, dq / dk / dv
    within ``tol`` of each reference's max |.|; each launch counted off
    the tensor cores."""
    g = torch.Generator(device=dev).manual_seed(d)
    for sq, sk in ((70, 33), (100, 100)):
        q, k, v, dout = (torch.randn(2, s, h, d, generator=g, device=dev)
                         .to(dtype) for s, h in ((sq, 8), (sk, 2), (sk, 2),
                                                 (sq, 8)))
        K.reset_dispatch_stats()
        out, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
        got = FA.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
        torch.cuda.synchronize()
        st = K.dispatch_stats()
        assert st["flash"] == st["flash_bwd"] == 1, st
        assert st["flash_tc"] == st["flash_bwd_tc"] == 0, st
        ref, ref_lse = FA.flash_attention_ref(q, k, v, causal=causal)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=0)
        seen = torch.isfinite(ref_lse)
        assert torch.equal(seen, torch.isfinite(lse))
        torch.testing.assert_close(lse[seen], ref_lse[seen], atol=1e-3,
                                   rtol=0)
        want = FA.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                          causal=causal)
        for a, w in zip(got, want):
            assert a.dtype == dtype and a.shape == w.shape
            err = float((a.float() - w.float()).abs().max())
            assert err <= tol * float(w.float().abs().max()), err
        if causal and sq > sk:
            assert torch.all(out[:, :sq - sk] == 0)
            assert torch.all(got[0][:, :sq - sk] == 0)


@pytest.mark.parametrize("d,dtype,tol", CUDA_CORE_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_segment_pair_at_every_head_dim(dev, d, dtype, tol, causal):
    """The segment pair on the CUDA-core route at the same head dims, on
    a packed layout with a padding tail (ragged S) and on Sq != Sk."""
    g = torch.Generator(device=dev).manual_seed(100 + d)
    for sq, sk, kind in ((100, 100, "packed"), (70, 90, "cu")):
        q, k, v, dout = (torch.randn(2, s, h, d, generator=g, device=dev)
                         .to(dtype) for s, h in ((sq, 8), (sk, 2), (sk, 2),
                                                 (sq, 8)))
        segs = _seg_layout(dev, 2, sq, sk, kind)
        K.reset_dispatch_stats()
        _check_segment_kernels(q, k, v, dout, segs, causal, tol=tol)
        st = K.dispatch_stats()
        assert st["varlen"] == st["varlen_bwd"] == 1, st
        assert st["varlen_tc"] == st["varlen_bwd_tc"] == 0, st


def test_dit_card_matches_cpu(dev):
    """A float32 DiT at head dim 72 (hidden 144, 2 heads) with nonzero
    gates, one tree on the card and on the CPU: the forward within 1e-5
    of the largest value, the loss 1e-5 and each gradient 1e-4 of its
    max (the flash backward's own float32 tolerance: every gradient
    passes through it, and cuBLAS sums the tokens in another order); the
    card through the flash pair, no plain version."""
    from paddle_tpu_torch.models import dit as DIT
    cfg = DIT.dit_tiny(hidden_size=144, num_attention_heads=2)
    cpu = DIT.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    for leaf in L._leaves(cpu):
        if not leaf.any():
            leaf.copy_(torch.as_tensor(
                rng.standard_normal(tuple(leaf.shape)) * 0.02))
    card = L._map(lambda t: t.to(dev), cpu)
    x = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    t = np.array([5, 500, 999], np.int32)
    y = np.array([0, 3, 10], np.int32)
    batch = (x, t, y, rng.standard_normal(x.shape).astype(np.float32))
    K.reset_dispatch_stats()
    got = DIT.forward(card, x, t, y, cfg)
    loss, grads = L.loss_and_grads(card, batch, cfg, loss=DIT.loss_fn)
    torch.cuda.synchronize()
    st = K.dispatch_stats()
    assert st["flash"] == 2 * cfg.num_hidden_layers, st
    assert st["flash_bwd"] == cfg.num_hidden_layers, st
    assert st["flash_ref"] == st["flash_bwd_ref"] == 0, st
    want = DIT.forward(cpu, x, t, y, cfg)
    want_loss, want_grads = L.loss_and_grads(cpu, batch, cfg,
                                             loss=DIT.loss_fn)
    assert float((got.cpu() - want).abs().max()) <= \
        1e-5 * float(want.abs().max())
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for a, w in zip(L._leaves(grads), L._leaves(want_grads)):
        assert float((a.cpu() - w).abs().max()) <= \
            1e-4 * float(w.abs().max())


def test_dit_bf16_card_matches_cpu(dev):
    """The same DiT in bf16, where its head dim 72 takes the flash pair's
    tensor cores, card against the CPU's plain path: the forward, the loss,
    each gradient (of its max) and a 5-step DDIM loop (eta 1, guidance
    4.0, the same draws) within 2e-2 of the largest value, the flash
    pair's bf16 tolerance (one bf16 rounding of P and of dS, which the
    kernels make and the plain backward does not; this model's whole
    bf16-vs-float32 drift on the CPU is at most 8.4e-3); every launch on
    the tensor cores."""
    from paddle_tpu_torch.models import dit as DIT
    cfg = DIT.dit_tiny(hidden_size=144, num_attention_heads=2,
                       dtype=torch.bfloat16)
    cpu = DIT.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    for leaf in L._leaves(cpu):
        if not leaf.any():
            leaf.copy_(torch.as_tensor(
                rng.standard_normal(tuple(leaf.shape)) * 0.02))
    card = L._map(lambda t: t.to(dev), cpu)
    x = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    t = np.array([5, 500, 999], np.int32)
    y = np.array([0, 3, 10], np.int32)
    batch = (x, t, y, rng.standard_normal(x.shape).astype(np.float32))
    x_t = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((5, 2, 4, 8, 8)).astype(np.float32)
    labels = np.array([1, 7], np.int32)

    def run(params):
        out = DIT.forward(params, x, t, y, cfg).float().cpu()
        loss, grads = L.loss_and_grads(params, batch, cfg, loss=DIT.loss_fn)
        sample = DIT._ddim_over(params, labels, cfg, x_t, noise, steps=5,
                                eta=1.0, guidance_scale=4.0)
        return (out, float(loss), [g.float().cpu() for g in L._leaves(grads)],
                sample.float().cpu())

    K.reset_dispatch_stats()
    got = run(card)
    torch.cuda.synchronize()
    st = K.dispatch_stats()
    assert st["flash"] == st["flash_tc"] > 0, st
    assert st["flash_bwd"] == st["flash_bwd_tc"] == cfg.num_hidden_layers, st
    assert st["flash_ref"] == st["flash_bwd_ref"] == 0, st
    want = run(cpu)

    def rel(a, w):
        return float((a - w).abs().max()) / float(w.abs().max())

    assert rel(got[0], want[0]) <= 2e-2
    assert abs(got[1] - want[1]) <= 2e-2 * abs(want[1])
    for a, w in zip(got[2], want[2]):
        assert rel(a, w) <= 2e-2
    assert rel(got[3], want[3]) <= 2e-2
    assert bool(torch.isfinite(got[3]).all())


def test_kernels_raise_instead_of_falling_back(dev):
    q = torch.zeros(1, 8, 2, 12, device=dev)       # head_dim 12: no kernel
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError):
        FA.flash_attention_bwd(q, q, q, q, lse, q)
    q = torch.zeros(1, 8, 2, 32, device=dev)
    with pytest.raises(ValueError):                # lse must be float32
        FA.flash_attention_bwd(q, q, q, q, lse.double(), q)
    with pytest.raises(ValueError):
        PA.ragged_paged_attention(
            torch.zeros(1, 2, 64, device=dev),
            torch.zeros(4, 2, 16, 64, device=dev),
            torch.zeros(4, 2, 16, 64, device=dev),
            torch.zeros(1, 2, dtype=torch.int64, device=dev),   # not int32
            torch.ones(1, dtype=torch.int32, device=dev))
    codes = torch.zeros(4, 2, 16, 64, dtype=torch.int8, device=dev)
    scales = torch.zeros(4, 2, device=dev)
    bt = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    q64 = torch.zeros(1, 2, 64, device=dev)
    with pytest.raises(ValueError):                # int8 pages, no scales
        PA.ragged_paged_attention(q64, codes, codes, bt, one)
    with pytest.raises(ValueError):                # scales not float32
        PA.ragged_paged_attention(q64, codes, codes, bt, one,
                                  k_scales=scales.half(),
                                  v_scales=scales.half())
    with pytest.raises(ValueError):                # float16 q
        PA.ragged_paged_attention(q64.half(), codes, codes, bt, one,
                                  k_scales=scales, v_scales=scales)
    seg = torch.zeros(1, 8, dtype=torch.int32, device=dev)
    q12 = torch.zeros(1, 8, 2, 12, device=dev)     # head_dim 12: no kernel
    with pytest.raises(ValueError):
        FA.flash_attention_segments(q12, q12, q12, seg, seg, seg, seg)
    q264 = torch.zeros(1, 8, 2, 264, device=dev)   # above 256: no kernel
    with pytest.raises(ValueError):
        FA.flash_attention(q264, q264, q264)
    with pytest.raises(ValueError):
        FA.flash_attention_segments(q264, q264, q264, seg, seg, seg, seg)
    with pytest.raises(ValueError):                # segment ids on the CPU
        FA.flash_attention_segments(q, q, q, seg.cpu(), seg, seg, seg)
    with pytest.raises(ValueError):                # float segment ids
        FA.flash_attention_segments(q, q, q, seg.float(), seg, seg, seg)
    with pytest.raises(ValueError):                # lse must be float32
        FA.flash_attention_segments_bwd(q, q, q, q, lse.double(), q, seg,
                                        seg, seg, seg)
    qb = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device=dev)
    lse = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError):                # lse must be float32
        FA.flash_attention_segments_bwd(qb, qb, qb, qb, lse.double(), qb,
                                        seg, seg, seg, seg)
    segs = (seg, seg, seg, seg)
    cuda_cores = FA._tile_stats(segs, (FA.SEG_BLOCK, FA.SEG_BLOCK))
    with pytest.raises(RuntimeError):              # stats at other tiles
        FA.flash_attention_segments_fwd(qb, qb, qb, *segs, stats=cuda_cores)
    with pytest.raises(RuntimeError):
        FA.flash_attention_segments_bwd(qb, qb, qb, qb, lse, qb, *segs,
                                        stats=cuda_cores)
    # bf16 at D 72 takes the tensor cores or raises: stats at the CUDA-core
    # tiles, which that route's kernels would take, are refused
    q72 = torch.zeros(1, 8, 2, 72, dtype=torch.bfloat16, device=dev)
    with pytest.raises(RuntimeError):
        FA.flash_attention_segments_fwd(q72, q72, q72, *segs,
                                        stats=cuda_cores)
    with pytest.raises(RuntimeError):
        FA.flash_attention_segments_bwd(q72, q72, q72, q72, lse, q72, *segs,
                                        stats=cuda_cores)

    x = torch.zeros(4, 64, device=dev)
    with pytest.raises(ValueError):                # float16 x
        RN.rms_norm(x.half(), torch.ones(64, device=dev))
    with pytest.raises(ValueError):                # not contiguous
        RN.rms_norm(x.t(), torch.ones(4, device=dev))
    with pytest.raises(ValueError):                # d above the kernel's
        RN.rms_norm(torch.zeros(2, RN.MAX_D + 8, device=dev),
                    torch.ones(RN.MAX_D + 8, device=dev))


_RMS_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("xdt,wdt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("bf16", "f32"), ("f32", "bf16")])
@pytest.mark.parametrize("n,d", [(1, 64), (22, 4096), (8193, 5120),
                                 (64, 100), (300, 16384)])
def test_rms_norm_kernels_match_plain(dev, xdt, wdt, n, d):
    """Forward and backward kernels against their plain versions on the
    same card tensors: float32 outputs within ``1e-5 * max |ref|``
    (summation order), bfloat16 ones within ``8e-3 * max |ref|`` (one
    rounding); ``dw`` is the same bit for bit in two launches (no
    atomics). ``d = 100`` takes the backward's scalar route; ``d =
    16384`` (the largest) fills one row group of 512 threads on the bulk
    route."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, d, generator=g, device=dev).to(_RMS_DT[xdt])
    w = (1 + 0.3 * torch.randn(d, generator=g, device=dev)).to(_RMS_DT[wdt])
    dy = torch.randn(n, d, generator=g, device=dev).to(_RMS_DT[xdt])
    K.reset_dispatch_stats()
    y, rstd = RN.rms_norm_fwd(x, w, 1e-5)
    dx, dw = RN.rms_norm_bwd(x, w, rstd, dy)
    dw2 = RN.rms_norm_bwd(x, w, rstd, dy)[1]
    torch.cuda.synchronize()
    stats = K.dispatch_stats()
    assert stats["rms"] == 1 and stats["rms_bwd"] == 2
    assert stats["rms_ref"] == 0 and stats["rms_bwd_ref"] == 0
    assert torch.equal(dw, dw2)
    y_ref, rstd_ref = RN.rms_norm_ref(x, w, 1e-5)
    dx_ref, dw_ref = RN.rms_norm_bwd_ref(x, w, rstd_ref, dy)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=0)
    for got, want in ((y, y_ref), (dx, dx_ref), (dw, dw_ref)):
        assert got.dtype == want.dtype and got.shape == want.shape
        tol = 1e-5 if got.dtype == torch.float32 else 8e-3
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max()), err


def _misaligned(n, d, dtype, g, dev):
    """A contiguous ``[n, d]`` view whose data starts one element past a
    16-byte boundary."""
    buf = torch.randn(n * d + 1, generator=g, device=dev).to(dtype)
    return buf[1:].view(n, d)


@pytest.mark.parametrize("xdt,wdt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("bf16", "f32"), ("f32", "bf16")])
@pytest.mark.parametrize("case,n,d,route", [
    ("n_1", 1, 4096, "bulk"), ("n_7", 7, 4096, "bulk"),
    ("n_8193", 8193, 4096, "bulk"), ("d_100", 64, 100, "scalar"),
    ("d_16384", 300, 16384, "bulk"), ("misaligned", 40, 512, "scalar"),
    ("ring_48k", 64, 512, "bulk"), ("scalar_48k", 9, 6143, "scalar")])
def test_rms_norm_bwd_plan_edges(dev, xdt, wdt, case, n, d, route):
    """The backward at the edges of its plan: fewer rows than the grid's
    row groups (n 1, 7), rows that do not fill the last pass of the
    groups (8193), the scalar route (d 100; x, dy and w one element past
    a 16-byte boundary), one 512-thread group a block (d 16384), 48 KB of
    shared memory with the static arrays on top (d 512 bf16 on the bulk
    route: 8 rings of 3 stages of 2 KB; d 6143 on the scalar route, 8
    bytes short of it). dx and
    dw within the plain version's tolerances (float32 ``1e-5``, bfloat16
    ``8e-3`` of max |ref|), dw bit for bit in two launches."""
    g = torch.Generator(device=dev).manual_seed(1)
    xt, wt = _RMS_DT[xdt], _RMS_DT[wdt]
    if case == "misaligned":
        x, dy = (_misaligned(n, d, xt, g, dev) for _ in range(2))
        w = _misaligned(1, d, wt, g, dev)[0].mul_(0.3).add_(1)
        assert x.data_ptr() % 16 and dy.data_ptr() % 16 and w.data_ptr() % 16
    else:
        x = torch.randn(n, d, generator=g, device=dev).to(xt)
        dy = torch.randn(n, d, generator=g, device=dev).to(xt)
        w = (1 + 0.3 * torch.randn(d, generator=g, device=dev)).to(wt)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, dy))
    assert RN.bwd_plan(n, d, xt, wt, aligned).route == route
    _, rstd = RN.rms_norm_ref(x, w, 1e-5)
    K.reset_dispatch_stats()
    dx, dw = RN.rms_norm_bwd(x, w, rstd, dy)
    dw2 = RN.rms_norm_bwd(x, w, rstd, dy)[1]
    torch.cuda.synchronize()
    stats = K.dispatch_stats()
    assert stats["rms_bwd"] == 2 and stats["rms_bwd_ref"] == 0
    assert torch.equal(dw, dw2)
    dx_ref, dw_ref = RN.rms_norm_bwd_ref(x, w, rstd, dy)
    for got, want in ((dx, dx_ref), (dw, dw_ref)):
        assert got.dtype == want.dtype and got.shape == want.shape
        tol = 1e-5 if got.dtype == torch.float32 else 8e-3
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max()), err


def test_f_rms_norm_on_the_card_launches_or_raises(dev):
    """``F.rms_norm`` never takes plain math for a CUDA tensor: no weight
    (any axis), and a weight of d elements shaped ``[1, d]``, launch the
    forward kernel (``rms`` one each, within one bfloat16 ulp of the CPU);
    a weight that is not d elements, or a weight with another axis than
    the last, raises."""
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 8, 64, generator=g, device=dev).to(torch.bfloat16)
    w = 1 + 0.3 * torch.randn(64, generator=g, device=dev)
    xt = x.transpose(1, 2).contiguous()                   # [4, 64, 8]
    cases = ((x, None, -1), (xt, None, 1), (x, w.reshape(1, 64), -1))
    for xi, wi, axis in cases:
        K.reset_dispatch_stats()
        got = F.rms_norm(xi, wi, epsilon=1e-5, axis=axis)
        torch.cuda.synchronize()
        stats = K.dispatch_stats()
        assert stats["rms"] == 1, (axis, stats)
        assert stats["rms_ref"] == 0 and stats["rms_fallback"] == 0
        want = RN.rms_norm_ref(
            xi.movedim(axis, -1).cpu(),
            (torch.ones(64) if wi is None else wi.reshape(64)).cpu(),
            1e-5)[0].movedim(-1, axis)
        if wi is not None:
            want = want.float()
        assert got.shape == xi.shape and got.dtype == want.dtype
        a, b = got.cpu().float(), want.float()
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.maximum(a.abs(), b.abs()).clamp_min(1e-30))) - 7)
        assert bool(((a - b).abs() <= ulp).all())
    with pytest.raises(ValueError):                # 2 * d elements
        F.rms_norm(x, torch.ones(2, 64, device=dev))
    with pytest.raises(ValueError):                # a weight, axis 1
        F.rms_norm(xt, torch.ones(64, 1, device=dev), axis=1)


def test_eager_llama_card_matches_cpu(dev):
    """The eager ``LlamaForCausalLM`` (float32 ``llama_tiny``) with one set
    of weights, two AdamW steps on the card and on the CPU: losses to
    ``rtol=1e-5``, and the card's steps go through the RMSNorm and flash
    kernels and no plain version."""
    import numpy as np

    import paddle_tpu_torch as P
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import device as D
    from paddle_tpu_torch import optimizer as O

    cfg = L.llama_tiny(num_hidden_layers=2)
    data = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 17))
    prev = D._current_device
    losses = {}
    try:
        for where in ("cpu", "gpu"):
            P.set_device(where)
            P.seed(0)
            m = L.LlamaForCausalLM(cfg)
            if where == "cpu":
                weights = {k: v.detach().clone()
                           for k, v in m.state_dict().items()}
            else:
                m.set_state_dict(weights)
            o = O.AdamW(learning_rate=3e-3, parameters=m.parameters())
            inp, tgt = P.to_tensor(data[:, :-1]), P.to_tensor(data[:, 1:])
            K.reset_dispatch_stats()
            losses[where] = []
            for _ in range(2):
                loss = F.cross_entropy(m(inp).reshape([-1, cfg.vocab_size]),
                                       tgt.reshape([-1]))
                loss.backward()
                o.step()
                o.clear_grad()
                losses[where].append(float(loss.detach()))
            stats = K.dispatch_stats()
        assert stats["rms"] == 10 and stats["rms_bwd"] == 10
        assert stats["flash"] == 4 and stats["flash_bwd"] == 4
        assert all(v == 0 for k, v in stats.items() if k.endswith("_ref"))
        np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-5)
    finally:
        D._current_device = prev


def test_generate_and_beam_card_match_cpu(dev):
    """Ring-cache ``generate`` (greedy, then with EOS and a negative pad)
    and ``beam_search`` (3 beams, EOS) of one float32 ``llama_tiny``
    model: the card's tokens equal the CPU's, beam scores within 1e-5;
    the card's prefills go through the flash kernel."""
    import numpy as np
    cfg = L.llama_tiny()
    cpu = L.init_params(cfg, seed=0, device="cpu")
    card = L._map(lambda t: t.to(dev, copy=True), cpu)
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 7))
    eos = int(L.generate(cpu, ids, cfg, max_new_tokens=8)[0, 2])
    outs = {}
    for name, params in (("cpu", cpu), ("card", card)):
        K.reset_dispatch_stats()
        outs[name] = [
            L.generate(params, ids, cfg, max_new_tokens=8).cpu(),
            L.generate(params, ids, cfg, max_new_tokens=8, eos_token_id=eos,
                       pad_token_id=-1).cpu(),
            *(t.cpu() for t in L.beam_search(params, ids, cfg,
                                             max_new_tokens=6, num_beams=3,
                                             eos_token_id=eos))]
    stats = K.dispatch_stats()
    assert stats["flash"] == 3 * cfg.num_hidden_layers
    assert all(v == 0 for k, v in stats.items() if k.endswith("_ref"))
    for a, b in zip(outs["card"][:3], outs["cpu"][:3]):
        assert torch.equal(a, b)
    torch.testing.assert_close(outs["card"][3], outs["cpu"][3], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("mode", ["capacity", "dense"])
def test_moe_card_matches_cpu(dev, mode):
    """One float32 ``moe_tiny`` model: loss within ``rtol=1e-5`` and every
    gradient within ``1e-5`` of its tensor's largest, card against CPU;
    the engine's greedy tokens equal with full-precision and int8 pages;
    the card takes the kernels and no plain version."""
    import numpy as np

    from paddle_tpu_torch.inference import Request, ServingEngine
    from paddle_tpu_torch.models import moe as M
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = M.moe_tiny(dispatch_mode=mode)
        cpu = M.init_params(cfg, seed=0, device="cpu")
        card = L._map(lambda t: t.to(dev, copy=True), cpu)
        rng = np.random.default_rng(5)
        batch = rng.integers(0, cfg.vocab_size, (2, 17))
        trace = [(rng.integers(0, cfg.vocab_size, n), m)
                 for n, m in zip((4, 7, 3, 5), (8, 5, 9, 6))]
        res = {}
        for name, params, where in (("cpu", cpu, "cpu"), ("card", card, dev)):
            K.reset_dispatch_stats()
            loss, grads = M.loss_and_grads(params, batch, cfg)
            toks = []
            for kv_quant in (False, True):
                eng = ServingEngine(M, params, cfg, num_slots=2, max_len=16,
                                    page_size=4, num_pages=5,
                                    decode_chunk=2, kv_quant=kv_quant,
                                    device=where)
                out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                               for i, (p, m) in enumerate(trace)])
                toks.append([out[i].tokens.tolist()
                             for i in range(len(trace))])
            res[name] = (float(loss), L._leaves(grads), toks,
                         K.dispatch_stats())
        stats = res["card"][3]
        for kind in ("flash", "flash_bwd", "paged", "paged_quant"):
            assert stats[kind] > 0, stats
        assert all(v == 0 for k, v in stats.items() if k.endswith("_ref"))
        np.testing.assert_allclose(res["card"][0], res["cpu"][0], rtol=1e-5)
        for a, b in zip(res["card"][1], res["cpu"][1]):
            assert float((a.cpu() - b).abs().max()) <= \
                1e-5 * float(b.abs().max())
        assert res["card"][2] == res["cpu"][2]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_moe_bf16_step_takes_tensor_core_flash(dev):
    """A bf16 MoE train step at head dim 128 (capacity dispatch, remat
    ``"dots"``, materialising CE): a finite loss, the flash pair on its
    tensor-core route, two forward launches a layer (remat) and one
    backward."""
    from paddle_tpu_torch.models import moe as M
    cfg = M.moe_tiny(hidden_size=256, num_attention_heads=2,
                     num_key_value_heads=2, dtype=torch.bfloat16,
                     dispatch_mode="capacity", remat=True,
                     remat_policy="dots", fused_ce=False)
    params = M.init_params(cfg, seed=1, device=dev)
    state = L.adamw_init(params, moment_dtype=torch.bfloat16)
    step = M.make_train_step(cfg)
    batch = torch.randint(0, cfg.vocab_size, (2, 129), device=dev)
    K.reset_dispatch_stats()
    loss = float(step(params, state, batch)[2])
    stats = K.dispatch_stats()
    assert torch.isfinite(torch.tensor(loss))
    assert stats["flash"] == stats["flash_tc"] == 2 * cfg.num_hidden_layers
    assert stats["flash_bwd"] == stats["flash_bwd_tc"] == \
        cfg.num_hidden_layers
    assert params["layers"]["router"].dtype == torch.float32


def _chip_smoke():
    """``chip_smoke.py`` at the repo root, imported by path."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kv_quant,temperature", [(False, 0.0), (True, 0.0),
                                                  (False, 0.8)])
def test_serving_data_plane_never_syncs_the_host(dev, kv_quant,
                                                 temperature):
    """The ``ServingEngine`` serves 3 prompts of one bucket in 4 slots:
    one prefill group (padded to 4: a row of sentinel pages) and one
    decode chunk (one slot dead), with bf16 and int8 pages and with a
    sampled request. Its data plane (``_prefill_plane``,
    ``_decode_plane``) runs under ``torch.cuda.set_sync_debug_mode
    ("error")`` (any host read of the device raises); the tokens equal
    those of the same serve outside that mode, so a sampled request
    draws the same tokens again from the same seed."""
    C = _chip_smoke()
    cfg = L.llama_tiny(dtype=torch.bfloat16)
    params = L.init_params(cfg, seed=0, device=dev)
    runs = [C.serve_strict(torch, L, cfg, params, dev, kv_quant,
                           (40, 33, 50), 6, strict, temperature)
            for strict in (False, True)]
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    assert runs[1][1] == {"prefill": 1, "decode": 1}
    assert all(len(t) == 7 and ((t >= 0) & (t < cfg.vocab_size)).all()
               for t in runs[1][0])


@pytest.mark.parametrize("option,prompts,kw,want", [
    ("prefix", (40, 30, 25), dict(shared=16, warm_first=True,
                                  prefix_cache=True),
     {"prefill": 1, "prefill_shared": 1, "decode": 2}),
    ("spec", (40, 35, 50, 45), dict(chunk=2, max_new=9, spec_decode=True),
     {"prefill": 1, "spec": 1})])
def test_prefix_and_spec_planes_never_sync_the_host(dev, option, prompts, kw,
                                                    want):
    """The engine's option arms of the data plane under
    ``set_sync_debug_mode("error")`` (``chip_smoke.serve_strict``): a
    prefix-cache serve whose second group prefills its tails over the
    cached prefix (``_prefill_plane`` with ``ctx_rows``), and a
    spec-decode serve that makes one verify round (``_spec_plane``); the
    tokens equal those of the same serve outside that mode."""
    C = _chip_smoke()
    cfg = L.llama_tiny(dtype=torch.bfloat16)
    params = L.init_params(cfg, seed=0, device=dev)
    kw = dict(kw)
    chunk = kw.pop("chunk", 8)
    runs = [C.serve_strict(torch, L, cfg, params, dev, False, prompts, chunk,
                           strict, **kw) for strict in (False, True)]
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    calls = runs[1][1]
    assert {k: calls.get(k, 0) for k in want} == want, calls
    new = kw.get("max_new", chunk + 1)
    assert all(len(t) == new and ((t >= 0) & (t < cfg.vocab_size)).all()
               for t in runs[1][0])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_monitor_plane_never_syncs_the_host(dev, kv_quant):
    """``[no_sync]``'s ``monitor`` case: the same serve with the monitor
    on at exec and KV sample rates 1, its data plane under
    ``set_sync_debug_mode("error")``, gives the tokens of the serve with
    the monitor off; each prefill group and chunk takes an exec sample
    and the chunk a KV-page sample, both outside the data plane."""
    C = _chip_smoke()
    cfg = L.llama_tiny(dtype=torch.bfloat16)
    params = L.init_params(cfg, seed=0, device=dev)
    free, _ = C.serve_strict(torch, L, cfg, params, dev, kv_quant,
                             (40, 33, 50), 6, False)
    counters = {}
    strict, calls = C.serve_strict(torch, L, cfg, params, dev, kv_quant,
                                   (40, 33, 50), 6, True, monitor=counters)
    for a, b in zip(free, strict):
        np.testing.assert_array_equal(a, b)
    assert calls == {"prefill": 1, "decode": 1}
    assert counters["jit.program.exec.samples"] == 2
    assert counters["numerics.kv.samples"] == 1


@pytest.mark.parametrize("kv_quant", [False, True])
def test_monitor_planes_match_the_cpu(dev, kv_quant):
    """``[monitor_parity]`` on float32 ``llama_tiny``: the card's tokens,
    counters, histogram counts, cost records' integer fields, forensics
    event kinds and SLO alerting equal the CPU's; ``model_flops`` within
    ``chip_smoke.MONITOR_FLOPS_RTOL``."""
    C = _chip_smoke()
    cfg = L.llama_tiny()
    cpu_params = L.init_params(cfg, seed=0, device="cpu")
    card_params = L._map(lambda t: t.to(dev, copy=True), cpu_params)
    card = C.monitor_case(torch, L, cfg, card_params, dev, kv_quant)
    cpu = C.monitor_case(torch, L, cfg, cpu_params, "cpu", kv_quant)
    for k in ("tokens", "counters", "histogram_counts", "cost_ints",
              "forensics_kinds", "alerting"):
        assert card[k] == cpu[k], k
    for rid, v in cpu["model_flops"].items():
        assert abs(card["model_flops"][rid] - v) <= \
            C.MONITOR_FLOPS_RTOL * v


def test_engine_options_match_the_cpu(dev):
    """``[engine_options_parity]``'s starved case: prefix cache and spec
    decode on 14 pages for ten prompts of three prefix families, float32
    ``llama_tiny``: the card's tokens, counters (evictions, hits,
    preemptions, verify rounds) and order of admission equal the CPU's,
    and its tokens equal the card's with the options off."""
    C = _chip_smoke()
    cfg = L.llama_tiny()
    cpu_params = L.init_params(cfg, seed=0, device="cpu")
    card_params = L._map(lambda t: t.to(dev, copy=True), cpu_params)
    K.reset_dispatch_stats()
    card = C.engine_options_serve(torch, L, cfg, card_params, dev, "starved")
    torch.cuda.synchronize()
    st = K.dispatch_stats()
    cpu = C.engine_options_serve(torch, L, cfg, cpu_params, "cpu", "starved")
    off = C.engine_options_serve(torch, L, cfg, card_params, dev, "starved",
                                 options=False)
    assert card["tokens"] == cpu["tokens"] == off["tokens"]
    assert card["stats"] == cpu["stats"]
    assert card["groups"] == cpu["groups"]
    s = card["stats"]
    assert min(s["preempted"], s["prefix_evictions"], s["prefix_hits"],
               s["spec_rounds"]) > 0, s
    assert st["flash"] > 0 and st["paged"] > 0, st
    assert all(v == 0 for k, v in st.items() if k.endswith("_ref")), st


def test_overload_and_failover_match_the_cpu(dev, tmp_path):
    """``[overload_parity]``'s failover case on float32 ``llama_tiny``:
    replica A journals six requests (one sampled) and is abandoned after
    two complete; a ``FailoverCoordinator`` strands the rest and replica B
    serves them. On the card as on the CPU each rid is served exactly
    once with the uninterrupted serve's tokens (the sampled one replays
    its pinned seed's draws on its own device); the counters, the
    recovered rids and the greedy tokens equal the CPU's."""
    C = _chip_smoke()
    cfg = L.llama_tiny()
    cpu_params = L.init_params(cfg, seed=0, device="cpu")
    card_params = L._map(lambda t: t.to(dev, copy=True), cpu_params)
    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    K.reset_dispatch_stats()
    card = C.failover_case(torch, L, cfg, card_params, dev,
                           str(tmp_path / "card"))
    torch.cuda.synchronize()
    st = K.dispatch_stats()
    cpu = C.failover_case(torch, L, cfg, cpu_params, "cpu",
                          str(tmp_path / "cpu"))
    for r in (card, cpu):
        C._failover_asserts(r)
    assert card["counters"] == cpu["counters"]
    assert card["recovered"] == cpu["recovered"]
    for rid, toks in card["whole"].items():
        if rid != card["sampled"]:
            assert toks == cpu["whole"][rid], rid
    assert st["flash"] > 0 and st["paged"] > 0, st
    assert all(v == 0 for k, v in st.items() if k.endswith("_ref")), st


@pytest.mark.parametrize("temperature", [0.7, 1.5])
def test_card_sampler_follows_the_tempered_softmax(dev, temperature):
    """``_sample_rows`` on the card over 4000 rows of the same logits,
    each drawn from its own seed: every token's count lies within five
    binomial deviations of 4000 * softmax(logits / t), and the token of
    probability 0 (logit -inf) is never drawn."""
    from paddle_tpu_torch.inference.engine import _sample_rows, _token_seed
    n = 4000
    row = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -float("inf"), 0.3, 1.5])
    toks = _sample_rows(row.to(dev).expand(n, -1), [temperature] * n,
                        [_token_seed(s, 0) for s in range(n)])
    assert toks.device.type == "cuda"
    counts = np.bincount(toks.cpu().numpy(), minlength=row.numel())
    p = torch.softmax(row.double() / temperature, dim=-1).numpy()
    assert counts[5] == 0
    bound = 5 * np.sqrt(n * p * (1 - p)) + 1
    assert (np.abs(counts - n * p) <= bound).all(), (counts, n * p)


@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_optimizer_step_never_syncs_the_host(dev, clip):
    """``AdamW`` with ``amsgrad``, a scheduler and each gradient clip steps
    bf16 parameters (one with a float32 master) under
    ``set_sync_debug_mode("error")``; the parameters move."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.optimizer import lr as LR
    g = torch.Generator(device=dev).manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(64, 32, generator=g, device=dev)
                                 .to(torch.bfloat16)) for _ in range(3)]
    before = [p.detach().clone() for p in params]
    clips = {"value": O.ClipGradByValue(0.1),
             "norm": O.ClipGradByNorm(0.5),
             "global_norm": O.ClipGradByGlobalNorm(0.5)}
    sched = LR.LinearWarmup(LR.CosineAnnealingDecay(1e-2, T_max=10), 2,
                            1e-3, 1e-2)
    opt = O.AdamW(learning_rate=sched, parameters=params, weight_decay=0.1,
                  grad_clip=clips[clip], amsgrad=True, multi_precision=True)
    for p in params:
        p.grad = torch.randn(p.shape, generator=g, device=dev).to(p.dtype)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            opt.step()
            sched.step()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert all(not torch.equal(p, b) for p, b in zip(params, before))


def test_attention_surface_and_fused_rms_norm_routes(dev):
    """``F.flash_attention`` and ``flash_attn_qkvpacked`` in bf16 at head
    dim 128 launch the flash forward once on the tensor-core route and
    equal ``sdpa_raw``; a masked or dropout ``scaled_dot_product_attention``
    takes the plain math (no launch) and agrees with the CPU within
    ``2e-2``; ``fused_rms_norm`` launches ``rms`` once and equals
    ``F.rms_norm``."""
    import paddle_tpu_torch.incubate.nn.functional as IF
    import paddle_tpu_torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(2, 64, 4, 128, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    want = ATT.sdpa_raw(q, k, v, is_causal=True)
    qkv = torch.stack([q, k, v], dim=2)
    for got in (lambda: F.flash_attention(q, k, v, causal=True)[0],
                lambda: F.flash_attn_qkvpacked(qkv, causal=True)[0]):
        K.reset_dispatch_stats()
        out = got()
        torch.cuda.synchronize()
        st = K.dispatch_stats()
        assert st["flash"] == 1 and st["flash_tc"] == 1, st
        assert torch.equal(out, want)
    mask = torch.rand(2, 1, 64, 64, generator=g, device=dev) < 0.5
    mask |= torch.eye(64, dtype=torch.bool, device=dev)
    K.reset_dispatch_stats()
    out = F.scaled_dot_product_attention(q, k, v, mask, is_causal=True)
    assert K.dispatch_stats()["flash"] == 0
    ref = F.scaled_dot_product_attention(q.cpu(), k.cpu(), v.cpu(),
                                         mask.cpu(), is_causal=True)
    assert float((out.cpu().float() - ref.float()).abs().max()) <= \
        2e-2 * float(ref.float().abs().max())
    drop = F.scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    assert drop.shape == q.shape and bool(torch.isfinite(drop).all())
    x = torch.randn(8, 4, 256, generator=g, device=dev).to(torch.bfloat16)
    w = torch.ones(4, 256, device=dev, dtype=torch.bfloat16)
    K.reset_dispatch_stats()
    out = IF.fused_rms_norm(x, w, None, 1e-5, 1)[0]
    torch.cuda.synchronize()
    assert K.dispatch_stats()["rms"] == 1
    assert torch.equal(out, F.rms_norm(x.reshape(8, -1), w.reshape(-1),
                                       epsilon=1e-5).reshape(x.shape))


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_guarded_step_on_the_card(dev, family):
    """``chip_smoke.guard_checks`` on a tiny bf16 model: a clean guarded
    step equals the unguarded one bit for bit and makes exactly one host
    sync more (the gate's read of ``ok``); ``iinfo(int32).min`` and
    ``vocab_size`` ids and a tiny cap write nothing, and the CUDA context
    stays usable for the next clean step."""
    from paddle_tpu_torch.models import moe as M
    C = _chip_smoke()
    mod = {"llama": L, "moe": M}[family]
    cfg = (L.llama_tiny(dtype=torch.bfloat16) if family == "llama"
           else M.moe_tiny(dtype=torch.bfloat16))
    params = mod.init_params(cfg, seed=0, device=dev)
    state = mod.adamw_init(params)
    batch = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)), device=dev)
    r = C.guard_checks(torch, mod, cfg, params, state, batch)
    C._guard_asserts(r)


@pytest.mark.parametrize("dtype,kv_quant", [(torch.bfloat16, False),
                                            (torch.bfloat16, True),
                                            (torch.float32, False)])
def test_prefix_plane_never_syncs_the_host(dev, dtype, kv_quant):
    """``paged_prefill_shared`` and ``paged_verify_window`` on a tiny model
    under ``set_sync_debug_mode("error")``
    (``chip_smoke.prefix_plane_checks``): float32 within 1e-4 of the full
    prefill and the sequential decode, every argmax equal; bf16 bit for
    bit against the same math, full-precision and int8 pages."""
    C = _chip_smoke()
    cfg = L.llama_tiny(dtype=dtype)
    params = L.init_params(cfg, seed=0, device=dev)
    r = C.prefix_plane_checks(torch, L, cfg, params, dev, kv_quant, rows=2,
                              plen=64, shared=48, verify_lens=[17, 40, 64])
    C._prefix_asserts(r, exact=dtype == torch.float32)


@pytest.mark.parametrize("packed", [False, True])
def test_remat_attn_launch_counts_on_the_card(dev, packed):
    """Remat ``"attn"`` launches the flash forward once a layer where
    ``"full"`` launches it twice, the backward once in both, with the
    same loss and gradients bit for bit."""
    C = _chip_smoke()
    cfg = L.llama_tiny(dtype=torch.bfloat16)
    params = L.init_params(cfg, seed=0, device=dev)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)), device=dev)
    fwd, bwd = ("varlen", "varlen_bwd") if packed else ("flash", "flash_bwd")
    if packed:
        seg = torch.tensor([[0] * 20 + [1] * 12, [0] * 25 + [-1] * 7],
                           dtype=torch.int32, device=dev)
        pos = torch.cat([torch.arange(20), torch.arange(12), torch.arange(25),
                         torch.zeros(7, dtype=torch.long)]).reshape(2, 32)
        batch = (ids[:, :-1], ids[:, 1:], seg, pos.to(dev, torch.int32))
    else:
        batch = ids
    same, launches = C.remat_attn_checks(torch, cfg, params, batch)
    layers = cfg.num_hidden_layers
    assert same
    assert launches["full"][fwd] == 2 * layers
    assert launches["attn"][fwd] == layers
    assert launches["full"][bwd] == launches["attn"][bwd] == layers
