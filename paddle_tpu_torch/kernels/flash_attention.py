"""Flash attention (port of ``paddle_tpu/kernels/flash_attention.py``).

``flash_attention_fwd`` and ``flash_attention_bwd`` are the wrappers of
the hand-written CUDA kernels ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, which replace the reference's Pallas
``_fwd_kernel`` and ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``. Each C
entry takes float32, bfloat16 and float16 (the Pallas kernels keep any
float type) and has two routes, and ``tensor_core_route`` is the choice:
bfloat16 or float16 at head dim 64, 72 or 128 runs on the tensor cores
(``wgmma`` at the input type, float32 sums, P and dS rounded to the input
type before their products as the Pallas kernels round them, counted
``flash_tc`` / ``flash_bwd_tc`` besides ``flash`` / ``flash_bwd``);
float32, and bfloat16 or float16 at any other head dim, runs the float32
CUDA-core kernels. The tensor-core kernels compute at D and store
their tiles at ``64 * ceil(D / 64)`` columns: DiT-XL/2's 72 runs in D
128's tiles, its products over D in 5 k16 slices (zeros past 72) and
those whose N is D at N 72. At DiT's shapes (``[16, 256, 16, 72]``
forward, ``[32, 256, 16, 72]`` backward) bytes bound them, 0.0113 and
0.0452 ms on the H100; the columns past 72 are zero fill that reads no
memory. Both routes take every head dim ``D % 8 == 0`` from 8 to 256
(``MIN_D`` .. ``MAX_D``; the CUDA-core kernels pad D to a multiple of 16,
or of 32 above 128, with zeros). For a CUDA tensor each launches its
kernel or raises; only a CPU tensor takes the plain version
(``flash_attention_ref``, ``flash_attention_bwd_ref``). The
forward's plain version has the math of ``sdpa_reference`` (and gives a
zero row, where the reference gives NaN, for a row that sees no key, as
the kernel does); the backward gives such a row exact zero gradients.

The segment-masked (sequence-packed) variants, ``flash_attention_
segments_fwd`` / ``flash_attention_segments_bwd``, launch the same two
sources' segment entries (the reference's ``_seg_fwd_kernel``,
``_seg_bwd_dq_kernel`` / ``_seg_bwd_dkv_kernel``) on the same two routes
(counted ``varlen_tc`` / ``varlen_bwd_tc`` besides ``varlen`` /
``varlen_bwd``); their plain versions are ``segment_attention_ref`` /
``segment_attention_bwd_ref``. A token attends only to keys of its own
segment id (-1: padding, exact zero rows and gradients), causal on
segment-local positions, and the kernels skip tile pairs that the
per-tile extrema (``_seg_block_stats``) rule out, at the route's tiles
(``seg_tiles``: 128 x 128 forward and 64 x 64 backward on the tensor
cores, 32 x 32 on the CUDA cores); ``count_skipped_blocks`` counts them.

``flash_attention`` / ``flash_attention_segments`` are the
differentiable entries: ``_FlashAttention`` / ``_FlashSegAttention``
(the reference's ``_flash`` / ``_flash_seg`` custom VJPs) when autograd
needs a gradient, the forward alone otherwise. Inside ``through_ops()``
those two Functions call their forward wrapper through a registered
custom op (``torch.ops.paddle_tpu_torch.flash_fwd`` /
``flash_fwd_seg``, ``FLASH_FWD_OPS``), which selective checkpointing
sees, so remat ``"attn"`` can save exactly their ``(out, lse)``; a
recompute served from the saved outputs launches nothing. Outside it
they call the wrapper directly: the op's dispatch costs host time on
every call, and only remat ``"attn"`` needs it.
Layout: ``[B, S, H, D]`` in and out; ``lse`` is float32 ``[B, H, Sq]``;
segment ids and positions ``[B, S]`` integers.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import List, Optional, Tuple

import torch

from ..core import enforce as E
from . import _build
from ._stats import DISPATCH_STATS

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "flash_attention_bwd", "flash_attention_bwd_ref", "supported",
           "supported_bwd", "tensor_core_route", "flash_attention_segments",
           "flash_attention_segments_fwd", "flash_attention_segments_bwd",
           "segment_attention_ref", "segment_attention_bwd_ref",
           "segments_supported", "count_skipped_blocks", "SEG_BLOCK",
           "seg_tiles", "MIN_D", "MAX_D", "TC_DIMS", "TC_DTYPES",
           "through_ops",
           "FLASH_FWD_OPS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the head dims the kernels take: multiples of 8 in [MIN_D, MAX_D] (the
# C entries' bad_shape)
MIN_D, MAX_D = 8, 256


def supported(q, k, v) -> bool:
    """Whether the CUDA kernel takes these tensors."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        return False
    b, sq, h, d = q.shape
    bk, sk, kvh, dk = k.shape
    return (b == bk and d == dk and kvh >= 1 and h % kvh == 0
            and d % 8 == 0 and MIN_D <= d <= MAX_D and sq >= 1
            and sk >= 1
            and q.dtype in _DTYPES and k.dtype == q.dtype
            and v.dtype == q.dtype)


# head dims of the tensor-core kernels in bfloat16 and float16 (each
# source's tc_route, one dispatch_tc instance each a type)
TC_DIMS = (64, 72, 128)
TC_DTYPES = (torch.bfloat16, torch.float16)


def tensor_core_route(q) -> bool:
    """Whether a launch on ``q`` (a shape ``supported`` takes), dense or
    segment, runs the tensor-core kernels: bfloat16 or float16 at a head
    dim of ``TC_DIMS``, the choice the C entries make (``tc_route``)."""
    return q.dtype in TC_DTYPES and q.shape[-1] in TC_DIMS


def flash_attention_ref(q, k, v, *, causal=False, scale=None):
    """Plain version: ``(out [B, Sq, H, D], lse f32 [B, H, Sq])``."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if kt.shape[1] != qt.shape[1]:
        rep = qt.shape[1] // kt.shape[1]
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    seen = torch.isfinite(lse)[..., None]
    probs = torch.where(seen, torch.softmax(logits, dim=-1), 0.0)
    out = torch.matmul(probs.to(q.dtype).float(), vt.float()).to(q.dtype)
    return out.transpose(1, 2), lse


def flash_attention_fwd(q, k, v, *, causal=False, scale=None):
    """``(out, lse)``: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Raises for a CUDA tensor the kernel does not take."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        DISPATCH_STATS["flash_ref"] += 1
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    E.enforce(q.is_cuda and k.device == q.device and v.device == q.device,
              f"flash_attention: q/k/v must lie on one CUDA device, got "
              f"{q.device}, {k.device}, {v.device}",
              error=E.InvalidArgumentError)
    E.enforce(supported(q, k, v),
              f"flash_attention: the CUDA kernel does not take q "
              f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
              f"v {tuple(v.shape)} {v.dtype} (needs [B, S, H, D] with "
              f"H % KVH == 0, D % 8 == 0, {MIN_D} <= D <= {MAX_D}, "
              f"float32, bfloat16 or float16)",
              error=E.InvalidArgumentError)
    E.enforce(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
              "flash_attention: q/k/v must be contiguous",
              error=E.InvalidArgumentError)
    _build.check_device(q, "flash_attention")
    lib = _lib()
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), b, sq, sk, h, kvh, d,
                        float(scale), int(bool(causal)), _DTYPES[q.dtype],
                        torch.cuda.current_stream(q.device).cuda_stream)
    DISPATCH_STATS["flash"] += 1
    DISPATCH_STATS["flash_tc"] += tensor_core_route(q)
    DISPATCH_STATS["flash_d72"] += tensor_core_route(q) and d == 72
    _build.check_launch("flash_fwd", err)
    return out, lse


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` as a dispatcher op (same dispatch: the
    kernel for CUDA tensors, the plain version for CPU tensors)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, scale):
    b, sq, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, sq), dtype=torch.float32))


def supported_bwd(q, k, v) -> bool:
    """Whether the CUDA backward kernels take these tensors (the forward's
    limits, and a grid of at most 65535 heads)."""
    return supported(q, k, v) and q.shape[0] * q.shape[2] <= 65535


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal=False,
                            scale=None):
    """Plain version of the backward: ``(dq, dk, dv)`` in the inputs'
    layouts and dtypes, the math of the reference's ``_bwd`` in float32:
    ``p = exp(q.k * scale - lse)`` (zero where masked), ``delta =
    rowsum(dout * out)``, ``ds = p * (dout.v - delta)``; dk / dv are
    summed over each kv head's group of query heads."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    b, sq, h, _ = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qt, dot = q.transpose(1, 2).float(), dout.transpose(1, 2).float()
    kt = k.transpose(1, 2).float().repeat_interleave(g, dim=1)
    vt = v.transpose(1, 2).float().repeat_interleave(g, dim=1)
    s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    seen = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        seen = seen.tril(diagonal=sk - sq)
    p = torch.exp(torch.where(seen, s - lse[..., None], float("-inf")))
    delta = (dot * out.transpose(1, 2).float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dot, vt.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kt) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qt) * scale
    dv = torch.matmul(p.transpose(-1, -2), dot)
    dk = dk.reshape(b, kvh, g, sk, d).sum(2)
    dv = dv.reshape(b, kvh, g, sk, d).sum(2)
    return (dq.transpose(1, 2).contiguous().to(q.dtype),
            dk.transpose(1, 2).contiguous().to(k.dtype),
            dv.transpose(1, 2).contiguous().to(v.dtype))


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=False,
                        scale=None):
    """``(dq, dk, dv)`` from the forward's inputs, its output and lse and
    the output gradient: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors. Raises for CUDA tensors the kernels do not
    take."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        DISPATCH_STATS["flash_bwd_ref"] += 1
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, scale=scale)
    tensors = (q, k, v, out, lse, dout)
    E.enforce(q.is_cuda and all(t.device == q.device for t in tensors),
              "flash_attention_bwd: q/k/v/out/lse/dout must lie on one "
              f"CUDA device, got {[str(t.device) for t in tensors]}",
              error=E.InvalidArgumentError)
    b, sq, h, d = q.shape
    E.enforce(supported_bwd(q, k, v) and out.shape == q.shape
              and dout.shape == q.shape and out.dtype == q.dtype
              and dout.dtype == q.dtype and lse.shape == (b, h, sq)
              and lse.dtype == torch.float32,
              f"flash_attention_bwd: the CUDA kernels do not take q "
              f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
              f"v {tuple(v.shape)} {v.dtype}, out {tuple(out.shape)} "
              f"{out.dtype}, lse {tuple(lse.shape)} {lse.dtype}, dout "
              f"{tuple(dout.shape)} {dout.dtype} (needs the forward's "
              f"limits, B * H <= 65535, out / dout like q, lse float32 "
              f"[B, H, Sq])", error=E.InvalidArgumentError)
    E.enforce(all(t.is_contiguous() for t in tensors),
              "flash_attention_bwd: inputs must be contiguous",
              error=E.InvalidArgumentError)
    _build.check_device(q, "flash_attention_bwd")
    lib = _lib_bwd()
    sk, kvh = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = lib.flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        delta.data_ptr(), b, sq, sk, h, kvh, d, float(scale),
                        int(bool(causal)), _DTYPES[q.dtype],
                        torch.cuda.current_stream(q.device).cuda_stream)
    DISPATCH_STATS["flash_bwd"] += 1
    DISPATCH_STATS["flash_bwd_tc"] += tensor_core_route(q)
    DISPATCH_STATS["flash_bwd_d72"] += tensor_core_route(q) and d == 72
    _build.check_launch("flash_bwd", err)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the forward wrapper saves
    ``q, k, v, out, lse``; the backward wrapper turns them and the output
    gradient into ``dq, dk, dv``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if _THROUGH_OPS:
            out, lse = _flash_fwd_op(q, k, v, causal, scale)
        else:
            out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                           scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(),
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=False, scale=None):
    """Attention output ``[B, Sq, H, D]``, differentiable. Through
    ``_FlashAttention`` when autograd needs a gradient of q, k or v; under
    ``torch.no_grad()`` / inference mode, or when no input requires grad,
    the forward wrapper alone (no saved tensors)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]


# -- segment-masked (sequence-packed) attention --------------------------------

SEG_BLOCK = 32      # the CUDA-core kernels' tile, rows and keys
# the tensor-core kernels' tiles: forward 128 x 128 (TC_BM x TC_BN), dq
# and dkv 64 x 64 (a warpgroup's rows or keys against a tile)
_SEG_TC_FWD, _SEG_TC_BWD = (128, 128), (64, 64)
# rows of the tile stats (int32 [8, B * stride]): the reference's six,
# then each q tile's position minimum and each k tile's position maximum
# (csrc/segment_tiles.cuh)
(_ST_QSMIN, _ST_QSMAX, _ST_KSMIN, _ST_KSMAX, _ST_QPMAX, _ST_KPMIN,
 _ST_QPMIN, _ST_KPMAX) = range(8)
_I32 = torch.iinfo(torch.int32)


def seg_tiles(q, backward=False):
    """``(block_q, block_k)``: the tiles the segment kernels run for a
    launch on ``q``, forward or backward (``tensor_core_route`` picks the
    route). The tile stats, the skip predicate and ``tiles_ran`` are at
    these tiles."""
    if tensor_core_route(q):
        return _SEG_TC_BWD if backward else _SEG_TC_FWD
    return SEG_BLOCK, SEG_BLOCK


def _seg_block_stats(seg_q, seg_k, pos_q, pos_k, block_q, block_k):
    """Per-tile segment / position extrema for the skip predicate, the
    reference's layout: ``(stats int32 [8, B * stride], stride)`` with q
    tiles at ``b * stride + qi`` and k tiles at ``b * stride + ki``
    (zero past each side's tile count). Rows 0-5 are the reference's;
    rows 6-7, each q tile's position minimum and each k tile's position
    maximum, mark the tiles whose pairs are all visible
    (``_tiles_full``). A ragged last tile takes the extrema of the tokens
    it holds, so S need not divide the tile."""
    b, sq = seg_q.shape
    sk = seg_k.shape[1]
    nq, nk = -(-sq // block_q), -(-sk // block_k)
    stride = max(nq, nk)

    def extrema(a, block, n, lowest):
        a = a.to(torch.int32)
        fill = _I32.max if lowest else _I32.min
        if n * block > a.shape[1]:
            a = torch.cat([a, a.new_full((b, n * block - a.shape[1]), fill)],
                          dim=1)
        a = a.reshape(b, n, block)
        r = a.amin(-1) if lowest else a.amax(-1)
        return torch.cat([r, r.new_zeros((b, stride - n))], dim=1)

    stats = torch.stack([
        extrema(seg_q, block_q, nq, True), extrema(seg_q, block_q, nq, False),
        extrema(seg_k, block_k, nk, True), extrema(seg_k, block_k, nk, False),
        extrema(pos_q, block_q, nq, False), extrema(pos_k, block_k, nk, True),
        extrema(pos_q, block_q, nq, True), extrema(pos_k, block_k, nk, False),
    ]).reshape(8, b * stride).contiguous()
    return stats, stride


def _tiles_run(stats, stride, b, nq, nk, causal):
    """bool ``[B, nq, nk]``: the reference's ``_seg_run_predicate`` over
    every tile pair. Segment intervals ``[max(min, 0), max]`` overlap
    (conservative for any layout, exact for contiguous packing) and, when
    causal, some key is not in the future of every row (``min pos_k <=
    max pos_q``)."""
    st = stats.reshape(-1, b, stride)
    qsmin, qsmax = st[_ST_QSMIN, :, :nq], st[_ST_QSMAX, :, :nq]
    ksmin, ksmax = st[_ST_KSMIN, :, :nk], st[_ST_KSMAX, :, :nk]
    run = ((qsmax[:, :, None] >= 0) & (ksmax[:, None, :] >= 0)
           & (qsmin.clamp(min=0)[:, :, None] <= ksmax[:, None, :])
           & (ksmin.clamp(min=0)[:, None, :] <= qsmax[:, :, None]))
    if causal:
        run = run & (st[_ST_KPMIN, :, None, :nk]
                     <= st[_ST_QPMAX, :, :nq, None])
    return run


def _tiles_full(stats, stride, b, nq, nk, causal):
    """bool ``[B, nq, nk]``: the tile pairs whose every pair is visible
    (the kernels' ``seg::full``), which need no element mask: one segment
    ``>= 0`` on both sides and, when causal, no key after any row (``max
    pos_k <= min pos_q``)."""
    st = stats.reshape(-1, b, stride)
    s = st[_ST_QSMIN, :, :nq, None]
    full = ((s >= 0) & (st[_ST_QSMAX, :, :nq, None] == s)
            & (st[_ST_KSMIN, :, None, :nk] == s)
            & (st[_ST_KSMAX, :, None, :nk] == s))
    if causal:
        full = full & (st[_ST_KPMAX, :, None, :nk]
                       <= st[_ST_QPMIN, :, :nq, None])
    return full


def count_skipped_blocks(seg_q, seg_k, pos_q, pos_k, block_q, block_k,
                         causal):
    """``(skipped, total)`` tile pairs of one head's grid under the skip
    predicate the kernels run (every head sees the same layout). Inputs
    ``[B, S]`` integers; at a route's tiles (``seg_tiles``) the skipped
    count is the kernels' own."""
    seg_q, seg_k, pos_q, pos_k = (torch.as_tensor(a)
                                  for a in (seg_q, seg_k, pos_q, pos_k))
    b, sq = seg_q.shape
    nq, nk = -(-sq // block_q), -(-seg_k.shape[1] // block_k)
    stats, stride = _seg_block_stats(seg_q, seg_k, pos_q, pos_k, block_q,
                                     block_k)
    total = b * nq * nk
    return total - int(_tiles_run(stats, stride, b, nq, nk, causal).sum()), \
        total


def _seg_mask(seg_q, seg_k, pos_q, pos_k, causal):
    """bool ``[B, Sq, Sk]``: same segment id ``>= 0`` and, when causal,
    ``pos_q >= pos_k``."""
    seg_q, seg_k = seg_q.long(), seg_k.long()
    same = (seg_q[:, :, None] == seg_k[:, None, :]) & (seg_q[:, :, None] >= 0)
    if causal:
        same = same & (pos_q.long()[:, :, None] >= pos_k.long()[:, None, :])
    return same


def segment_attention_ref(q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                          causal=False, scale=None):
    """Plain version of the segment forward, the reference's
    ``segment_attention_ref`` math in float32: ``(out [B, Sq, H, D],
    lse f32 [B, H, Sq])``. Same-segment block-diagonal mask, causal on
    segment-local positions, padding (``seg < 0``) rows exactly zero with
    ``lse = -inf``; GQA contracts each kv head with its group of query
    heads without repeating k / v."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q5 = q.float().reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k.float()) * scale
    mask = _seg_mask(seg_q, seg_k, pos_q, pos_k, causal)[:, None, None]
    s.masked_fill_(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    # a row that sees no key has m = -inf: the clamp keeps s - m from
    # forming -inf - -inf (NaN) there
    e = torch.where(mask, torch.exp(s - m.clamp(min=-3e38)), 0.0)
    del s
    l = e.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", e / torch.where(l == 0, 1.0, l),
                       v.float())
    lse = torch.where(l > 0, m + torch.log(l), float("-inf"))
    return (out.reshape(b, sq, h, d).to(q.dtype),
            lse.reshape(b, h, sq))


def segment_attention_bwd_ref(q, k, v, out, lse, dout, seg_q, seg_k, pos_q,
                              pos_k, *, causal=False, scale=None):
    """Plain version of the segment backward, the math of the reference's
    ``_seg_bwd`` in float32: ``p`` is zeroed by the mask before any
    exponential, so padding rows and padding keys get exact zero ``dq`` /
    ``dk`` / ``dv``; dk and dv are summed over each kv head's group."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q5 = q.float().reshape(b, sq, kvh, g, d)
    do5 = dout.float().reshape(b, sq, kvh, g, d)
    kf, vf = k.float(), v.float()
    mask = _seg_mask(seg_q, seg_k, pos_q, pos_k, causal)[:, None, None]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, kf) * scale
    s -= lse.reshape(b, kvh, g, sq, 1)
    p = torch.exp(s.masked_fill_(~mask, float("-inf")))
    del s
    delta = (do5 * out.float().reshape(b, sq, kvh, g, d)).sum(-1)
    ds = torch.einsum("bqhgd,bkhd->bhgqk", do5, vf)
    ds -= delta.permute(0, 2, 3, 1)[..., None]
    ds *= p
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q5) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do5)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


_INT_DTYPES = (torch.int32, torch.int64)


def segments_supported(q, k, v, seg_q, seg_k, pos_q, pos_k) -> bool:
    """Whether the CUDA segment kernels take these tensors: the dense
    kernels' limits (``supported_bwd``), and int32 or int64 segment ids
    and positions of ``[B, Sq]`` (query side) and ``[B, Sk]`` (key
    side)."""
    if not supported_bwd(q, k, v):
        return False
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    return all(isinstance(a, torch.Tensor) and a.dtype in _INT_DTYPES
               and tuple(a.shape) == shape
               for a, shape in ((seg_q, (b, sq)), (pos_q, (b, sq)),
                                (seg_k, (b, sk)), (pos_k, (b, sk))))


def _seg_check(what, q, k, v, segs, extra=()):
    """Device, shape and contiguity checks of a CUDA segment call; the
    segment ids and positions come back as contiguous int32."""
    tensors = (q, k, v, *segs, *extra)
    E.enforce(q.is_cuda and all(isinstance(t, torch.Tensor)
                                and t.device == q.device for t in tensors),
              f"{what}: every tensor must lie on one CUDA device, got "
              f"{[str(getattr(t, 'device', type(t))) for t in tensors]}",
              error=E.InvalidArgumentError)
    E.enforce(segments_supported(q, k, v, *segs),
              f"{what}: the CUDA kernels do not take q {tuple(q.shape)} "
              f"{q.dtype}, k {tuple(k.shape)} {k.dtype}, v "
              f"{tuple(v.shape)} {v.dtype}, segment ids / positions "
              f"{[(tuple(a.shape), a.dtype) for a in segs]} (needs the "
              f"dense kernels' limits and int32 / int64 [B, Sq] and "
              f"[B, Sk] segment ids and positions)",
              error=E.InvalidArgumentError)
    E.enforce(all(t.is_contiguous() for t in (q, k, v, *extra)),
              f"{what}: inputs must be contiguous",
              error=E.InvalidArgumentError)
    _build.check_device(q, what)
    return tuple(a.to(torch.int32).contiguous() for a in segs)


def _tile_stats(segs, tiles):
    """``(stats, stride, tiles)``: the tile extrema at ``tiles`` (a
    route's ``seg_tiles``), which the C entries check against the tiles
    they run."""
    return (*_seg_block_stats(*segs, *tiles), tuple(tiles))


def flash_attention_segments_fwd(q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                                 causal=False, scale=None, stats=None,
                                 tiles_ran=None):
    """``(out, lse)`` of segment-masked attention: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Raises for a CUDA
    tensor the kernel does not take.

    ``stats`` is ``_tile_stats`` at ``seg_tiles(q)`` (computed here when
    None). ``tiles_ran``, CUDA only, is an int32 tensor of one element to
    which the kernel adds one for every (batch, head, q tile, k tile) it
    computes, at ``seg_tiles(q)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    segs = (seg_q, seg_k, pos_q, pos_k)
    if q.device.type == "cpu":
        E.enforce(tiles_ran is None, "flash_attention_segments_fwd: "
                  "tiles_ran counts the CUDA kernel's tiles; the plain "
                  "version has none", error=E.InvalidArgumentError)
        DISPATCH_STATS["varlen_ref"] += 1
        return segment_attention_ref(q, k, v, *segs, causal=causal,
                                     scale=scale)
    extra = () if tiles_ran is None else (tiles_ran,)
    segs = _seg_check("flash_attention_segments", q, k, v, segs, extra)
    E.enforce(tiles_ran is None or (tiles_ran.dtype == torch.int32
                                    and tiles_ran.numel() == 1),
              "flash_attention_segments_fwd: tiles_ran must be one int32",
              error=E.InvalidArgumentError)
    stats, stride, tiles = (stats if stats is not None
                            else _tile_stats(segs, seg_tiles(q)))
    lib = _lib()
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd_seg(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *(a.data_ptr() for a in segs), stats.data_ptr(),
        None if tiles_ran is None else tiles_ran.data_ptr(), b, sq, sk, h,
        kvh, d, stride, *tiles, float(scale), int(bool(causal)),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    DISPATCH_STATS["varlen"] += 1
    DISPATCH_STATS["varlen_tc"] += tensor_core_route(q)
    _build.check_launch("flash_fwd_seg", err)
    return out, lse


def flash_attention_segments_bwd(q, k, v, out, lse, dout, seg_q, seg_k,
                                 pos_q, pos_k, *, causal=False, scale=None,
                                 stats=None):
    """``(dq, dk, dv)`` of segment-masked attention from the forward's
    inputs, its output and lse and the output gradient: the CUDA kernels
    for CUDA tensors (``stats`` as in the forward, at ``seg_tiles(q,
    backward=True)``), the plain version for CPU tensors. Raises for CUDA
    tensors the kernels do not take."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    segs = (seg_q, seg_k, pos_q, pos_k)
    if q.device.type == "cpu":
        DISPATCH_STATS["varlen_bwd_ref"] += 1
        return segment_attention_bwd_ref(q, k, v, out, lse, dout, *segs,
                                         causal=causal, scale=scale)
    b, sq, h, d = q.shape
    E.enforce(out.shape == q.shape and dout.shape == q.shape
              and out.dtype == q.dtype and dout.dtype == q.dtype
              and lse.shape == (b, h, sq) and lse.dtype == torch.float32,
              f"flash_attention_segments_bwd: out {tuple(out.shape)} "
              f"{out.dtype}, dout {tuple(dout.shape)} {dout.dtype} must be "
              f"like q {tuple(q.shape)} {q.dtype}, lse {tuple(lse.shape)} "
              f"{lse.dtype} float32 [B, H, Sq]",
              error=E.InvalidArgumentError)
    segs = _seg_check("flash_attention_segments_bwd", q, k, v, segs,
                      (out, lse, dout))
    stats, stride, tiles = (stats if stats is not None else _tile_stats(
        segs, seg_tiles(q, backward=True)))
    lib = _lib_bwd()
    sk, kvh = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = lib.flash_bwd_seg(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), *(a.data_ptr() for a in segs),
        stats.data_ptr(), b, sq, sk, h, kvh, d, stride, *tiles,
        float(scale), int(bool(causal)), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    DISPATCH_STATS["varlen_bwd"] += 1
    DISPATCH_STATS["varlen_bwd_tc"] += tensor_core_route(q)
    _build.check_launch("flash_bwd_seg", err)
    return dq, dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_fwd_seg",
                         mutates_args=())
def _flash_seg_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      seg_q: torch.Tensor, seg_k: torch.Tensor,
                      pos_q: torch.Tensor, pos_k: torch.Tensor,
                      stats: Optional[torch.Tensor], stride: int,
                      tiles: List[int], causal: bool, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_segments_fwd`` as a dispatcher op; ``stats``,
    ``stride`` and ``tiles`` are ``_tile_stats``' three parts (``stats``
    None on the CPU)."""
    return flash_attention_segments_fwd(
        q, k, v, seg_q, seg_k, pos_q, pos_k, causal=causal, scale=scale,
        stats=None if stats is None else (stats, stride, tuple(tiles)))


@_flash_seg_fwd_op.register_fake
def _(q, k, v, seg_q, seg_k, pos_q, pos_k, stats, stride, tiles, causal,
      scale):
    b, sq, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, sq), dtype=torch.float32))


class _FlashSegAttention(torch.autograd.Function):
    """The reference's ``_flash_seg`` custom VJP: the forward wrapper
    saves ``q, k, v, out, lse``, the segment ids and positions and, on
    the card, the backward kernels' tile stats (``seg_tiles(q,
    backward=True)``; the same tensor as the forward's when the tiles
    agree)."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, pos_q, pos_k, causal, scale):
        segs = (seg_q, seg_k, pos_q, pos_k)
        stats = bwd_stats = None
        if q.is_cuda:
            segs = _seg_check("flash_attention_segments", q, k, v, segs)
            stats = _tile_stats(segs, seg_tiles(q))
            tiles = seg_tiles(q, backward=True)
            bwd_stats = (stats if stats[2] == tiles
                         else _tile_stats(segs, tiles))
        if _THROUGH_OPS:
            out, lse = _flash_seg_fwd_op(
                q, k, v, *segs, None if stats is None else stats[0],
                0 if stats is None else stats[1],
                [] if stats is None else list(stats[2]), causal, scale)
        else:
            out, lse = flash_attention_segments_fwd(
                q, k, v, *segs, causal=causal, scale=scale, stats=stats)
        ctx.save_for_backward(q, k, v, out, lse, *segs,
                              None if bwd_stats is None else bwd_stats[0])
        ctx.causal, ctx.scale = causal, scale
        ctx.stats_layout = None if bwd_stats is None else bwd_stats[1:]
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, *segs, stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_segments_bwd(
            q, k, v, out, lse, dout.contiguous(), *segs, causal=ctx.causal,
            scale=ctx.scale,
            stats=None if stats is None else (stats, *ctx.stats_layout))
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_segments(q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                             causal=False, scale=None):
    """Segment-masked attention output ``[B, Sq, H, D]`` on packed rows,
    differentiable (the reference's ``flash_attention_segments``).

    ``seg_q`` / ``seg_k`` ``[B, Sq]`` / ``[B, Sk]`` tag each token with
    its document (-1 = padding: exact zero rows and gradients); tokens
    attend only within their segment, and ``causal`` masks on the
    segment-local ``pos_q`` / ``pos_k``. Through ``_FlashSegAttention``
    when autograd needs a gradient of q, k or v, the forward wrapper
    alone otherwise."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashSegAttention.apply(q, k, v, seg_q, seg_k, pos_q, pos_k,
                                        bool(causal), float(scale))
    return flash_attention_segments_fwd(q, k, v, seg_q, seg_k, pos_q, pos_k,
                                        causal=causal, scale=scale)[0]


# the registered forward ops whose outputs remat "attn" saves
FLASH_FWD_OPS = (torch.ops.paddle_tpu_torch.flash_fwd.default,
                 torch.ops.paddle_tpu_torch.flash_fwd_seg.default)
_THROUGH_OPS = 0        # depth of open through_ops() contexts


@contextlib.contextmanager
def through_ops():
    """Within this context ``_FlashAttention`` / ``_FlashSegAttention``
    call their forward wrapper through its registered op
    (``FLASH_FWD_OPS``), the one form of the launch that selective
    checkpointing can save; remat ``"attn"`` opens it around a layer's
    forward and its recompute."""
    global _THROUGH_OPS
    _THROUGH_OPS += 1
    try:
        yield
    finally:
        _THROUGH_OPS -= 1


def _lib():
    lib = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, i,
                                  p]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_seg.argtypes = [p] * 11 + [i] * 9 + [f, i, i, p]
        lib.flash_fwd_seg.restype = ctypes.c_int
    return lib


def _lib_bwd():
    lib = _build.load("flash_bwd")
    if lib.flash_bwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_bwd.argtypes = [p] * 10 + [i] * 6 + [f, i, i, p]
        lib.flash_bwd.restype = ctypes.c_int
        lib.flash_bwd_seg.argtypes = [p] * 15 + [i] * 9 + [f, i, i, p]
        lib.flash_bwd_seg.restype = ctypes.c_int
    return lib
