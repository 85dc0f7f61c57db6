"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

``sdpa_raw`` is the kernel seam the model cores call: it hands every
call without a mask or dropout to the flash wrappers
(``kernels/flash_attention.py``), which launch the CUDA kernels for CUDA
tensors and take the plain versions for CPU tensors; with
``segment_ids`` it takes the segment-masked (sequence-packed) path,
``segment_attention_raw``. A mask or dropout takes ``sdpa_reference``,
the plain math path, on every device, as in the reference (which has no
Pallas kernel for them). The varlen surface (``flash_attn_unpadded``,
``flash_attn_varlen_qkvpacked``) is a second entry to the same segment
kernels, on packed ``[T, H, D]`` tensors with ``cu_seqlens`` prefix
sums. Layout is the reference's ``[B, S, H, D]``.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ...core import enforce as E
from ...ops._op import op_fn

__all__ = ["rope_tables", "rope_raw", "gather_rope_rows", "sdpa_reference",
           "sdpa_raw", "scaled_dot_product_attention", "flash_attention",
           "apply_rotary_emb", "fused_rotary_position_embedding",
           "segment_attention_raw", "segment_ids_from_cu_seqlens",
           "flash_attn_unpadded", "flash_attn_qkvpacked",
           "flash_attn_varlen_qkvpacked", "flash_attention_with_sparse_mask"]

# False inside ``sdp_kernel(enable_flash=False)``: the dense and segment
# paths take their plain math instead of the kernels (the reference
# unregisters its flash and segment dispatchers there)
_FLASH_ENABLED = True


def segment_attention_raw(q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                          causal=False, scale=None):
    """Segment-masked attention on ``[B, S, H, D]`` (the kernel seam of
    ``sdpa_raw``'s packed path and the varlen surface): the dispatcher
    ``kernels.dispatched_segment_attention``, or with the flash path
    switched off (``sdp_kernel``) the plain ``segment_attention_ref``."""
    if not _FLASH_ENABLED:
        from ...kernels.flash_attention import segment_attention_ref
        return segment_attention_ref(q, k, v, seg_q, seg_k, pos_q, pos_k,
                                     causal=causal, scale=scale)[0]
    from ...kernels import dispatched_segment_attention
    return dispatched_segment_attention(q, k, v, seg_q, seg_k, pos_q, pos_k,
                                        causal=causal, scale=scale)


def sdpa_reference(q, k, v, attn_mask=None, *, causal=False, scale=None,
                   dropout_p=0.0, generator=None):
    """Math attention on ``[B, S, H, D]`` with a float32 softmax, plain
    PyTorch and differentiable by autograd. GQA repeats each kv head over
    its group of query heads; the causal mask is bottom-right aligned
    (query row ``r`` sees keys ``<= r + Sk - Sq``). ``attn_mask``
    broadcasts against ``[B, H, Sq, Sk]``: a boolean one keeps the
    scores where it is true, any other is added to them. A fully masked
    row is NaN, as in the reference. With ``dropout_p > 0`` and a
    ``generator``, each probability (in ``q``'s type) is kept with
    probability ``1 - dropout_p`` and scaled by ``1 / (1 - dropout_p)``,
    the rest zeroed; without a generator there is no dropout, as the
    reference has none without a key."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
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
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and generator is not None:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    out = torch.matmul(probs.float(), vt.float()).to(q.dtype)
    return out.transpose(1, 2)


def sdpa_raw(query, key, value, attn_mask=None, *, dropout_p: float = 0.0,
             is_causal: bool = False, generator=None, scale=None,
             segment_ids=None, positions=None):
    """Attention dispatcher on ``[B, S, H, D]``: the flash wrappers, whose
    device decides kernel (CUDA) or plain version (CPU), when there is no
    mask and no dropout; else ``sdpa_reference`` (dropout draws from
    ``generator``, the reference's ``rng_key``).

    ``segment_ids`` ``[B, S]`` selects the sequence-packed path: tokens
    attend only within their own document (-1 = padding: zero rows), with
    ``is_causal`` evaluated on the segment-local ``positions`` ``[B, S]``
    (default: the global arange, which is the segment-local order for
    contiguously packed rows). A mask or dropout with ``segment_ids``
    raises, as in the reference (the packed mask is the mask).

    DTensor q / k / v (a mesh) take ``_sdpa_sharded``: the same kernels on
    each rank's local shards."""
    if isinstance(query, DTensor):
        return _sdpa_sharded(query, key, value, attn_mask, dropout_p,
                             is_causal, scale, segment_ids, positions)
    if segment_ids is not None:
        if attn_mask is not None or dropout_p != 0.0:
            raise NotImplementedError(
                "sdpa_raw: attn_mask/dropout are not supported together "
                "with segment_ids (the packed mask IS the mask)")
        pos = positions
        if pos is None:
            pos = torch.arange(query.shape[1], device=segment_ids.device)
            pos = pos.expand(segment_ids.shape)
        return segment_attention_raw(query, key, value, segment_ids,
                                     segment_ids, pos, pos,
                                     causal=is_causal, scale=scale)
    if _FLASH_ENABLED and attn_mask is None and dropout_p == 0.0:
        from ...kernels.flash_attention import flash_attention
        return flash_attention(query, key, value, causal=is_causal,
                               scale=scale)
    return sdpa_reference(query, key, value, attn_mask, causal=is_causal,
                          scale=scale, dropout_p=dropout_p,
                          generator=generator)


def _sdpa_sharded(q, k, v, attn_mask, dropout_p, is_causal, scale,
                  segment_ids, positions):
    """``sdpa_raw`` of DTensors: q is sharded on its batch (dim 0) and
    heads (dim 2) only, never on the sequence; k / v and the segment
    arrays are placed to match, and each rank runs ``sdpa_raw`` (the
    flash kernels on the card) on its ``.contiguous()`` local shards,
    wrapped back with q's placements. A local shard the kernel refuses
    raises there; nothing is gathered to run the plain version.

    When the kv heads do not split over the head shards (fewer kv heads
    than tp), k and v are placed with whole heads and each kv head is
    repeated ``shards // kv_heads`` times (``repeat_interleave``) before
    the split, so rank ``t`` holds kv head ``t // r``: the one its query
    heads use."""
    from ...distributed import spmd
    if attn_mask is not None or dropout_p != 0.0:
        raise NotImplementedError(
            "sdpa_raw: masks and dropout are not supported on a mesh")
    mesh = q.device_mesh
    pl = q.placements
    E.enforce(all(isinstance(p, Replicate) or
                  (isinstance(p, Shard) and p.dim in (0, 2)) for p in pl),
              f"sdpa_raw: a mesh's q must be sharded on batch or heads "
              f"only, got {pl}", error=E.InvalidArgumentError)
    shards = math.prod(mesh.size(i) for i, p in enumerate(pl)
                       if p == Shard(2))
    nkv = k.shape[2]
    if nkv % shards:
        E.enforce(shards % nkv == 0,
                  f"sdpa_raw: {nkv} kv heads do not tile {shards} head "
                  f"shards", error=E.InvalidArgumentError)
        whole = tuple(Replicate() if p == Shard(2) else p for p in pl)
        r = shards // nkv

        def rep(t):
            return t.repeat_interleave(r, dim=2)

        k = spmd.local(rep, mesh, whole, k.redistribute(mesh, whole))
        v = spmd.local(rep, mesh, whole, v.redistribute(mesh, whole))
    k, v = k.redistribute(mesh, pl), v.redistribute(mesh, pl)
    out = pl
    if segment_ids is None:
        return spmd.local(
            lambda a, b, c: sdpa_raw(a.contiguous(), b.contiguous(),
                                     c.contiguous(), is_causal=is_causal,
                                     scale=scale), mesh, out, q, k, v)
    rows = tuple(p if p == Shard(0) else Replicate() for p in pl)
    seg = segment_ids.redistribute(mesh, rows)
    pos = seg if positions is None else positions.redistribute(mesh, rows)

    def packed(a, b, c, sg, ps):
        return sdpa_raw(a.contiguous(), b.contiguous(), c.contiguous(),
                        is_causal=is_causal, scale=scale, segment_ids=sg,
                        positions=None if positions is None else ps)

    return spmd.local(packed, mesh, out, q, k, v, seg, pos)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None,
                                 scale=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` on ``[B, S,
    H, D]``, through ``sdpa_raw`` (without a mask or dropout the flash
    kernels on the card, differentiable through ``_FlashAttention``).
    Dropout applies only while ``training``, drawn from the seeded
    generator of the query's device (``framework.random``)."""
    del name
    from ...framework.random import default_generator
    p = dropout_p if training else 0.0
    gen = default_generator(query.device) if p > 0.0 else None
    return _sdpa_op(query, key, value, attn_mask, dropout_p=p,
                    is_causal=is_causal, generator=gen, scale=scale)


@op_fn
def _sdpa_op(query, key, value, attn_mask=None, *, dropout_p: float = 0.0,
             is_causal: bool = False, generator=None, scale=None):
    """``sdpa_raw`` registered as the reference's ``_sdpa_op`` (the seam
    of ``scaled_dot_product_attention``; ``sdpa_raw`` and the kernel
    wrappers below it stay outside the seam)."""
    return sdpa_raw(query, key, value, attn_mask, dropout_p=dropout_p,
                    is_causal=is_causal, generator=generator, scale=scale)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """``paddle.nn.functional.flash_attention``: ``(out, None)`` (the
    softmax is never returned, as in the reference), through
    ``scaled_dot_product_attention``."""
    del return_softmax, fixed_seed_offset, rng_name, name
    out = scaled_dot_product_attention(
        query, key, value, None, dropout_p=dropout if training else 0.0,
        is_causal=causal, training=training)
    return out, None


def rope_tables(seq_len: int, head_dim: int, *, theta: float = 10000.0,
                dtype=torch.float32, device=None):
    """cos/sin tables ``[S, head_dim // 2]``."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    freqs = torch.outer(torch.arange(seq_len, dtype=torch.float32,
                                     device=device), inv)
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


def gather_rope_rows(cos, sin, positions):
    """Rope table rows at explicit positions ``[B, S]`` (sequence packing
    gathers segment-local offsets, every document restarting at 0):
    ``[B, S, D/2]`` tables that ``rope_raw`` takes."""
    idx = positions.long()
    return cos[idx], sin[idx]


def rope_raw(x, cos, sin, *, neox: bool = True):
    """Rope of ``x`` ``[B, S, H, D]`` with ``cos``/``sin`` ``[S, D/2]`` or
    per-row ``[B, S, D/2]``: rotate-half (GPT-NeoX / Llama) with
    ``neox``, else interleaved pairs. The rotation runs in the tables'
    type (float32 for ``rope_tables``) and casts back to ``x.dtype``."""
    c = cos[None, :, None, :] if cos.ndim == 2 else cos[:, :, None, :]
    s = sin[None, :, None, :] if sin.ndim == 2 else sin[:, :, None, :]
    if neox:
        d2 = x.shape[-1] // 2
        x1, x2 = x[..., :d2], x[..., d2:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                         dim=-1).to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                       dim=-1).reshape(x.shape).to(x.dtype)


@op_fn
def apply_rotary_emb(x, cos, sin):
    """Rotary position embedding (rotate-half) of ``x`` ``[B, S, H, D]``
    with ``[S, D/2]`` tables: ``rope_raw``."""
    return rope_raw(x, cos, sin)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """``paddle.incubate.nn.functional.fused_rotary_position_embedding``:
    ``(rope(q), rope(k) or None, v)``. ``sin`` / ``cos`` are ``[1, S, 1,
    D]`` or ``[S, D/2]`` tables (a full-``D`` table is cut to its first
    half); without them ``rope_tables(S, D)``. ``position_ids`` ``[B,
    S]`` gathers each token's table rows."""
    def table(t):
        if t.ndim == 4:
            t = t[0, :, 0, :]
        if t.shape[-1] == q.shape[-1]:
            t = t[..., :t.shape[-1] // 2]
        return t

    if cos is None or sin is None:
        cos_t, sin_t = rope_tables(q.shape[1], q.shape[-1], device=q.device)
    else:
        cos_t, sin_t = table(cos), table(sin)
    if position_ids is not None:
        cos_t, sin_t = gather_rope_rows(cos_t, sin_t, position_ids)
    neox = use_neox_rotary_style
    return (_rope_op(q, cos_t, sin_t, neox=neox),
            None if k is None else _rope_op(k, cos_t, sin_t, neox=neox), v)


@op_fn(name="fused_rope")
def _rope_op(x, c, s, *, neox: bool = True):
    return rope_raw(x, c, s, neox=neox)


# -- varlen / unpadded attention ----------------------------------------------

def segment_ids_from_cu_seqlens(cu_seqlens, total):
    """``[0, l1, l1 + l2, ...]`` -> per-token segment ids ``[total]``
    (tokens past the last boundary get the padding segment -1)."""
    cu = torch.as_tensor(cu_seqlens)
    pos = torch.arange(total, device=cu.device, dtype=cu.dtype)
    seg = torch.searchsorted(cu, pos, right=True) - 1
    return torch.where(seg < cu.shape[0] - 1, seg, -1)


def _local_positions(cu_seqlens, seg, total):
    """Per-token offset from the start of its segment (padding tokens
    count from ``cu_seqlens[0]``, as in the reference)."""
    cu = torch.as_tensor(cu_seqlens)
    starts = cu[seg.clamp(min=0)]
    return torch.arange(total, device=cu.device, dtype=starts.dtype) - starts


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        name=None):
    """``paddle.nn.functional.flash_attn_unpadded`` on packed ``[T, H, D]``
    tensors and ``cu_seqlens`` prefix sums: ``(out [Tq, H, D], None)``.
    Tokens attend only within their sequence, causal on positions within
    it (q and k of one sequence may sit at different offsets when
    ``cu_seqlens_q != cu_seqlens_k``). Tokens past ``cu_seqlens[-1]`` are
    padding; a prefix sum past the tensor's length raises."""
    del max_seqlen_q, max_seqlen_k, name
    if dropout:
        raise NotImplementedError(
            "flash_attn_unpadded: attention dropout is not implemented on "
            "the varlen path (pass dropout=0.0)")
    if return_softmax:
        raise NotImplementedError(
            "flash_attn_unpadded: return_softmax=True is not supported "
            "(the packed softmax is never materialized)")
    cq = torch.as_tensor(cu_seqlens_q, device=query.device)
    ck = torch.as_tensor(cu_seqlens_k, device=key.device)
    tq, tk = query.shape[0], key.shape[0]
    for what, cu, t in (("cu_seqlens_q", cq, tq), ("cu_seqlens_k", ck, tk)):
        last = int(cu[-1])
        E.enforce(last <= t,
                  f"flash_attn_unpadded: {what}[-1] == {last} exceeds the "
                  f"packed tensor length T == {t}; the prefix sums must end "
                  f"at or before the token count (trailing tokens past "
                  f"{what}[-1] are treated as padding)",
                  error=E.InvalidArgumentError)
    seg_q = segment_ids_from_cu_seqlens(cq, tq)
    seg_k = segment_ids_from_cu_seqlens(ck, tk)
    out = _flash_varlen(query, key, value, seg_q, seg_k,
                        _local_positions(cq, seg_q, tq),
                        _local_positions(ck, seg_k, tk),
                        causal=bool(causal), scale=scale)
    return out, None


@op_fn(name="flash_attn_varlen")
def _flash_varlen(q, k, v, seg_q, seg_k, pos_q, pos_k, *, causal, scale):
    """Packed ragged attention on ``[T, H, D]`` with per-token segment
    ids and segment-local positions, through the segment kernels."""
    out = segment_attention_raw(
        q[None], k[None], v[None], seg_q[None], seg_k[None], pos_q[None],
        pos_k[None], causal=causal, scale=scale)
    return out[0]


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout=0.0, causal=False,
                                return_softmax=False, fixed_seed_offset=None,
                                rng_name="", varlen_padded=True, name=None):
    """``paddle flash_attn_varlen_qkvpacked``: packed ``qkv [T, 3, H, D]``
    and ``cu_seqlens`` -> ``(out, None)``. q, k and v are copied out of
    the packed tensor (the kernels take contiguous tensors)."""
    q, k, v = (qkv[:, i].contiguous() for i in range(3))
    return flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                               max_seqlen_q, max_seqlen_k, scale,
                               dropout=dropout, causal=causal,
                               return_softmax=return_softmax)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, *, fixed_seed_offset=None,
                         rng_name="", training=True, name=None):
    """``paddle flash_attn_qkvpacked``: ``qkv`` ``[B, S, 3, H, D]`` ->
    ``(out, None)`` through ``flash_attention``; q, k and v are copied out
    of the packed tensor (the kernels take contiguous tensors)."""
    q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attention_with_sparse_mask(query, key, value,
                                     attn_mask_start_row_indices,
                                     attn_mask_start_row=0, dropout_p=0.0,
                                     is_causal=False, return_softmax=False,
                                     return_softmax_lse=False,
                                     return_seed_offset=False, training=True,
                                     name=None):
    """``paddle flash_attention_with_sparse_mask``: ``(out, None)``.
    ``attn_mask_start_row_indices`` ``[B, H, Sk]`` gives, for each key
    column, the first query row that may not attend to it; with
    ``is_causal`` a row also sees no later key. The dense boolean mask
    goes through ``scaled_dot_product_attention``'s math path, as in the
    reference."""
    del attn_mask_start_row, name
    if return_softmax or return_softmax_lse or return_seed_offset:
        raise NotImplementedError(
            "flash_attention_with_sparse_mask: softmax/lse/seed returns "
            "are not materialized on this path")
    rows = torch.arange(query.shape[1], device=query.device)
    starts = attn_mask_start_row_indices.to(query.device)
    allowed = rows[None, None, :, None] < starts[:, :, None, :]
    if is_causal:
        allowed = allowed & (rows[:, None] >= rows[None, :])[None, None]
    out = scaled_dot_product_attention(
        query, key, value, allowed,
        dropout_p=dropout_p if training else 0.0, is_causal=False,
        training=training)
    return out, None
