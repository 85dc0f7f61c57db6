"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

``sdpa_raw`` is the kernel seam the model cores call: it hands every
call to the flash wrappers (``kernels/flash_attention.py``), which
launch the CUDA kernels for CUDA tensors and take the plain versions for
CPU tensors; with ``segment_ids`` it takes the segment-masked
(sequence-packed) path, ``segment_attention_raw``. The varlen surface
(``flash_attn_unpadded``, ``flash_attn_varlen_qkvpacked``) is a second
entry to the same segment kernels, on packed ``[T, H, D]`` tensors with
``cu_seqlens`` prefix sums. Layout is the reference's ``[B, S, H, D]``.
"""
from __future__ import annotations

import torch

from ...core import enforce as E

__all__ = ["rope_tables", "rope_raw", "gather_rope_rows", "sdpa_reference",
           "sdpa_raw", "scaled_dot_product_attention", "apply_rotary_emb",
           "segment_attention_raw",
           "segment_ids_from_cu_seqlens", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked"]


def segment_attention_raw(q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                          causal=False, scale=None):
    """Segment-masked attention on ``[B, S, H, D]`` (the kernel seam of
    ``sdpa_raw``'s packed path and the varlen surface): the dispatcher
    ``kernels.dispatched_segment_attention``."""
    from ...kernels import dispatched_segment_attention
    return dispatched_segment_attention(q, k, v, seg_q, seg_k, pos_q, pos_k,
                                        causal=causal, scale=scale)


def sdpa_reference(q, k, v, *, causal=False, scale=None):
    """Math attention on ``[B, S, H, D]`` with a float32 softmax. GQA
    repeats each kv head over its group of query heads; the causal mask
    is bottom-right aligned (query row ``r`` sees keys ``<= r + Sk - Sq``).
    A fully masked row is NaN, as in the reference."""
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
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs.float(), vt.float()).to(q.dtype)
    return out.transpose(1, 2)


def sdpa_raw(query, key, value, attn_mask=None, *, dropout_p: float = 0.0,
             is_causal: bool = False, scale=None, segment_ids=None,
             positions=None):
    """Attention dispatcher on ``[B, S, H, D]``: the flash wrappers, whose
    device decides kernel (CUDA) or plain version (CPU).

    ``segment_ids`` ``[B, S]`` selects the sequence-packed path: tokens
    attend only within their own document (-1 = padding: zero rows), with
    ``is_causal`` evaluated on the segment-local ``positions`` ``[B, S]``
    (default: the global arange, which is the segment-local order for
    contiguously packed rows). ``attn_mask`` and dropout are not ported:
    with ``segment_ids`` they raise as in the reference (the packed mask
    is the mask), and without them too."""
    from ...kernels.flash_attention import flash_attention
    if attn_mask is not None or dropout_p != 0.0:
        if segment_ids is not None:
            raise NotImplementedError(
                "sdpa_raw: attn_mask/dropout are not supported together "
                "with segment_ids (the packed mask IS the mask)")
        raise NotImplementedError(
            "sdpa_raw: attn_mask and attention dropout are not ported yet "
            "(the flash kernels take neither)")
    if segment_ids is not None:
        pos = positions
        if pos is None:
            pos = torch.arange(query.shape[1], device=segment_ids.device)
            pos = pos.expand(segment_ids.shape)
        return segment_attention_raw(query, key, value, segment_ids,
                                     segment_ids, pos, pos,
                                     causal=is_causal, scale=scale)
    return flash_attention(query, key, value, causal=is_causal, scale=scale)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None,
                                 scale=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` on ``[B, S,
    H, D]``, through ``sdpa_raw`` (the flash kernels on the card,
    differentiable through ``_FlashAttention``). Dropout applies only
    while ``training``; a mask or dropout raises, as in ``sdpa_raw``."""
    del name
    return sdpa_raw(query, key, value, attn_mask,
                    dropout_p=dropout_p if training else 0.0,
                    is_causal=is_causal, scale=scale)


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


def rope_raw(x, cos, sin):
    """Rotate-half rope (GPT-NeoX / Llama convention). ``x``: ``[B, S, H,
    D]``; ``cos``/``sin``: ``[S, D/2]`` or per-row ``[B, S, D/2]``. The
    rotation runs in the tables' float32 and casts back to ``x.dtype``."""
    c = cos[None, :, None, :] if cos.ndim == 2 else cos[:, :, None, :]
    s = sin[None, :, None, :] if sin.ndim == 2 else sin[:, :, None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rotary_emb(x, cos, sin):
    """Rotary position embedding (rotate-half) of ``x`` ``[B, S, H, D]``
    with ``[S, D/2]`` tables: ``rope_raw``."""
    return rope_raw(x, cos, sin)


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
    out = segment_attention_raw(
        query[None], key[None], value[None], seg_q[None], seg_k[None],
        _local_positions(cq, seg_q, tq)[None],
        _local_positions(ck, seg_k, tk)[None], causal=bool(causal),
        scale=scale)
    return out[0], None


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
