"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

``sdpa_raw`` is the kernel seam the model cores call: it hands every
call to the flash-forward wrapper (``kernels/flash_attention.py``), which
launches the CUDA kernel for a CUDA tensor and takes the plain version
for a CPU tensor. Layout is the reference's ``[B, S, H, D]``.
"""
from __future__ import annotations

import torch

__all__ = ["rope_tables", "rope_raw", "sdpa_reference", "sdpa_raw"]


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


def sdpa_raw(query, key, value, *, is_causal: bool = False, scale=None):
    """Attention dispatcher on ``[B, S, H, D]``: the flash forward
    wrapper, whose device decides kernel (CUDA) or plain version (CPU)."""
    from ...kernels.flash_attention import flash_attention
    return flash_attention(query, key, value, causal=is_causal, scale=scale)


def rope_tables(seq_len: int, head_dim: int, *, theta: float = 10000.0,
                dtype=torch.float32, device=None):
    """cos/sin tables ``[S, head_dim // 2]``."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    freqs = torch.outer(torch.arange(seq_len, dtype=torch.float32,
                                     device=device), inv)
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


def rope_raw(x, cos, sin):
    """Rotate-half rope (GPT-NeoX / Llama convention). ``x``: ``[B, S, H,
    D]``; ``cos``/``sin``: ``[S, D/2]`` or per-row ``[B, S, D/2]``. The
    rotation runs in the tables' float32 and casts back to ``x.dtype``."""
    c = cos[None, :, None, :] if cos.ndim == 2 else cos[:, :, None, :]
    s = sin[None, :, None, :] if sin.ndim == 2 else sin[:, :, None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
