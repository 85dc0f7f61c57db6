"""Hand-written Hopper kernels of the port and their dispatch (port of
``paddle_tpu/kernels/__init__.py``).

Each kernel module has a wrapper that launches the CUDA kernel for CUDA
tensors (or raises) and takes the kernel's plain PyTorch version for CPU
tensors; there is no fallback from the card to the plain version:

- ``flash_attention.flash_attention_fwd``: ``csrc/flash_fwd.cu``;
- ``flash_attention.flash_attention_bwd``: ``csrc/flash_bwd.cu``;
- ``flash_attention.flash_attention_segments_fwd`` / ``_bwd``: the
  segment (sequence-packed) entries of the same two sources;
- ``paged_attention.ragged_paged_attention``: ``csrc/paged_decode.cu``
  (entries ``paged_decode``, and ``paged_decode_int8`` for int8 pages
  with per-(page, kv head) scales);
- ``rms_norm.rms_norm_fwd`` / ``rms_norm_bwd``: ``csrc/rms_norm.cu``
  (entries ``rms_norm_fwd``, ``rms_norm_bwd`` and ``rms_norm_dw``),
  which ``F.rms_norm`` reaches through ``dispatched_rms_norm``.

``fused_ce`` and ``ring_attention`` (the sequence-parallel ring over
``torch.distributed``) are plain PyTorch on every device, as the
reference's are plain ``lax.scan`` code. ``autotune`` measures and caches
the knobs the main paths resolve per shape (the KV page size, the cross
entropy's vocab chunk). The launch counters mirror the reference's
``_DISPATCH_STATS``.
"""
from __future__ import annotations

import torch

from ..core import enforce as E
from . import autotune, flash_attention, fused_ce  # noqa: F401
from . import paged_attention, rms_norm  # noqa: F401
from ._stats import DISPATCH_STATS as _DISPATCH_STATS
from .ring_attention import ring_attention  # noqa: F401

# the blockwise cross entropy's default vocab chunk (autotune.ce_chunk
# tunes it per shape)
CE_DEFAULT_CHUNK = autotune.CE_DEFAULT_CHUNK

# the decode seam inference/paged.py calls (the reference's name); it
# takes k_scales / v_scales for int8 pages, counted paged_quant[_ref]
dispatched_paged_attention = paged_attention.ragged_paged_attention

__all__ = ["autotune", "flash_attention", "fused_ce", "paged_attention",
           "rms_norm",
           "dispatched_fused_ce", "dispatched_paged_attention",
           "dispatched_rms_norm", "dispatched_segment_attention",
           "ring_attention",
           "dispatch_stats", "reset_dispatch_stats"]


def dispatched_segment_attention(q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                                 causal=False, scale=None):
    """Segment-masked (sequence-packed) attention, differentiable: the
    CUDA segment kernels for CUDA tensors (counted ``varlen`` /
    ``varlen_bwd``; a shape they do not take raises), the plain versions
    for CPU tensors (``varlen_ref`` / ``varlen_bwd_ref``). The reference's
    ``varlen_fallback`` arm has no counterpart on the card."""
    return flash_attention.flash_attention_segments(
        q, k, v, seg_q, seg_k, pos_q, pos_k, causal=causal, scale=scale)


def dispatched_fused_ce(x, head, labels, *, vocab_chunk=None,
                        reduction="mean", ignore_index=-100):
    """Blockwise cross entropy, counted: a shape it does not take falls
    back to the materialising cross entropy (the same math, ignore_index
    masking and valid-count mean included) over float32 logits, as the
    reference's ``preferred_element_type``. ``vocab_chunk=None`` resolves
    through the autotune cache (``autotune.ce_chunk`` at this call's
    tokens, width, vocabulary, dtype and device); an explicit int is
    always taken as given."""
    if fused_ce.supported(x, head, labels):
        _DISPATCH_STATS["fused_ce"] += 1
        if vocab_chunk is None:
            vocab_chunk = autotune.ce_chunk(
                x.numel() // x.shape[-1], int(x.shape[-1]),
                int(head.shape[0]), x.dtype, device=x.device)
        return fused_ce.fused_cross_entropy(
            x, head, labels, vocab_chunk=vocab_chunk, reduction=reduction,
            ignore_index=ignore_index)
    _DISPATCH_STATS["fused_ce_fallback"] += 1
    logits = fused_ce._mm_f32(x, head.t())
    return fused_ce.masked_xent_from_logits(
        logits, labels, ignore_index=ignore_index, reduction=reduction)


def dispatched_rms_norm(x, w, eps):
    """The fused RMSNorm behind ``F.rms_norm`` (what the reference's
    ``_make_rms_dispatch`` makes, without its ``tpu_only`` switch): the
    kernels for CUDA tensors (raising on what they do not take), the
    plain versions for CPU tensors. The output type is the result type of
    ``x`` and ``w``, as in the reference.

    A ``w`` that is not ``[x.shape[-1]]`` follows the reference's one
    shape rule on a CPU tensor: its plain math (normalise, round to
    ``x.dtype``, then scale), counted ``rms_fallback``. A CUDA tensor
    never takes plain math: a ``w`` of ``x.shape[-1]`` elements that
    broadcasts over ``x`` without changing its shape (``[1, d]``, ...) is
    launched as ``[d]``, and any other ``w`` raises."""
    out_dtype = torch.result_type(x, w)
    d = x.shape[-1]
    if w.ndim != 1 or w.shape[0] != d:
        if x.device.type == "cpu":
            _DISPATCH_STATS["rms_fallback"] += 1
            xf = x.float()
            r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
            return ((xf * r).to(x.dtype) * w).to(out_dtype)
        if not (w.numel() == d and 1 <= w.ndim <= x.ndim
                and w.shape[-1] == d):
            raise E.InvalidArgumentError(
                f"rms_norm: the CUDA kernel scales the last axis by a "
                f"weight of {d} elements; w {tuple(w.shape)} does not "
                f"broadcast so over x {tuple(x.shape)}")
        w = w.reshape(d)
    return rms_norm.rms_norm(x, w, eps).to(out_dtype)


def dispatch_stats() -> dict:
    return dict(_DISPATCH_STATS)


def reset_dispatch_stats() -> None:
    for k in _DISPATCH_STATS:
        _DISPATCH_STATS[k] = 0
