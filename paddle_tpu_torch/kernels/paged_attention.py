"""Ragged paged decode attention (port of
``paddle_tpu/kernels/paged_attention.py``: the full-precision arm and
the int8 arm).

``ragged_paged_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/paged_decode.cu``, which replaces the reference's Pallas
``_decode_kernel``. For a CUDA tensor it launches the kernel or raises;
only a CPU tensor takes the plain version ``paged_attention_ref``.

Layouts: q ``[B, num_heads, head_dim]`` (one decode position per
sequence); pages ``[num_pages, kv_heads, page_size, head_dim]``;
block_tables int32 ``[B, max_pages]`` (entries past a sequence's pages
may hold anything: they are clamped and masked); lengths int32 ``[B]``
(0 marks an empty slot and gives a zero row).

The int8 arm (the reference's ``FLAGS_serving_kv_quant``): pages hold
int8 codes and ``k_scales`` / ``v_scales`` float32 ``[num_pages,
kv_heads]`` carry one scale per (page, kv head); a key or value is
``code * scale``. Both or neither are given, and only with int8 pages.

The kernel splits each sequence's positions over several blocks
(flash-decoding) and combines their partials in a second pass;
``decode_split_plan`` chooses the chunk a block takes, from the table
width alone (no host sync on ``lengths``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import enforce as E
from . import _build
from ._stats import DISPATCH_STATS

__all__ = ["ragged_paged_attention", "paged_attention_ref", "supported",
           "decode_split_plan"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# a block's chunk: SPLIT_POSITIONS positions of whole pages, halved (not
# below MIN_SPLIT_POSITIONS, nor below one page) while the grid over the
# table has fewer than TARGET_BLOCKS blocks, about eight for each of the
# H100's 132 SMs; at most MAX_SPLIT_PAGES pages (the C entry's limit).
# Long chunks amortise a block's fixed cost where the batch fills the
# card; short ones shorten each block's serial walk where it does not.
SPLIT_POSITIONS = 512
MIN_SPLIT_POSITIONS = 64
TARGET_BLOCKS = 1024
MAX_SPLIT_PAGES = 512


def decode_split_plan(B: int, kv_heads: int, page_size: int,
                      max_pages: int):
    """``(pages_per_split, splits)`` of the decode kernel's grid
    ``(splits, kv_heads, B)``: each block takes ``pages_per_split`` whole
    pages of one sequence's table, ``splits = ceil(max_pages /
    pages_per_split)``. Sized from the table width ``max_pages *
    page_size``, never from the lengths, so a launch needs no host sync;
    blocks whose chunk lies past a sequence's length exit at once."""
    pps = max(1, SPLIT_POSITIONS // page_size)
    while (pps > 1 and (pps // 2) * page_size >= MIN_SPLIT_POSITIONS
           and B * kv_heads * -(-max_pages // pps) < TARGET_BLOCKS):
        pps //= 2
    pps = min(pps, max_pages, MAX_SPLIT_PAGES)
    return pps, -(-max_pages // pps)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        scale=None, k_scales=None, v_scales=None):
    """Gather-based plain version, the math of the reference's
    ``paged_attention_ref`` (float32 softmax; an empty sequence yields a
    zero row, never NaN). With ``k_scales`` / ``v_scales`` the gathered
    int8 codes are dequantized in float32 (``code * scale``) before the
    same math."""
    B, nh, hd = q.shape
    P, kv, ps, _ = k_pages.shape
    maxp = block_tables.shape[1]
    g = nh // kv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    bt = block_tables.clamp(0, P - 1).reshape(-1).long()
    kf = k_pages[bt].reshape(B, maxp, kv, ps, hd).float()
    vf = v_pages[bt].reshape(B, maxp, kv, ps, hd).float()
    if k_scales is not None:
        kf = kf * k_scales[bt].reshape(B, maxp, kv, 1, 1).float()
        vf = vf * v_scales[bt].reshape(B, maxp, kv, 1, 1).float()
    qf = q.float().reshape(B, kv, g, hd)
    s = torch.einsum("bkgd,bmkpd->bkgmp", qf, kf) * scale
    pos = (torch.arange(maxp, device=q.device)[:, None] * ps
           + torch.arange(ps, device=q.device)[None, :])
    mask = (pos[None] < lengths.to(q.device).long()[:, None, None])
    mask = mask[:, None, None]                        # [B, 1, 1, maxp, ps]
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=(-2, -1), keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    l = e.sum(dim=(-2, -1), keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bkgmp,bmkpd->bkgd", e / l, vf)
    return out.reshape(B, nh, hd).to(q.dtype)


def supported(q, k_pages, block_tables, quant: bool = False) -> bool:
    """Whether the CUDA kernel takes these shapes and types. ``quant``
    marks the int8 arm (scale planes present): it takes int8 pages only,
    and int8 pages need it. Any page size the full-precision arm takes
    (the reference's ``ps % 32`` is the TPU's int8 sublane tile; the
    CUDA arm has no such rule)."""
    if q.ndim != 3 or k_pages.ndim != 4 or block_tables.ndim != 2:
        return False
    B, nh, hd = q.shape
    P, kv, ps, hd2 = k_pages.shape
    page_ok = (k_pages.dtype == torch.int8 if quant
               else k_pages.dtype == q.dtype)
    return (hd == hd2 and kv >= 1 and nh % kv == 0 and hd % 8 == 0
            and hd <= 128 and (nh // kv) * hd <= 1024 and P >= 1
            and ps >= 1 and block_tables.shape[0] == B
            and block_tables.shape[1] >= 1
            and q.dtype in _DTYPES and page_ok)


def ragged_paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           scale=None, k_scales=None, v_scales=None):
    """Paged decode attention ``[B, num_heads, head_dim]``: the CUDA kernel
    for CUDA tensors (the int8 arm when ``k_scales`` / ``v_scales`` are
    given), the plain version for CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    quant = k_scales is not None
    E.enforce(quant == (v_scales is not None),
              "ragged_paged_attention: give both k_scales and v_scales, "
              "or neither", error=E.InvalidArgumentError)
    arm = "paged_quant" if quant else "paged"
    if q.device.type == "cpu":
        DISPATCH_STATS[arm + "_ref"] += 1
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, scale=scale, k_scales=k_scales,
                                   v_scales=v_scales)
    tensors = (q, k_pages, v_pages, block_tables, lengths) + (
        (k_scales, v_scales) if quant else ())
    E.enforce(all(t.device == q.device for t in tensors),
              "ragged_paged_attention: every tensor must lie on "
              f"{q.device}", error=E.InvalidArgumentError)
    E.enforce(supported(q, k_pages, block_tables, quant=quant)
              and v_pages.shape == k_pages.shape
              and v_pages.dtype == k_pages.dtype
              and lengths.shape == (q.shape[0],),
              f"ragged_paged_attention: the CUDA kernel does not take q "
              f"{tuple(q.shape)} {q.dtype}, pages {tuple(k_pages.shape)} "
              f"{k_pages.dtype}, block_tables {tuple(block_tables.shape)}"
              f"{', scales' if quant else ', no scales'} (needs head_dim "
              f"% 8 == 0, head_dim <= 128, group * head_dim <= 1024, q "
              f"float32 or bfloat16, pages of q's type without scales or "
              f"int8 with them)", error=E.InvalidArgumentError)
    if quant:
        E.enforce(all(t.dtype == torch.float32
                      and tuple(t.shape) == tuple(k_pages.shape[:2])
                      for t in (k_scales, v_scales)),
                  f"ragged_paged_attention: scales must be float32 "
                  f"{tuple(k_pages.shape[:2])} (one per page and kv "
                  f"head)", error=E.InvalidArgumentError)
    E.enforce(block_tables.dtype == torch.int32
              and lengths.dtype == torch.int32,
              "ragged_paged_attention: block_tables and lengths must be "
              "int32", error=E.InvalidArgumentError)
    E.enforce(all(t.is_contiguous() for t in tensors),
              "ragged_paged_attention: inputs must be contiguous",
              error=E.InvalidArgumentError)
    _build.check_device(q, "ragged_paged_attention")
    out = torch.empty_like(q)
    _launch(_lib(), q, k_pages, v_pages, block_tables, lengths, out, scale,
            k_scales, v_scales)
    DISPATCH_STATS[arm] += 1
    return out


def _launch(lib, q, k_pages, v_pages, block_tables, lengths, out, scale,
            k_scales=None, v_scales=None):
    """One call of the C entry of ``lib`` (the int8 one with scales), on
    checked tensors: the split plan, the partials' scratch, the launch."""
    B, nh, hd = q.shape
    P, kv, ps, _ = k_pages.shape
    maxp = block_tables.shape[1]
    pps, splits = decode_split_plan(B, kv, ps, maxp)
    scratch = (torch.empty(splits * B * nh * (hd + 2), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    part = scratch.data_ptr() if scratch is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if k_scales is not None:
        err = lib.paged_decode_int8(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            part, B, nh, kv, ps, hd, P, maxp, pps, float(scale),
            _DTYPES[q.dtype], stream)
    else:
        err = lib.paged_decode(q.data_ptr(), k_pages.data_ptr(),
                               v_pages.data_ptr(), block_tables.data_ptr(),
                               lengths.data_ptr(), out.data_ptr(), part, B,
                               nh, kv, ps, hd, P, maxp, pps, float(scale),
                               _DTYPES[q.dtype], stream)
    _build.check_launch("paged_decode_int8" if k_scales is not None
                        else "paged_decode", err)


def _lib():
    lib = _build.load("paged_decode")
    if lib.paged_decode.argtypes is None:
        _bind(lib)
    return lib


def _bind(lib):
    """The C entries' argument types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                 i, ctypes.c_float, i, p]
    lib.paged_decode.restype = ctypes.c_int
    lib.paged_decode_int8.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                      i, i, i, i, i, ctypes.c_float, i, p]
    lib.paged_decode_int8.restype = ctypes.c_int
