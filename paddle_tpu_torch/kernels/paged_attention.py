"""Ragged paged decode attention (port of
``paddle_tpu/kernels/paged_attention.py``, full-precision arm).

``ragged_paged_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/paged_decode.cu``, which replaces the reference's Pallas
``_decode_kernel``. For a CUDA tensor it launches the kernel or raises;
only a CPU tensor takes the plain version ``paged_attention_ref``.

Layouts: q ``[B, num_heads, head_dim]`` (one decode position per
sequence); pages ``[num_pages, kv_heads, page_size, head_dim]``;
block_tables int32 ``[B, max_pages]`` (entries past a sequence's pages
may hold anything: they are clamped and masked); lengths int32 ``[B]``
(0 marks an empty slot and gives a zero row).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import enforce as E
from . import _build
from ._stats import DISPATCH_STATS

__all__ = ["ragged_paged_attention", "paged_attention_ref", "supported"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        scale=None):
    """Gather-based plain version, the math of the reference's
    ``paged_attention_ref`` (float32 softmax; an empty sequence yields a
    zero row, never NaN)."""
    B, nh, hd = q.shape
    P, kv, ps, _ = k_pages.shape
    maxp = block_tables.shape[1]
    g = nh // kv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    bt = block_tables.clamp(0, P - 1).reshape(-1).long()
    kf = k_pages[bt].reshape(B, maxp, kv, ps, hd).float()
    vf = v_pages[bt].reshape(B, maxp, kv, ps, hd).float()
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


def supported(q, k_pages, block_tables) -> bool:
    """Whether the CUDA kernel takes these shapes and types."""
    if q.ndim != 3 or k_pages.ndim != 4 or block_tables.ndim != 2:
        return False
    B, nh, hd = q.shape
    P, kv, ps, hd2 = k_pages.shape
    return (hd == hd2 and kv >= 1 and nh % kv == 0 and hd % 8 == 0
            and hd <= 128 and (nh // kv) * hd <= 1024 and P >= 1
            and ps >= 1 and block_tables.shape[0] == B
            and block_tables.shape[1] >= 1
            and q.dtype in _DTYPES and k_pages.dtype == q.dtype)


def ragged_paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           scale=None):
    """Paged decode attention ``[B, num_heads, head_dim]``: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        DISPATCH_STATS["paged_ref"] += 1
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, scale=scale)
    tensors = (q, k_pages, v_pages, block_tables, lengths)
    E.enforce(all(t.device == q.device for t in tensors),
              "ragged_paged_attention: every tensor must lie on "
              f"{q.device}", error=E.InvalidArgumentError)
    E.enforce(supported(q, k_pages, block_tables)
              and v_pages.shape == k_pages.shape
              and v_pages.dtype == k_pages.dtype
              and lengths.shape == (q.shape[0],),
              f"ragged_paged_attention: the CUDA kernel does not take q "
              f"{tuple(q.shape)} {q.dtype}, pages {tuple(k_pages.shape)} "
              f"{k_pages.dtype}, block_tables {tuple(block_tables.shape)} "
              f"(needs head_dim % 8 == 0, head_dim <= 128, group * "
              f"head_dim <= 1024, float32 or bfloat16)",
              error=E.InvalidArgumentError)
    E.enforce(block_tables.dtype == torch.int32
              and lengths.dtype == torch.int32,
              "ragged_paged_attention: block_tables and lengths must be "
              "int32", error=E.InvalidArgumentError)
    E.enforce(all(t.is_contiguous() for t in tensors),
              "ragged_paged_attention: inputs must be contiguous",
              error=E.InvalidArgumentError)
    _build.check_device(q, "ragged_paged_attention")
    lib = _lib()
    B, nh, hd = q.shape
    P, kv, ps, _ = k_pages.shape
    out = torch.empty_like(q)
    err = lib.paged_decode(q.data_ptr(), k_pages.data_ptr(),
                           v_pages.data_ptr(), block_tables.data_ptr(),
                           lengths.data_ptr(), out.data_ptr(), B, nh, kv,
                           ps, hd, P, block_tables.shape[1], float(scale),
                           _DTYPES[q.dtype],
                           torch.cuda.current_stream(q.device).cuda_stream)
    DISPATCH_STATS["paged"] += 1
    _build.check_launch("paged_decode", err)
    return out


def _lib():
    lib = _build.load("paged_decode")
    if lib.paged_decode.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                     ctypes.c_float, i, p]
        lib.paged_decode.restype = ctypes.c_int
    return lib
