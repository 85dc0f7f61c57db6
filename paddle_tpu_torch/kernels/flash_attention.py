"""Flash attention forward (port of ``paddle_tpu/kernels/flash_attention.py``).

``flash_attention_fwd`` is the wrapper of the hand-written CUDA kernel
``csrc/flash_fwd.cu``, which replaces the reference's Pallas
``_fwd_kernel``. For a CUDA tensor it launches the kernel or raises; only
a CPU tensor takes the plain version ``flash_attention_ref``, which has
the math of ``sdpa_reference`` (and gives a zero row, where the reference
gives NaN, for a row that sees no key, as the kernel does).

Forward only: the backward kernels are still to be ported.
Layout: ``[B, S, H, D]`` in and out; ``lse`` is float32 ``[B, H, Sq]``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import enforce as E
from . import _build
from ._stats import DISPATCH_STATS

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "supported"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supported(q, k, v) -> bool:
    """Whether the CUDA kernel takes these tensors."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        return False
    b, sq, h, d = q.shape
    bk, sk, kvh, dk = k.shape
    return (b == bk and d == dk and kvh >= 1 and h % kvh == 0
            and d % 16 == 0 and 16 <= d <= 128 and sq >= 1 and sk >= 1
            and q.dtype in _DTYPES and k.dtype == q.dtype
            and v.dtype == q.dtype)


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
              f"H % KVH == 0, D % 16 == 0, D <= 128, float32 or bfloat16)",
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
    _build.check_launch("flash_fwd", err)
    return out, lse


def flash_attention(q, k, v, *, causal=False, scale=None):
    """Attention output ``[B, Sq, H, D]`` (see ``flash_attention_fwd``)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]


def _lib():
    lib = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                  ctypes.c_float, i, i, p]
        lib.flash_fwd.restype = ctypes.c_int
    return lib
