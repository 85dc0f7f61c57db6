"""Flash attention (port of ``paddle_tpu/kernels/flash_attention.py``).

``flash_attention_fwd`` and ``flash_attention_bwd`` are the wrappers of
the hand-written CUDA kernels ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, which replace the reference's Pallas
``_fwd_kernel`` and ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``. For a CUDA
tensor each launches its kernel or raises; only a CPU tensor takes the
plain version (``flash_attention_ref``, ``flash_attention_bwd_ref``). The
forward's plain version has the math of ``sdpa_reference`` (and gives a
zero row, where the reference gives NaN, for a row that sees no key, as
the kernel does); the backward gives such a row exact zero gradients.

``flash_attention`` is the differentiable entry: ``_FlashAttention``
(the reference's ``_flash`` custom VJP) when autograd needs a gradient,
the forward alone otherwise.
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
           "flash_attention_bwd", "flash_attention_bwd_ref", "supported",
           "supported_bwd"]

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
    _build.check_launch("flash_bwd", err)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the forward wrapper saves
    ``q, k, v, out, lse``; the backward wrapper turns them and the output
    gradient into ``dq, dk, dv``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
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


def _lib():
    lib = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                  ctypes.c_float, i, i, p]
        lib.flash_fwd.restype = ctypes.c_int
    return lib


def _lib_bwd():
    lib = _build.load("flash_bwd")
    if lib.flash_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_bwd.argtypes = [p] * 10 + [i] * 6 + [ctypes.c_float, i, i,
                                                       p]
        lib.flash_bwd.restype = ctypes.c_int
    return lib
