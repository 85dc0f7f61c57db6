"""Fused RMSNorm, forward and backward (port of
``paddle_tpu/kernels/rms_norm.py``).

``rms_norm_fwd`` and ``rms_norm_bwd`` are the wrappers of the
hand-written CUDA kernels in ``csrc/rms_norm.cu``, which replace the
reference's Pallas ``_fwd_kernel`` and ``_bwd_kernel``. For a CUDA
tensor each launches its kernel or raises; only a CPU tensor takes the
plain version (``rms_norm_ref``, ``rms_norm_bwd_ref``).

The function is the kernel's, not the XLA fallback's: ``y = x * r * w``
in float32 with ``r = rsqrt(mean(x * x) + eps)``, rounded once to
``x.dtype``; ``rstd`` (float32, one per row) is saved for the backward,
which gives ``dx`` in ``x.dtype`` and ``dw`` summed over all rows in
float32, then cast to ``w.dtype``. ``x`` is any ``[..., d]``; ``w`` is
``[d]``; each of them float32, bfloat16 or float16, in any pair (the
Pallas kernels keep any float type).

``rms_norm`` is the differentiable entry: ``_RmsNorm`` (the reference's
``custom_vjp``) when autograd needs a gradient, the forward alone
otherwise.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core import enforce as E
from . import _build
from ._stats import DISPATCH_STATS

__all__ = ["rms_norm", "rms_norm_fwd", "rms_norm_bwd", "rms_norm_ref",
           "rms_norm_bwd_ref", "supported", "MAX_D", "BwdPlan", "bwd_plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_D = 16384
# The backward's plan (csrc/rms_norm.cu). Bulk route: one block per
# streaming multiprocessor of the H100 (_SMS) of at most _BULK_THREADS
# threads, in row groups of at most _GROUP_THREADS (whole warps) that
# own 2 chunks of 8 columns a thread where that fits, at most _MAX_V;
# at most _MAX_GROUPS groups a block, each a ring of at most _STAGES row
# stages, a block's rings within _RING_BYTES of shared memory.
# Scalar route: at most _SCALAR_BLOCKS blocks of at least _MIN_ROWS rows.
_SMS, _BULK_THREADS, _GROUP_THREADS, _MAX_GROUPS = 132, 512, 256, 8
_STAGES, _MAX_V, _RING_BYTES = 3, 4, 192 * 1024
_SCALAR_BLOCKS, _MIN_ROWS = 264, 32


class BwdPlan(NamedTuple):
    """How the backward runs: ``route`` ``"bulk"`` (TMA row rings) or
    ``"scalar"``; ``grid`` blocks (one float32 partial ``dw`` row each);
    ``groups`` row groups a block of ``threads`` threads each; ``stages``
    row stages a group (0 on the scalar route); ``rows``, the most rows
    a group takes (groups take rows ``q, q + grid * groups, ...``)."""
    route: str
    grid: int
    groups: int
    threads: int
    stages: int
    rows: int


def supported(x, w) -> bool:
    """Whether the CUDA kernels take these tensors."""
    return (w.ndim == 1 and x.ndim >= 1 and w.shape[0] == x.shape[-1]
            and 1 <= x.shape[-1] <= MAX_D and x.dtype in _DTYPES
            and w.dtype in _DTYPES)


def bwd_plan(n: int, d: int, xdtype, wdtype, aligned: bool = True
             ) -> BwdPlan:
    """The backward's plan for ``n`` rows of ``d`` values of ``xdtype``
    and a weight of ``wdtype``, with every pointer 16-byte aligned or
    not. A function of these alone, so ``dw``'s sums run in one order at
    every launch. The bulk route takes ``d % 8 == 0`` and aligned
    pointers; a row group has ``d / 16`` threads rounded up to whole
    warps (2 chunks of 8 columns a thread) up to 256, more where 4 chunks
    a thread would not cover the row; a block as many groups as fit in
    512 threads with a stage each in the ring budget (at most 8), each
    group as many stages as the budget then holds (at most 3). At
    ``[8192, 4096]`` bf16: 132 blocks of 2 groups of 256 threads, 3
    stages of 16 KB."""
    del wdtype      # w is read once into registers: no part of the plan
    if d % 8 or not aligned:
        rows = max(_MIN_ROWS, -(-n // _SCALAR_BLOCKS))
        grid = -(-n // rows)
        return BwdPlan("scalar", grid, 1, min(256, 32 * -(-d // 32)), 0,
                       -(-n // grid))
    chunks = d // 8
    threads = min(_GROUP_THREADS, 32 * -(-chunks // 64))
    if chunks > _MAX_V * threads:
        threads = 32 * -(-chunks // (32 * _MAX_V))
    stage = 2 * d * xdtype.itemsize
    groups = max(1, min(_MAX_GROUPS, _BULK_THREADS // threads,
                        _RING_BYTES // stage))
    stages = max(1, min(_STAGES, _RING_BYTES // (groups * stage)))
    grid = min(_SMS, -(-n // groups))
    return BwdPlan("bulk", grid, groups, threads, stages,
                   -(-n // (grid * groups)))


def rms_norm_ref(x, w, eps):
    """Plain version: ``(y [..., d] in x.dtype, rstd f32 [n])``."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    y = (xf * r * w.float()).to(x.dtype)
    return y.reshape(x.shape), r.squeeze(-1)


def rms_norm_bwd_ref(x, w, rstd, dy):
    """Plain version of the backward: ``(dx in x.dtype, dw in w.dtype)``,
    the reference's ``_bwd_kernel`` math in float32."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    dyf = dy.reshape(-1, d).float()
    r = rstd.reshape(-1, 1)
    g = dyf * w.float()
    mean_gx = (g * xf).mean(dim=-1, keepdim=True)
    dx = (r * g - xf * (r * r * r) * mean_gx).to(x.dtype)
    dw = (dyf * xf * r).sum(dim=0)
    return dx.reshape(x.shape), dw.to(w.dtype)


def _check(what, tensors, ok, detail):
    E.enforce(all(t.is_cuda and t.device == tensors[0].device
                  for t in tensors),
              f"{what}: inputs must lie on one CUDA device, got "
              f"{[str(t.device) for t in tensors]}",
              error=E.InvalidArgumentError)
    E.enforce(ok, f"{what}: the CUDA kernel does not take {detail} (needs x "
              f"[..., d] and w [d] with 1 <= d <= {MAX_D}, each float32, "
              f"bfloat16 or float16)", error=E.InvalidArgumentError)
    E.enforce(all(t.is_contiguous() for t in tensors),
              f"{what}: inputs must be contiguous",
              error=E.InvalidArgumentError)
    _build.check_device(tensors[0], what)


def rms_norm_fwd(x, w, eps):
    """``(y, rstd)``: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Raises for CUDA tensors the kernel does not take."""
    if x.device.type == "cpu":
        DISPATCH_STATS["rms_ref"] += 1
        return rms_norm_ref(x, w, eps)
    _check("rms_norm", (x, w), supported(x, w),
           f"x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)} {w.dtype}")
    d = x.shape[-1]
    n = x.numel() // d
    y = torch.empty_like(x)
    rstd = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return y, rstd
    err = _lib().rms_norm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                              rstd.data_ptr(), n, d, float(eps),
                              _DTYPES[x.dtype], _DTYPES[w.dtype],
                              torch.cuda.current_stream(x.device).cuda_stream)
    DISPATCH_STATS["rms"] += 1
    _build.check_launch("rms_norm_fwd", err)
    return y, rstd


def rms_norm_bwd(x, w, rstd, dy):
    """``(dx, dw)`` from the forward's inputs, its rstd and the output
    gradient (``dy`` like ``x``): the CUDA kernels for CUDA tensors (the
    row pass, then the column sums of ``dw``; counted as one launch), the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        DISPATCH_STATS["rms_bwd_ref"] += 1
        return rms_norm_bwd_ref(x, w, rstd, dy)
    d = x.shape[-1]
    n = x.numel() // d if d else 0
    _check("rms_norm_bwd", (x, w, rstd, dy),
           supported(x, w) and dy.shape == x.shape and dy.dtype == x.dtype
           and rstd.shape == (n,) and rstd.dtype == torch.float32,
           f"x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)} {w.dtype}, "
           f"rstd {tuple(rstd.shape)} {rstd.dtype}, dy {tuple(dy.shape)} "
           f"{dy.dtype} (rstd float32 [n], dy like x)")
    dx = torch.empty_like(x)
    if n == 0:
        return dx, torch.zeros_like(w)
    plan = bwd_plan(n, d, x.dtype, w.dtype, all(
        t.data_ptr() % 16 == 0 for t in (x, w, dy, dx)))
    part = torch.empty((plan.grid, d), dtype=torch.float32, device=x.device)
    dw = torch.empty_like(w)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rms_norm_bwd(x.data_ptr(), w.data_ptr(), rstd.data_ptr(),
                           dy.data_ptr(), dx.data_ptr(), part.data_ptr(), n,
                           d, _DTYPES[x.dtype], _DTYPES[w.dtype], plan.grid,
                           plan.groups, plan.threads, plan.stages, stream)
    DISPATCH_STATS["rms_bwd"] += 1
    _build.check_launch("rms_norm_bwd", err)
    err = lib.rms_norm_dw(part.data_ptr(), dw.data_ptr(), plan.grid, d,
                          _DTYPES[w.dtype], stream)
    _build.check_launch("rms_norm_dw", err)
    return dx, dw


class _RmsNorm(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward wrapper saves ``x``,
    ``w`` and ``rstd``; the backward wrapper turns them and the output
    gradient into ``dx, dw``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = rms_norm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, rstd, dy.contiguous())
        return dx, dw, None


def rms_norm(x, w, eps=1e-6):
    """RMSNorm of the last axis of ``x`` scaled by ``w``, in ``x.dtype``,
    differentiable. Through ``_RmsNorm`` when autograd needs a gradient
    of ``x`` or ``w``; the forward wrapper alone otherwise."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RmsNorm.apply(x, w, float(eps))
    return rms_norm_fwd(x, w, eps)[0]


def _lib():
    lib = _build.load("rms_norm")
    if lib.rms_norm_fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rms_norm_fwd.argtypes = [p, p, p, p, i, i, f, i, i, p]
        lib.rms_norm_fwd.restype = ctypes.c_int
        lib.rms_norm_bwd.argtypes = [p] * 6 + [i] * 8 + [p]
        lib.rms_norm_bwd.restype = ctypes.c_int
        lib.rms_norm_dw.argtypes = [p, p, i, i, i, p]
        lib.rms_norm_dw.restype = ctypes.c_int
    return lib
