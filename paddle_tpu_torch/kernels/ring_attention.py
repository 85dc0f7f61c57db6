"""Ring attention: exact attention over a sequence sharded on a mesh axis
(port of ``paddle_tpu/kernels/ring_attention.py``).

Each rank of the axis holds q / k / v chunks ``[B, S/n, H, D]`` (DTensors
placed ``Shard(1)`` on the axis). ``n`` ring steps rotate the k / v
chunk to the next rank with ``torch.distributed.batch_isend_irecv`` over
the axis's process group, while an online softmax (row max ``m``, sum
``l``, weighted values ``acc``, all float32) merges each chunk's part.
The causal mask is taken on global positions, so the result is standard
causal attention on the whole sequence. The reference's chunk math
(``_chunk_attn``: float32 scores, the ``-1e30 / 2`` guard of a chunk that
a row cannot see) is kept.

The backward (``_RingAttention``) runs the ring again: each rank
recomputes its rows' probabilities against the chunk it holds from the
saved log-sum-exp, adds into its own ``dq``, and passes the chunk on
with the ``dk`` / ``dv`` accumulated for it, which arrive home after
``n`` steps. Plain PyTorch: the reference's ring is ``lax.scan`` /
``ppermute`` code, not a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["ring_attention"]

_NEG_INF = -1e30


def _scores(q, k, row0, col0, scale, causal):
    """Float32 scores ``[B, H, Sq, Sk]`` of a q chunk against a k chunk
    (heads matched), masked to ``-1e30`` above the global diagonal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = row0 + torch.arange(q.shape[1], device=q.device)
        cols = col0 + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(rows[:, None] < cols[None, :], _NEG_INF)
    return s


def _chunk_attn(q, k, v, row0, col0, scale, causal):
    """The reference's ``_chunk_attn``: ``(m_safe, l, acc)`` of one q
    chunk against one kv chunk, ``[B, H, Sq, 1]``, ``[B, H, Sq, 1]``,
    ``[B, H, Sq, D]``."""
    s = _scores(q, k, row0, col0, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=_NEG_INF / 2)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return m_safe, l, acc


class _Ring:
    """The axis's ring: this rank's place ``idx`` of ``n`` and the global
    ranks of its neighbours."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.idx = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.idx + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.idx - 1) % self.n)

    def pass_on(self, *tensors):
        """Each tensor sent to the next rank; the previous rank's
        received in its place."""
        if self.n == 1:
            return tensors
        out = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, o in zip(tensors, out):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self.next,
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, o, self.prev, self.group))
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        return tuple(out)


def _repeat(t, group):
    return t.repeat_interleave(group, dim=2) if group > 1 else t


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, scale, causal):
        ring = _Ring(group)
        rep = q.shape[2] // k.shape[2]
        b, sl, h, d = q.shape
        row0 = ring.idx * sl
        m = torch.full((b, h, sl, 1), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, sl, d), dtype=torch.float32,
                          device=q.device)
        kc, vc = k, v
        for t in range(ring.n):
            src = (ring.idx - t) % ring.n
            mc, lc, ac = _chunk_attn(q, _repeat(kc, rep), _repeat(vc, rep),
                                     row0, src * sl, scale, causal)
            m_new = torch.maximum(m, mc)
            alpha, beta = torch.exp(m - m_new), torch.exp(mc - m_new)
            l = l * alpha + lc * beta
            acc = acc * alpha + ac * beta
            m = m_new
            if t < ring.n - 1:
                kc, vc = ring.pass_on(kc, vc)
        l = torch.where(l == 0.0, 1.0, l)
        out = (acc / l).to(q.dtype).transpose(1, 2).contiguous()
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.scale, ctx.causal = group, scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        ring = _Ring(ctx.group)
        rep = q.shape[2] // k.shape[2]
        b, sl, h, d = q.shape
        row0 = ring.idx * sl
        do = dout.float()
        delta = (do * out.float()).sum(-1).transpose(1, 2)[..., None]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        for t in range(ring.n):
            src = (ring.idx - t) % ring.n
            kr, vr = _repeat(kc, rep), _repeat(vc, rep)
            s = _scores(q, kr, row0, src * sl, ctx.scale, ctx.causal)
            p = torch.exp(s - lse)                           # [B,H,Sq,Sk]
            dvr = torch.einsum("bhqk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, vr.float())
            ds = p * (dp - delta) * ctx.scale
            dq += torch.einsum("bhqk,bkhd->bqhd", ds, kr.float())
            dkr = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
            if rep > 1:
                dkr = dkr.unflatten(2, (-1, rep)).sum(3)
                dvr = dvr.unflatten(2, (-1, rep)).sum(3)
            dk += dkr
            dv += dvr
            # the chunk and the gradients gathered for it move on; after
            # n moves the gradients are home, and the chunk is not needed
            # for the last
            if t < ring.n - 1:
                kc, vc, dk, dv = ring.pass_on(kc, vc, dk, dv)
            else:
                dk, dv = ring.pass_on(dk, dv)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q, k, v, mesh, *, axis: str = "sp", causal: bool = True,
                   scale: Optional[float] = None):
    """Exact attention of ``[B, S, H, D]`` DTensors whose sequence is
    sharded on mesh axis ``axis`` (``Shard(1)``); returns ``[B, S, H,
    D]`` placed the same. GQA: kv heads divide the q heads. Differentiable
    (the backward runs the ring in turn)."""
    from ..distributed import spmd
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = mesh.get_group(axis)
    spec = spmd.P(None, axis, None, None)
    q, k, v = (spmd.constrain(t, mesh, spec) for t in (q, k, v))
    return spmd.local(
        lambda a, b, c: _RingAttention.apply(a, b, c, group, float(scale),
                                             bool(causal)),
        mesh, spec, q, k, v)
