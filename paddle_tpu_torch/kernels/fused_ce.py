"""Blockwise softmax cross entropy for the LM head (port of
``paddle_tpu/kernels/fused_ce.py``).

The ``[N, V]`` logits never exist whole: ``_BlockwiseCE`` walks the
vocabulary in chunks of ``vocab_chunk`` head rows. The forward keeps an
online softmax per token (running max, running sum of exponentials, the
gold logit); the backward recomputes each chunk's logits from the saved
log-sum-exp, forms ``(softmax - onehot) * g`` and contracts it at once
into ``dx`` (accumulated in float32) and that chunk's rows of ``dhead``.
The reference pads the head to whole chunks and masks the padded columns;
here the tail chunk is cut at the vocabulary's end, which leaves the same
classes out without copying the head.

Plain PyTorch on every device, as the reference is plain ``lax.scan``
code: the chunk products go to the matmul library. As the reference's
``preferred_element_type=float32``, the logits and ``dx`` products of
bfloat16 operands come out in float32 (on the card, cuBLAS with a
float32 output; on the CPU, float32 operands), so neither is rounded to
bfloat16 before it is used or summed; ``dhead`` is rounded once, to the
head's dtype, as in the reference.
"""
from __future__ import annotations

import torch

__all__ = ["fused_cross_entropy", "masked_xent_from_logits", "supported"]


def masked_xent_from_logits(logits, labels, *, ignore_index: int = -100,
                            reduction: str = "mean"):
    """Materialising cross entropy with the blockwise loss's semantics:
    ignored or out-of-range labels give zero loss and zero gradient, and
    ``mean`` divides by the valid count."""
    v = logits.shape[-1]
    valid = (labels != ignore_index) & (labels >= 0) & (labels < v)
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    per = torch.where(valid, logz - gold, 0.0)
    if reduction == "mean":
        return per.sum() / valid.sum().clamp(min=1).to(per.dtype)
    if reduction == "sum":
        return per.sum()
    return per


class _VocabParallelXent(torch.autograd.Function):
    """Per-token cross entropy of one rank's vocab shard of float32
    logits ``[..., Vl]`` (columns ``offset`` on of ``V``) against global
    labels: the row max, the exp sum and the gold logit reduce over the
    shards' ``group`` (max, sum, sum), so no rank holds a whole row.
    ``per`` is zero where ``valid`` is false. The backward is
    ``softmax - onehot`` on this rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, valid, offset, group):
        import torch.distributed as dist
        vl = logits.shape[-1]
        m = logits.amax(dim=-1)
        if group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        se = e.sum(dim=-1)
        loc = labels.long() - offset
        mine = valid & (loc >= 0) & (loc < vl)
        loc = loc.clamp(0, vl - 1)
        gold = torch.where(mine, logits.gather(-1, loc[..., None])[..., 0],
                           0.0)
        if group is not None:
            dist.all_reduce(se, group=group)
            dist.all_reduce(gold, group=group)
        per = torch.where(valid, m + torch.log(se) - gold, 0.0)
        ctx.save_for_backward(e, se, loc, mine, valid)
        return per

    @staticmethod
    def backward(ctx, dper):
        e, se, loc, mine, valid = ctx.saved_tensors
        g = torch.where(valid, dper, 0.0)
        d = e * (g / se)[..., None]
        d.scatter_add_(-1, loc[..., None],
                       -torch.where(mine, g, 0.0)[..., None])
        return d, None, None, None, None


def vocab_parallel_xent(logits, labels, mesh, *, ignore_index: int = -100):
    """``masked_xent_from_logits`` (mean) of float32 logits placed
    ``P(("dp", "fsdp"), None, "tp")`` on ``mesh`` against labels placed
    over the batch axes: each rank takes the loss of its rows over its
    vocab shard, reducing across tp (``_VocabParallelXent``), and the
    mean over the valid tokens reduces across the batch axes. Returns a
    replicated scalar DTensor."""
    from ..distributed import spmd
    batch = ("dp", "fsdp")
    logits = spmd.constrain(logits, mesh, spmd.P(batch, None, "tp"))
    labels = spmd.constrain(labels, mesh, spmd.P(batch))
    v = logits.shape[-1]
    tp = spmd.axis_size(mesh, "tp")
    group = mesh.get_group("tp") if tp > 1 else None
    offset = spmd.axis_rank(mesh, "tp") * (-(-v // tp))

    def shard_loss(lg, lb):
        valid = (lb != ignore_index) & (lb >= 0) & (lb < v)
        return _VocabParallelXent.apply(lg, lb, valid, offset, group), valid

    per, valid = spmd.local(shard_loss, mesh,
                            [spmd.P(batch), spmd.P(batch)], logits, labels)
    return per.sum() / valid.sum().clamp(min=1).to(per.dtype)


def supported(x, head, labels) -> bool:
    """Shape guard for the dispatcher: 2D-flattenable x, matching head."""
    return (x.ndim >= 2 and head.ndim == 2
            and x.shape[-1] == head.shape[-1]
            and tuple(labels.shape) == tuple(x.shape[:-1]))


class _MmF32(torch.autograd.Function):
    """``a [N, K] @ b [K, M]`` of two CUDA tensors of one 16-bit type,
    summed and returned in float32 (cuBLAS, float32 output). PyTorch's
    ``mm`` with ``out_dtype`` has no derivative, so this gives it one:
    the float32 cotangent is rounded once to the operands' type, as the
    blockwise loss rounds ``d_logits``, and each gradient is summed in
    float32 and rounded once to its operand's type."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(g, b.t(), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.mm(a.t(), g, out_dtype=torch.float32).to(b.dtype)
        return da, db


def _mm_f32(a, b):
    """``a [..., K] @ b [K, M]`` summed and returned in float32, never
    rounded to a 16-bit type: the reference's
    ``preferred_element_type=float32``. Float32 operands take a plain
    product; 16-bit ones take cuBLAS with a float32 output on the card
    (differentiable, ``_MmF32``) and float32 copies on the CPU."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda and a.dtype == b.dtype:
        out = _MmF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def _chunk_logits(x, head_chunk):
    """``[N, Vb]`` float32 logits of one head chunk ``[Vb, D]``."""
    return _mm_f32(x, head_chunk.t())


class _BlockwiseCE(torch.autograd.Function):
    """Per-token loss ``[N]`` from x ``[N, D]``, head ``[V, D]`` and labels
    ``[N]`` that are all valid class ids (the reference's
    ``_blockwise_ce`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, head, labels, chunk):
        n, v = x.shape[0], head.shape[0]
        m = torch.full((n,), float("-inf"), device=x.device)
        s = torch.zeros(n, device=x.device)
        gold = torch.zeros(n, device=x.device)
        for base in range(0, v, chunk):
            logits = _chunk_logits(x, head[base:base + chunk])
            vb = logits.shape[1]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            local = labels - base
            in_chunk = (local >= 0) & (local < vb)
            gl = torch.gather(logits, 1, local.clamp(0, vb - 1)[:, None])
            gold = torch.where(in_chunk, gl[:, 0], gold)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(x, head, labels, lse)
        ctx.chunk = chunk
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        x, head, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dhead = torch.empty_like(head)
        g = g.float()
        for base in range(0, head.shape[0], chunk):
            hc = head[base:base + chunk]
            p = torch.exp(_chunk_logits(x, hc) - lse[:, None])
            vb = p.shape[1]
            local = labels - base
            in_chunk = ((local >= 0) & (local < vb)).float()
            p.scatter_add_(1, local.clamp(0, vb - 1)[:, None],
                           -in_chunk[:, None])
            d_logits = (p * g[:, None]).to(x.dtype)
            dx += _mm_f32(d_logits, hc)
            dhead[base:base + vb] = (d_logits.t() @ x).to(head.dtype)
        return dx.to(x.dtype), dhead, None, None


def fused_cross_entropy(x, head, labels, *, vocab_chunk: int = 4096,
                        reduction: str = "mean", ignore_index: int = -100):
    """Softmax cross entropy of ``x @ head.T`` against integer ``labels``
    without the whole logits.

    Labels equal to ``ignore_index``, or outside ``[0, V)``, give zero loss
    and zero gradient; ``reduction="mean"`` divides by the number of valid
    tokens.

    Args:
      x: ``[..., D]`` hidden states.
      head: ``[V, D]`` output projection.
      labels: integer ``[...]`` class ids.
      vocab_chunk: head rows per chunk (the tail chunk is shorter).
      reduction: ``"mean"`` | ``"sum"`` | ``"none"``.
      ignore_index: label value left out of loss and gradient.
    """
    if labels.is_floating_point() or labels.is_complex() \
            or labels.dtype == torch.bool:
        raise TypeError(
            f"fused_cross_entropy: labels must be integer class ids, got "
            f"{labels.dtype} (soft labels are not supported)")
    n = x.numel() // x.shape[-1]
    xf = x.reshape(n, x.shape[-1])
    lf = labels.reshape(n).long()
    valid = (lf != ignore_index) & (lf >= 0) & (lf < head.shape[0])
    # invalid rows compute a finite loss against class 0; the where()
    # zeroes both that loss and, through its backward, their gradient
    loss = _BlockwiseCE.apply(xf, head, torch.where(valid, lf, 0),
                              min(int(vocab_chunk), head.shape[0]))
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).to(loss.dtype)
    if reduction == "sum":
        return loss.sum()
    return loss.reshape(labels.shape)
