"""Loss functionals (port of ``paddle_tpu/nn/functional/loss.py``).

Each computes what the reference's does, in float32 where the
reference casts to float32, with its reductions (``"mean"``, ``"sum"``,
``"none"``; ``kl_div`` also ``"batchmean"``), and each is registered
through the op seam (``ops/_op.py``) under its name, as the reference's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...ops._op import op_fn

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss", "nll_loss",
    "kl_div", "smooth_l1_loss", "margin_ranking_loss", "hinge_embedding_loss",
    "cosine_embedding_loss", "triplet_margin_loss", "log_loss",
    "square_error_cost", "sigmoid_focal_loss", "dice_loss", "npair_loss",
    "poisson_nll_loss", "multi_label_soft_margin_loss", "soft_margin_loss",
    "gaussian_nll_loss",
]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None):
    """``paddle.nn.functional.cross_entropy``, in float32.

    ``use_softmax`` takes the log-softmax of ``input``; without it
    ``input`` holds probabilities, and their log (clamped at 1e-30) is
    taken. Soft labels (``soft_label``, or a float ``label`` of
    ``input``'s shape) give ``-sum(label * logp)``, the label first mixed
    with the uniform distribution by ``label_smoothing``; a ``weight`` per
    class weighs each row by ``sum(label * weight)`` (the mean is then
    over those weights). Integer labels (``label`` may carry a trailing
    singleton axis): ``ignore_index`` positions give 0 and leave the
    mean, ``weight`` per class (the mean is then over the summed
    weights), ``label_smoothing`` mixes in the mean log-probability."""
    del name
    x = input.float()
    if use_softmax:
        logp = torch.log_softmax(x, dim=axis)
    else:
        logp = torch.log(torch.clamp(x, min=1e-30))
    nclass = input.shape[axis]
    if soft_label or (label.ndim == input.ndim and label.shape == input.shape
                      and label.is_floating_point()):
        soft = label.float()
        if label_smoothing > 0.0:
            soft = (1 - label_smoothing) * soft + label_smoothing / nclass
        loss = -(soft * logp).sum(dim=axis)
        if weight is not None:
            w = (soft * weight.float().reshape(
                (1,) * (input.ndim - 1) + (-1,))).sum(dim=axis)
            loss = loss * w
            if reduction == "mean":
                return loss.sum() / w.sum()
        return _reduce(loss, reduction)
    axis = axis % input.ndim
    lbl = label.squeeze(axis) if label.ndim == input.ndim else label
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        picked = ((1 - label_smoothing) * picked
                  + label_smoothing * logp.mean(dim=axis))
    loss = torch.where(valid, -picked, 0.0)
    if weight is not None:
        w = torch.where(valid, weight.float()[safe], 0.0)
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / torch.clamp(w.sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.float().sum(), min=1.0)
    return _reduce(loss, reduction)


def _pick(logp, label, axis, ignore_index):
    """``(-logp[label], valid)`` along ``axis`` for integer labels (a
    trailing singleton label axis is dropped)."""
    axis = axis % logp.ndim
    lbl = label.squeeze(axis) if label.ndim == logp.ndim else label
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    return torch.where(valid, -picked, 0.0), valid, safe


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100, numeric_stable_mode=True,
                               return_softmax: bool = False, axis: int = -1):
    """The loss with ``axis`` kept as a singleton; with
    ``return_softmax`` also the softmax in ``logits``' type."""
    del numeric_stable_mode
    logp = torch.log_softmax(logits.float(), dim=axis)
    if soft_label:
        loss = -(label.float() * logp).sum(dim=axis, keepdim=True)
    else:
        loss, _, _ = _pick(logp, label, axis, ignore_index)
        loss = loss.unsqueeze(axis % logits.ndim)
    if return_softmax:
        return loss, torch.exp(logp).to(logits.dtype)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction: str = "mean",
                         name=None):
    x = torch.clamp(input.float(), 1e-12, 1.0 - 1e-7)
    lbl = label.float()
    loss = -(lbl * torch.log(x) + (1 - lbl) * torch.log1p(-x))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction: str = "mean",
                                     pos_weight=None, name=None):
    z = logit.float()
    lbl = label.float()
    # numerically stable: max(z, 0) - z y + log(1 + exp(-|z|))
    loss = torch.clamp(z, min=0) - z * lbl + torch.log1p(torch.exp(-z.abs()))
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1) * lbl + 1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction: str = "mean", name=None):
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction: str = "mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


def square_error_cost(input, label):
    return torch.square(input - label)


def log_loss(input, label, epsilon: float = 1e-4, name=None):
    x = input.float()
    lbl = label.float()
    return (-lbl * torch.log(x + epsilon)
            - (1 - lbl) * torch.log1p(epsilon - x + 1e-30))


def nll_loss(input, label, weight=None, ignore_index: int = -100,
             reduction: str = "mean", name=None):
    """Over log-probabilities ``[N, C]`` and labels ``[N]``."""
    loss, valid, safe = _pick(input, label, 1, ignore_index)
    if weight is not None:
        w = torch.where(valid, weight[safe], 0.0)
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / torch.clamp(w.sum(), min=1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.float().sum(), min=1.0)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction: str = "mean", log_target: bool = False,
           name=None):
    lbl = label.float()
    if log_target:
        loss = torch.exp(lbl) * (lbl - input)
    else:
        loss = torch.where(lbl > 0, lbl * (torch.log(torch.clamp(
            lbl, min=1e-30)) - input), 0.0)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction: str = "mean",
                   delta: float = 1.0, name=None):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin: float = 0.0,
                        reduction: str = "mean", name=None):
    loss = torch.clamp(-label * (input - other) + margin, min=0.0)
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin: float = 1.0,
                         reduction: str = "mean", name=None):
    loss = torch.where(label == 1, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin: float = 0.0,
                          reduction: str = "mean", name=None):
    cos = (input1 * input2).sum(dim=-1) / torch.clamp(
        torch.linalg.norm(input1, dim=-1) * torch.linalg.norm(input2, dim=-1),
        min=1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin: float = 1.0,
                        p: float = 2.0, epsilon: float = 1e-6,
                        swap: bool = False, reduction: str = "mean",
                        name=None):
    def dist(a, b):
        return torch.pow(torch.pow(torch.abs(a - b) + epsilon, p).sum(
            dim=-1), 1.0 / p)
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha: float = 0.25,
                       gamma: float = 2.0, reduction: str = "sum",
                       name=None):
    z = logit.float()
    lbl = label.float()
    p = torch.sigmoid(z)
    ce = torch.clamp(z, min=0) - z * lbl + torch.log1p(torch.exp(-z.abs()))
    p_t = p * lbl + (1 - p) * (1 - lbl)
    a_t = alpha * lbl + (1 - alpha) * (1 - lbl)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon: float = 1e-5, name=None):
    lbl = TF.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(
        input.dtype)
    dims = tuple(range(1, input.ndim))
    inter = (input * lbl).sum(dim=dims)
    union = input.sum(dim=dims) + lbl.sum(dim=dims)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg: float = 0.002):
    batch = anchor.shape[0]
    lbl = labels.reshape(-1, 1).float()
    same = (lbl == lbl.t()).float()
    same = same / same.sum(dim=1, keepdim=True)
    logp = torch.log_softmax(anchor @ positive.t(), dim=1)
    ce = -(same * logp).sum(dim=1)
    l2 = l2_reg * ((anchor * anchor).sum() + (positive * positive).sum()) \
        / (2.0 * batch)
    return ce.mean() + l2


def poisson_nll_loss(input, label, log_input: bool = True, full: bool = False,
                     epsilon: float = 1e-8, reduction: str = "mean",
                     name=None):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = label * torch.log(label + epsilon) - label + \
            0.5 * torch.log(2 * math.pi * (label + epsilon))
        loss = loss + torch.where(label > 1, stirling, 0.0)
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction: str = "mean", name=None):
    loss = -(label * TF.logsigmoid(input)
             + (1 - label) * TF.logsigmoid(-input))
    loss = loss.mean(dim=-1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction: str = "mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def gaussian_nll_loss(input, variance, label, full: bool = False,
                      epsilon: float = 1e-6, reduction: str = "mean",
                      name=None):
    """The reference's argument order: ``(input, variance, label)``."""
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(input - label) / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def _register():
    g = globals()
    for name in __all__:
        g[name] = op_fn(g[name])


_register()
