"""Loss functionals (port of ``cross_entropy`` of
``paddle_tpu/nn/functional/loss.py``)."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


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
