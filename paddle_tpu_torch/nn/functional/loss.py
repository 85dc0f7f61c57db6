"""Loss functionals (port of the hard-label branch of
``paddle_tpu/nn/functional/loss.py`` ``cross_entropy``)."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None):
    """``paddle.nn.functional.cross_entropy`` with integer labels:
    log-softmax in float32, ``ignore_index`` positions give 0 and leave
    the mean, ``weight`` per class (the mean is then over the summed
    weights), ``label_smoothing`` mixes in the mean log-probability.
    ``label`` may carry a trailing singleton axis. Soft (float, full
    shape) labels and ``use_softmax=False`` are not ported yet and
    raise."""
    del name
    if soft_label or not use_softmax or (label.is_floating_point()
                                         and label.shape == input.shape):
        raise NotImplementedError(
            "cross_entropy: soft labels and use_softmax=False are not "
            "ported yet (ROADMAP.md queue A item 1)")
    logp = torch.log_softmax(input.float(), dim=axis)
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
    if reduction == "sum":
        return loss.sum()
    return loss
