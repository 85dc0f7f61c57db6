"""``paddle.metric`` (port of ``paddle_tpu/metric.py``).

``Accuracy.compute`` and ``accuracy`` run on the tensors' device (a
top-k of the scores); the streaming updates reduce on the host, and
``accumulate`` returns Python floats, as in the reference. The
reference's ``Accuracy.update`` divides by the first axis of ``correct``
only, so over ``[B, S, V]`` scores it counts ``S`` positions a sample;
the port keeps that (ROADMAP C, "Reference behaviour")."""
from __future__ import annotations

import abc
from typing import List, Sequence, Union

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _np(x):
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    """Base metric (reference metrics.py:34)."""

    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def name(self):
        ...

    def compute(self, *args):
        """Optional pre-processing on (pred, label) Tensors; default
        passthrough (reference behavior)."""
        return args


class Accuracy(Metric):
    """reference metrics.py:183 — top-k accuracy."""

    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """``[..., maxk]`` float32 hits of the top ``maxk`` scores, on
        ``pred``'s device."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        idx = torch.topk(pred, self.maxk, dim=-1).indices
        if label.ndim == pred.ndim and label.shape[-1] == 1:
            label = label[..., 0]
        return (idx == label[..., None]).float()

    def update(self, correct, *args):
        correct = torch.as_tensor(correct)
        num = correct.shape[0] if correct.ndim else 1
        sums = [correct[..., :k].sum() for k in self.topk]
        accs = []
        for i, k in enumerate(self.topk):
            s = float(sums[i])
            self._sums[i] += s
            self._nums[i] += num
            accs.append(s / num if num else 0.0)
        return np.array(accs[0] if len(self.topk) == 1 else accs)

    def reset(self):
        self._sums = [0.0] * len(self.topk)
        self._nums = [0] * len(self.topk)

    def accumulate(self):
        res = [s / n if n else 0.0 for s, n in zip(self._sums, self._nums)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """reference metrics.py:333 — binary precision."""

    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """reference metrics.py:462 — binary recall."""

    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """reference metrics.py Auc — ROC-AUC via threshold bucketing."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc",
                 *args, **kwargs):
        super().__init__()
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2:   # [N, 2] softmax: positive-class prob
            pos = preds[:, 1]
        else:
            pos = preds.reshape(-1)
        buckets = np.clip(
            (pos * self._num_thresholds).astype(np.int64),
            0, self._num_thresholds)
        for b, l in zip(buckets, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self._num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(len(self._stat_pos) - 1, -1, -1):
            p = float(self._stat_pos[i])
            n = float(self._stat_neg[i])
            auc += n * (tot_pos + p / 2.0)
            tot_pos += p
            tot_neg += n
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy: scores ``[N, C]``, labels ``[N]`` or
    ``[N, 1]`` -> a float32 scalar tensor on ``input``'s device."""
    lab = label.reshape(-1).to(input.device)
    topk = torch.topk(input, k, dim=-1).indices
    return (topk == lab[:, None]).any(dim=1).float().mean()


__all__.append("accuracy")
