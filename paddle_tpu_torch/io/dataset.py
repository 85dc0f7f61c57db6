"""Datasets (port of ``paddle_tpu/io/dataset.py``).

A ``TensorDataset`` holds tensors or numpy arrays that share their first
axis. ``random_split`` draws its permutation from numpy, seeded as the
samplers are (``sampler._np_rng``); the reference draws it from a JAX
key, so the two packages split the same dataset differently.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence

import numpy as np
from ..core import enforce as E

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset has no __getitem__")

    def __len__(self):
        # TypeError so list()/length_hint treat it as "unsized"
        raise TypeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        lengths = {t.shape[0] for t in tensors}
        if len(lengths) != 1:
            raise E.InvalidArgumentError("all tensors must share dim 0")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: List[Dataset]):
        self.datasets = list(datasets)
        lengths = {len(d) for d in self.datasets}
        if len(lengths) != 1:
            raise E.InvalidArgumentError("all datasets must have the same length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            if isinstance(item, (tuple, list)):
                out.extend(item)
            else:
                out.append(item)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets: List[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets: Iterable[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        if ds_idx > 0:
            idx -= self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence, generator=None):
    """Disjoint ``Subset``s of ``lengths`` (or of fractions that sum to
    1) over a random permutation of ``dataset``'s indices."""
    from .sampler import _np_rng
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        counts = [int(np.floor(n * frac)) for frac in lengths]
        rem = n - sum(counts)
        for i in range(rem):
            counts[i % len(counts)] += 1
        lengths = counts
    total = sum(lengths)
    if total != len(dataset):
        raise E.InvalidArgumentError("sum of lengths != dataset size")
    perm = _np_rng(generator).permutation(total)
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l].tolist()))
        offset += l
    return out
