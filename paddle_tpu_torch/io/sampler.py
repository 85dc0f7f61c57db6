"""Samplers (port of ``paddle_tpu/io/sampler.py``).

Every draw comes from ``numpy.random.default_rng``, as in the reference,
so an explicit seed (an int, a ``SeedSequence`` or a numpy ``Generator``
as ``generator``) gives the same indices in both packages. Without one,
the seed is drawn from the port's CPU generator (``paddle_tpu_torch.seed``
controls it); the reference draws it from its JAX key.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np


def _np_rng(generator=None):
    """A numpy ``Generator``: from ``generator`` when it is an int, a
    ``SeedSequence`` or a numpy ``Generator``; from a seed drawn from a
    ``torch.Generator`` (default: the port's seeded CPU generator)
    otherwise."""
    import torch
    if generator is None or isinstance(generator, torch.Generator):
        if generator is None:
            from ..framework import random as frandom
            generator = frandom.default_generator("cpu")
        seed = int(torch.randint(0, 2**32, (1,), generator=generator,
                                 dtype=torch.int64))
        return np.random.default_rng(seed)
    return np.random.default_rng(generator)


__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "SubsetRandomSampler"]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = _np_rng(self.generator)
        if self.replacement:
            yield from rng.integers(0, n, size=self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[:self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        super().__init__(indices)
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        rng = _np_rng(self.generator)
        yield from (self.indices[i]
                    for i in rng.permutation(len(self.indices)))

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = _np_rng()
        idx = rng.choice(len(self.weights), size=self.num_samples,
                         replace=self.replacement, p=p)
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batches (reference: batch_sampler.py
    DistributedBatchSampler). Rank/world default to the distributed env."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed import env as dist
            num_replicas = num_replicas if num_replicas is not None \
                else dist.get_world_size()
            rank = rank if rank is not None else dist.get_rank()
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        n = len(dataset)
        if drop_last:
            self.num_samples = n // self.nranks
        else:
            self.num_samples = (n + self.nranks - 1) // self.nranks
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        # pad to be evenly divisible
        if not self.drop_last and len(indices) < self.total_size:
            indices += indices[:self.total_size - len(indices)]
        indices = indices[:self.total_size]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size
