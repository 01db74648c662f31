"""Samplers (counterpart of ``paddle_tpu/io/sampler.py``; Paddle's
python/paddle/io/dataloader/{sampler,batch_sampler}.py).

Every shuffle draws from a ``torch.Generator``: the sampler's
``generator`` where given, else the CPU generator of
``core/random_state`` (``paddle_tpu_torch.seed`` reseeds it), where the
reference draws from numpy's global state.  ``DistributedBatchSampler``
keeps the reference's epoch-seeded ``RandomState`` shuffle, so every rank
draws the same permutation, and shards it by ``distributed.env``'s rank
and world size.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

from .dataset import cpu_generator

__all__ = ["Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
           "DistributedBatchSampler", "WeightedRandomSampler",
           "SubsetRandomSampler"]


class Sampler:
    def __init__(self, data_source=None) -> None:
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None) -> None:
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        g = cpu_generator(self.generator)
        if self.replacement:
            return iter(torch.randint(0, n, (self.num_samples,),
                                      generator=g).tolist())
        return iter(torch.randperm(n, generator=g)[:self.num_samples]
                    .tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None) -> None:
        super().__init__(None)
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        perm = torch.randperm(len(self.indices),
                              generator=cpu_generator(self.generator))
        return iter(self.indices[i] for i in perm.tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True,
                 generator=None) -> None:
        super().__init__(None)
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        idx = torch.multinomial(torch.from_numpy(self.weights),
                                self.num_samples, self.replacement,
                                generator=cpu_generator(self.generator))
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False) -> None:
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def __iter__(self):
        batch: List[int] = []
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
    """Shards the index stream over data-parallel ranks (Paddle's
    python/paddle/io/dataloader/batch_sampler.py DistributedBatchSampler)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False) -> None:
        from ..distributed.env import get_rank, get_world_size
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.nranks = num_replicas if num_replicas is not None else \
            max(get_world_size(), 1)
        self.local_rank = rank if rank is not None else max(get_rank(), 0)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate(
            [indices, indices[:self.total_size - n]]).tolist()
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch: List[int] = []
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

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
