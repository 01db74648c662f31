"""Datasets (counterpart of ``paddle_tpu/io/dataset.py``; Paddle's
python/paddle/io/dataloader/dataset.py).

Samples are whatever ``__getitem__`` returns: numpy arrays, Python
numbers or CPU tensors, so that worker processes never touch the card.
``random_split`` draws its permutation from a ``torch.Generator`` (the
CPU generator of ``core/random_state`` unless one is given), where the
reference draws from numpy's global state.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

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
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long arrays or tensors: sample ``i`` is the tuple
    of each one's row ``i``."""

    def __init__(self, tensors) -> None:
        lens = {t.shape[0] for t in tensors}
        if len(lens) != 1:
            raise ValueError("tensors must share dim-0 size")
        self.tensors = tensors

    def __getitem__(self, index):
        return tuple(t[index] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: List[Dataset]) -> None:
        self.datasets = list(datasets)
        lens = {len(d) for d in self.datasets}
        if len(lens) != 1:
            raise ValueError("datasets must share length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (tuple, list)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets: List[IterableDataset]) -> None:
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets: Iterable[Dataset]) -> None:
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = bisect.bisect_right(self.cumulative_sizes, idx)
        start = 0 if di == 0 else self.cumulative_sizes[di - 1]
        return self.datasets[di][idx - start]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]) -> None:
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def cpu_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or the CPU generator of ``core/random_state``."""
    if generator is not None:
        return generator
    from ..core.random_state import generator as _default
    return _default("cpu")


def random_split(dataset: Dataset, lengths: Sequence, generator=None):
    """Subsets of ``dataset`` of the given lengths (or fractions summing
    to 1) over one permutation drawn from ``generator``."""
    lengths = list(lengths)
    if all(isinstance(n, float) for n in lengths) and \
            abs(sum(lengths) - 1.0) < 1e-6:
        total = len(dataset)
        sizes = [int(np.floor(total * f)) for f in lengths]
        for i in range(total - sum(sizes)):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset size")
    perm = torch.randperm(len(dataset),
                          generator=cpu_generator(generator)).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out
