"""paddle_tpu_torch.io — Dataset/DataLoader (counterpart of
``paddle_tpu/io``; Paddle's python/paddle/io).

``DataLoader`` with Dataset/IterableDataset/TensorDataset, the samplers
and worker processes; batches land on the card through the pin-memory
stager of ``worker.py`` unless ``places``/``set_device`` say the CPU.
"""

from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,  # noqa: F401
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,  # noqa: F401
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)
from .dataloader import DataLoader, get_worker_info  # noqa: F401

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
           "DistributedBatchSampler", "WeightedRandomSampler",
           "SubsetRandomSampler", "DataLoader", "get_worker_info"]
