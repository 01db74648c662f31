"""DataLoader (counterpart of ``paddle_tpu/io/dataloader.py``; Paddle's
python/paddle/io/reader.py:216).

``num_workers > 0`` runs a pool of worker processes (``worker.py``):
they fetch and collate to numpy arrays or CPU tensors, the parent
reorders them and ``DeviceStager`` moves them to the loader's device on
its pin-memory thread, a batch ahead of the consumer.  ``num_workers ==
0`` iterates inline.  Batches land on ``places`` (the first of a list:
"cpu", "gpu", "gpu:N", a torch device), else on the current device
(``set_device``; the card unless set to the CPU).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from ..core.place import resolve_device
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler
from .worker import _as_cpu_tensor, _leaves

__all__ = ["DataLoader", "get_worker_info", "default_collate_fn"]

_worker_info = threading.local()


class WorkerInfo:
    def __init__(self, id=0, num_workers=0, dataset=None) -> None:
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def get_worker_info():
    """The ``WorkerInfo`` of the worker (process or prefetch thread) this
    runs in, else None."""
    return getattr(_worker_info, "info", None)


def default_collate_fn(batch):
    """Stack a list of samples into CPU tensors (the loader moves them to
    its device)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (str, bytes)):
        return list(batch)
    return torch.as_tensor(np.asarray(batch))


def _place_of(places) -> torch.device:
    if isinstance(places, (list, tuple)):
        places = places[0] if places else None
    if places is None:
        return resolve_device(None)
    name = str(places)
    if name.startswith("gpu"):
        name = "cuda" + name[3:]
    return resolve_device(name)


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, pad_last_batch=False) -> None:
        self.dataset = dataset
        self.places = places
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self.use_buffer_reader = use_buffer_reader
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._pool = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        # pad a ragged final batch to the steady-state batch size so a
        # captured step keeps its signature on the last batch of an epoch;
        # mask-aware via last_batch_valid / last_batch_mask()
        self.pad_last_batch = bool(pad_last_batch)
        self.last_batch_valid = None
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
            self._pad_target = batch_size
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self._pad_target = getattr(batch_sampler, "batch_size", None)
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
            self._pad_target = None
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
            self._pad_target = batch_size

    def _place(self) -> torch.device:
        return _place_of(self.places)

    # -- ragged-final-batch padding -----------------------------------
    def _pad_list(self, items):
        """(padded_items, real_count): pad a short batch's samples or
        indices to the steady-state batch size by repeating the final
        element.  Repeating samples (pre-collate) keeps every dtype and
        value range valid — embedding ids stay in-vocabulary, labels
        stay in-range — and works identically for the inline and
        multiprocess paths."""
        items = list(items)
        n = len(items)
        t = self._pad_target or 0
        if not self.pad_last_batch or n == 0 or t <= n:
            return items, n
        return items + [items[-1]] * (t - n), n

    def last_batch_mask(self) -> torch.Tensor:
        """Boolean tensor [batch_size] on the loader's device — True for
        the real rows of the batch most recently YIELDED by this loader
        (all True for a full batch); feed it to a masked loss so the
        padding never trains.  Read it between batches."""
        t = self._pad_target or 0
        n = self.last_batch_valid if self.last_batch_valid is not None else t
        return torch.arange(max(t, n), device=self._place()) < n

    def __len__(self) -> int:
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    @staticmethod
    def _to_place(tree, device):
        return _leaves(tree, lambda x: _as_cpu_tensor(x).to(device))

    def _iter_batches(self, device) -> Iterator[Any]:
        if self._iterable_mode:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    self.last_batch_valid = len(batch)
                    yield self._to_place(self.collate_fn(batch), device)
                    batch = []
            if batch and not self.drop_last:
                padded, n = self._pad_list(batch)
                self.last_batch_valid = n
                yield self._to_place(self.collate_fn(padded), device)
        elif self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
        else:
            for indices in self.batch_sampler:
                padded, n = self._pad_list(indices)
                self.last_batch_valid = n
                yield self._to_place(
                    self.collate_fn([self.dataset[i] for i in padded]),
                    device)

    # -- multiprocess path --------------------------------------------
    def _ensure_pool(self):
        from .worker import WorkerPool, np_collate
        if self._pool is None:
            user_collate = None if self.collate_fn is default_collate_fn \
                else self.collate_fn
            self._pool = WorkerPool(
                self.dataset, self.num_workers,
                user_collate or np_collate, self.worker_init_fn,
                self.prefetch_factor, self.timeout)
        return self._pool

    def _iter_multiprocess(self, device) -> Iterator[Any]:
        from .worker import DeviceStager
        pool = self._ensure_pool()
        batches = []
        valids = []
        for ix in self.batch_sampler:
            padded, n = self._pad_list(ix)
            batches.append(padded)
            valids.append(n)
        stager = DeviceStager(device, depth=2)
        try:
            # last_batch_valid must track the batch the CONSUMER holds,
            # not the stager's prefetch position — update per yield
            for i, batch in enumerate(stager.stage(pool.run_epoch(batches))):
                self.last_batch_valid = valids[i]
                yield batch
        finally:
            if not self.persistent_workers:
                pool.shutdown()
                self._pool = None
            else:
                # consumer may have stopped early: unblock run_epoch so
                # the stager's pump thread can exit (no thread leak)
                pool.abandon_epoch()

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 — interpreter-teardown destructor
            pass

    def __iter__(self) -> Iterator[Any]:
        device = self._place()
        # batch_size=None (raw-sample mode) keeps inline semantics: the
        # worker path would wrap each sample as a 1-element batch
        if self.num_workers > 0 and not self._iterable_mode and \
                self.batch_sampler is not None:
            yield from self._iter_multiprocess(device)
            return
        if not self.use_buffer_reader or self.num_workers == 0:
            yield from self._iter_batches(device)
            return
        # background prefetch thread (the pin-memory-thread role)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor *
                                       max(self.num_workers, 1))
        sentinel = object()
        err: list = []

        def producer():
            _worker_info.info = WorkerInfo(0, self.num_workers, self.dataset)
            try:
                for b in self._iter_batches(device):
                    q.put(b)
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
