"""Multiprocess DataLoader workers and the device stager (counterpart of
``paddle_tpu/io/worker.py``; Paddle's
python/paddle/io/dataloader/dataloader_iter.py and worker.py).

Worker processes fetch and collate batches to numpy arrays or CPU
tensors and never initialise CUDA: the card belongs to the parent.  The
parent reassembles batches in order (``WorkerPool.run_epoch``) and
``DeviceStager`` moves them to the card on a thread of its own, the
pin-memory thread: each batch is copied into pinned host memory, then to
the card by ``non_blocking`` copies on the stager's own CUDA stream, and
handed over with the event that ends those copies.  The consumer's
stream waits on that event and each device tensor is recorded as used by
the consumer's stream, so the allocator does not hand its memory to the
stager's next copy while the model still reads it.  With depth 2 the next
batch is in flight while the model runs on this one.  A pinned buffer
comes from PyTorch's caching host allocator, which keeps it from reuse
until the copy that reads it has completed.

The dataset, collate function and ``worker_init_fn`` go to the workers
pickled by value with ``cloudpickle``, as in the reference, so a dataset
defined in ``__main__`` needs no re-import of the main module.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import pickle
import queue as _queue
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils import failpoint as _fp
from ..utils.retry import RetryPolicy

__all__ = ["np_collate", "WorkerPool", "DeviceStager", "ExceptionWrapper",
           "WorkerError"]

logger = logging.getLogger("paddle_tpu_torch.io")


class WorkerError(RuntimeError):
    """Structured error from a DataLoader worker process: carries the
    worker id and the worker-side exception type/traceback instead of
    silently collapsing them into a bare RuntimeError."""

    def __init__(self, worker_id: int, exc_type: str, tb: str) -> None:
        super().__init__(
            f"DataLoader worker {worker_id} raised {exc_type}:\n{tb}")
        self.worker_id = worker_id
        self.exc_type = exc_type
        self.worker_traceback = tb


class ExceptionWrapper:
    def __init__(self, exc: BaseException, worker_id: int = -1) -> None:
        self.exc_type = type(exc).__name__
        self.worker_id = worker_id
        self.tb = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))

    def reraise(self) -> None:
        raise WorkerError(self.worker_id, self.exc_type, self.tb)


def np_collate(batch):
    """Stack a list of samples into numpy arrays (CPU tensors for tensor
    samples): the workers' collate."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (tuple, list)):
        return [np_collate(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: np_collate([d[k] for d in batch]) for k in sample}
    if isinstance(sample, (str, bytes)):
        return list(batch)
    return np.asarray(batch)


def _worker_loop(payload, index_queue, data_queue,
                 worker_id: int, num_workers: int) -> None:
    # worker body: map-style fetch + collate, on the CPU only
    try:
        torch.set_num_threads(1)
        dataset, collate_fn, worker_init_fn = pickle.loads(payload)
        from .dataloader import WorkerInfo, _worker_info
        _worker_info.info = WorkerInfo(worker_id, num_workers, dataset)
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
    except BaseException as e:  # init failure: poison every future fetch
        data_queue.put((None, -1, ExceptionWrapper(e, worker_id)))
        return
    while True:
        task = index_queue.get()
        if task is None:
            break
        if _fp.ACTIVE:
            try:
                # 'error' models a hard worker crash (OOM-kill, segv):
                # exit without a traceback so the parent's dead-worker
                # respawn path — not the exception path — must recover
                _fp.inject("dataloader.worker")
            except _fp.FailpointError:
                os._exit(3)
        epoch, batch_idx, indices = task
        try:
            out = collate_fn([dataset[i] for i in indices])
            data_queue.put((epoch, batch_idx, out))
        except BaseException as e:  # noqa: BLE001
            data_queue.put((epoch, batch_idx, ExceptionWrapper(e, worker_id)))


_prep_tls = threading.local()
_prep_patched = [False]
_prep_lock = threading.Lock()


class _no_main_reexec:
    """Our workers receive dataset/collate BY VALUE (cloudpickle), so the
    spawn machinery's re-execution of the parent's ``__main__`` is both
    unnecessary and fragile (stdin and notebook scripts have no main
    file).  The patch on ``get_preparation_data`` is
    installed ONCE and delegates to the original unless THIS thread is
    inside a WorkerPool start, so concurrent Process starts elsewhere keep
    stock spawn semantics."""

    def __enter__(self):
        with _prep_lock:
            if not _prep_patched[0]:
                import multiprocessing.spawn as _mp_spawn
                orig = _mp_spawn.get_preparation_data

                def _prep(name):
                    d = orig(name)
                    if getattr(_prep_tls, "active", 0):
                        d.pop("init_main_from_path", None)
                        d.pop("init_main_from_name", None)
                    return d

                _mp_spawn.get_preparation_data = _prep
                _prep_patched[0] = True
        _prep_tls.active = getattr(_prep_tls, "active", 0) + 1
        return self

    def __exit__(self, *exc):
        _prep_tls.active -= 1
        return False


class WorkerPool:
    """N worker processes + in-order reassembly of an index stream."""

    def __init__(self, dataset, num_workers: int, collate_fn,
                 worker_init_fn=None, prefetch_factor: int = 2,
                 timeout: float = 0) -> None:
        self.num_workers = num_workers
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self.timeout = timeout
        self._closed = False
        self._workers = []
        self._index_queues = []
        # 'fork' in a process that holds CUDA state and threads (the
        # stager's, autograd's) duplicates their locks into the child, so
        # the default is forkserver on Linux / spawn elsewhere; 'fork'
        # stays an explicit opt-in for unpicklable datasets
        method = os.environ.get(
            "PADDLE_WORKER_START_METHOD",
            "forkserver" if sys.platform.startswith("linux") else "spawn")
        ctx = mp.get_context(method)
        if method == "forkserver":
            # the server imports these once and forks each worker from
            # itself; importing torch does not initialise CUDA
            ctx.set_forkserver_preload(["numpy", "torch",
                                        "paddle_tpu_torch.io.worker"])
        self._ctx = ctx
        self._method = method
        self._index_queues = [ctx.Queue() for _ in range(num_workers)]
        self._data_queue = ctx.Queue()
        import cloudpickle
        self._payload = cloudpickle.dumps(
            (dataset, collate_fn, worker_init_fn))
        with _no_main_reexec():
            for wid in range(num_workers):
                try:
                    self._workers.append(self._spawn_worker(wid))
                except Exception as e:
                    self.shutdown()
                    raise RuntimeError(
                        f"failed to start DataLoader worker with the "
                        f"'{method}' start method ({e}); if the dataset or "
                        f"collate_fn is not picklable, set "
                        f"PADDLE_WORKER_START_METHOD=fork") from e
        self._epoch = 0
        self._abandon = False
        # Crashed workers (OOM-kill, injected faults) are respawned under
        # this budget instead of failing the epoch outright; exceeding it
        # raises.
        self._respawn_policy = RetryPolicy(max_attempts=3,
                                           initial_backoff=0.1,
                                           max_backoff=1.0)
        self._respawns = 0

    def _spawn_worker(self, wid: int):
        w = self._ctx.Process(
            target=_worker_loop,
            args=(self._payload, self._index_queues[wid],
                  self._data_queue, wid, self.num_workers),
            daemon=True)
        w.start()
        return w

    def _respawn_dead(self, dead: List[int]) -> None:
        """Replace dead workers within the per-epoch retry budget
        (max_attempts respawns per worker slot, backoff applied per
        respawn), or raise once the budget is exhausted."""
        budget = self._respawn_policy.max_attempts * self.num_workers
        for wid in dead:
            self._respawns += 1
            if self._respawns > budget:
                raise RuntimeError(
                    f"DataLoader worker {wid} died (exit code "
                    f"{self._workers[wid].exitcode}) and the per-epoch "
                    f"respawn budget ({budget}) is exhausted")
            logger.warning(
                "DataLoader worker %d died (exit code %s); respawning "
                "(%d so far)", wid, self._workers[wid].exitcode,
                self._respawns)
            self._respawn_policy.sleep(
                self._respawn_policy.backoff(self._respawns))
            with _no_main_reexec():
                self._workers[wid] = self._spawn_worker(wid)

    def abandon_epoch(self) -> None:
        """Tell a blocked run_epoch (persistent pool, consumer gone) to
        return instead of waiting for more results."""
        self._abandon = True

    def run_epoch(self, batches: List[List[int]]):
        """Yield collated batches for `batches`, in order.

        Each epoch carries an id: results of an ABANDONED earlier epoch
        (consumer broke out mid-iteration with persistent workers) still
        sitting on the shared data queue are recognised and discarded
        instead of being served as this epoch's batches."""
        self._epoch += 1
        self._abandon = False
        self._respawns = 0   # respawn budget is per epoch, not per pool
        epoch = self._epoch
        send_idx = 0
        rcvd: Dict[int, Any] = {}
        next_idx = 0
        outstanding = 0
        budget = self.prefetch_factor * self.num_workers

        def dispatch():
            nonlocal send_idx, outstanding
            while send_idx < len(batches) and outstanding < budget:
                self._index_queues[send_idx % self.num_workers].put(
                    (epoch, send_idx, batches[send_idx]))
                send_idx += 1
                outstanding += 1

        dispatch()
        waited = 0.0
        while next_idx < len(batches):
            if next_idx not in rcvd:
                # short poll so a dead worker / closed pool is noticed
                try:
                    ep, idx, data = self._data_queue.get(timeout=1.0)
                except _queue.Empty:
                    if self._closed or self._abandon:
                        return  # epoch abandoned / pool shut down
                    dead = [i for i, w in enumerate(self._workers)
                            if not w.is_alive()]
                    if dead:
                        # respawn within budget, then re-dispatch every
                        # batch the dead workers may have taken with them
                        # (duplicate deliveries are deduped on receive)
                        self._respawn_dead(dead)
                        for i in range(next_idx, send_idx):
                            if i not in rcvd and i % self.num_workers \
                                    in dead:
                                self._index_queues[i % self.num_workers] \
                                    .put((epoch, i, batches[i]))
                        waited = 0.0
                        continue
                    waited += 1.0
                    if self.timeout and waited >= self.timeout:
                        raise RuntimeError(
                            f"DataLoader timed out after {self.timeout}s "
                            f"waiting for batch {next_idx}")
                    continue
                waited = 0.0
                if ep is not None and ep != epoch:
                    continue  # stale result from an abandoned epoch
                if idx >= 0 and (idx < next_idx or idx in rcvd):
                    # duplicate delivery after a re-dispatch (even a
                    # failed duplicate of a batch that already arrived
                    # intact must not kill the epoch); idx -1 is the
                    # init-failure poison and always falls through
                    continue
                if isinstance(data, ExceptionWrapper):
                    data.reraise()
                rcvd[idx] = data
                outstanding -= 1
                dispatch()
                continue
            yield rcvd.pop(next_idx)
            next_idx += 1

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        for q in self._index_queues:
            q.put(None)
        # drain what the workers still write, so none blocks at exit on a
        # full pipe, while joining them; one still alive after 5 s is
        # terminated
        deadline = time.monotonic() + 5.0
        for w in self._workers:
            while w.is_alive() and time.monotonic() < deadline:
                try:
                    self._data_queue.get(timeout=0.05)
                except _queue.Empty:
                    w.join(timeout=0.05)
            if w.is_alive():
                w.terminate()
                w.join(timeout=1.0)
        for q in self._index_queues + [self._data_queue]:
            q.close()
            q.cancel_join_thread()

    def __del__(self):
        self.shutdown()


def _leaves(tree, fn):
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return [_leaves(t, fn) for t in tree]
    if isinstance(tree, dict):
        return {k: _leaves(v, fn) for k, v in tree.items()}
    return tree


def _flat(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _flat(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _flat(t, out)
    return out


def _as_cpu_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x


class DeviceStager:
    """The pin-memory thread: moves each collated batch (numpy arrays or
    CPU tensors) to ``device`` on a background thread, at most ``depth``
    batches ahead of the consumer.  On the CPU a batch becomes CPU
    tensors; on the card it is pinned, copied on the stager's own stream
    and handed over behind that copy's event (see the module docstring)."""

    def __init__(self, device, depth: int = 2) -> None:
        self.device = torch.device(device)
        self.depth = max(int(depth), 1)
        self._stream = None

    def _to_device(self, tree):
        """(device tree, event or None), issued on the stager's stream."""
        if self.device.type != "cuda":
            return _leaves(tree, _as_cpu_tensor), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)

        def copy(x):
            pinned = _as_cpu_tensor(x).pin_memory()
            return pinned.to(self.device, non_blocking=True)

        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = _leaves(tree, copy)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _hand_over(self, tree, event):
        """Make the consumer's stream wait for the copies, and keep the
        allocator from reusing the batch until that stream is done."""
        if event is None:
            return tree
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for t in _flat(tree, []):
            t.record_stream(consumer)
        return tree

    def stage(self, batches):
        q: "_queue.Queue" = _queue.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()
        err: List[BaseException] = []

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def pump():
            try:
                for tree in batches:
                    if not _put(self._to_device(tree)) or stop.is_set():
                        break
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=pump, daemon=True,
                             name="dataloader-device-stager")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield self._hand_over(*item)
        finally:
            # consumer stopped early (break/exception): release the pump
            # thread and the device batches it holds
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
            t.join(timeout=5.0)
