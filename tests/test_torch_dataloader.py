"""The port's ``io/`` (``paddle_tpu_torch/io``) against the reference's
(``paddle_tpu/io``) on the same numpy datasets: batches, dtypes and
shapes equal to the reference's unshuffled loader (inline, and with two
worker processes), shuffled epochs a permutation, ``pad_last_batch`` and
``last_batch_mask``, the samplers and dataset wrappers, a worker's
exception as ``WorkerError`` with its traceback, the ``dataloader.worker``
failpoint's crash respawned, ``get_worker_info`` inside a worker, a
dataset defined in ``__main__``.  Values are compared exactly (the loader
moves data, it computes nothing).  Batches land on the CPU here
(``places="cpu"``); the stager's card path is in
``tests/test_torch_cuda_kernels.py``."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (the reference package)
from paddle_tpu import io as jio

import paddle_tpu_torch as P
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io.worker import WorkerError, WorkerPool, np_collate
from paddle_tpu_torch.utils import failpoint as fp

ROOT = Path(__file__).resolve().parents[1]


class Rows:
    """Sample i: (float32 row of 4, int64 label, float32 scalar)."""

    def __init__(self, n=22):
        r = np.random.RandomState(0)
        self.x = r.randn(n, 4).astype(np.float32)
        self.y = r.randint(0, 10, n).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i], float(i) / 2


class Stream(tio.IterableDataset):
    def __iter__(self):
        for i in range(11):
            yield np.full(3, i, np.float32), i


class JStream(jio.IterableDataset):
    def __iter__(self):
        for i in range(11):
            yield np.full(3, i, np.float32), i


class Bad:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 3:
            raise ValueError("boom at 3")
        return np.zeros(2, np.float32)


class WhoAmI:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = tio.get_worker_info()
        return np.array([i, info.id, info.num_workers], np.int64)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fp.disable()


def host(batch):
    """A loader's batch as a list of numpy arrays (tensors of either
    package)."""
    items = batch if isinstance(batch, (list, tuple)) else [batch]
    return [np.asarray(b.numpy() if hasattr(b, "numpy") else b)
            for b in items]


def port_epoch(ds, **kw):
    return [host(b) for b in tio.DataLoader(ds, places="cpu", **kw)]


def ref_epoch(ds, **kw):
    return [host(b) for b in jio.DataLoader(ds, **kw)]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("kw", [dict(batch_size=8),
                                dict(batch_size=8, drop_last=True),
                                dict(batch_size=5, pad_last_batch=True)],
                         ids=["batch8", "drop_last", "pad_last"])
def test_unshuffled_batches_equal_the_reference(kw, num_workers):
    ds = Rows()
    assert_same(port_epoch(ds, num_workers=num_workers, **kw),
                ref_epoch(ds, **kw))


def test_iterable_dataset_and_raw_samples_equal_the_reference():
    assert_same(port_epoch(Stream(), batch_size=4),
                ref_epoch(JStream(), batch_size=4))
    assert_same(port_epoch(Stream(), batch_size=4, pad_last_batch=True),
                ref_epoch(JStream(), batch_size=4, pad_last_batch=True))
    ds = Rows(5)
    got = list(tio.DataLoader(ds, batch_size=None, places="cpu"))
    want = list(jio.DataLoader(ds, batch_size=None))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("num_workers", [0, 2])
def test_shuffled_epoch_is_a_permutation(num_workers):
    ds = Rows()
    P.seed(3)
    epochs = [port_epoch(ds, batch_size=4, shuffle=True,
                         num_workers=num_workers) for _ in range(2)]
    for ep in epochs:
        ys = np.concatenate([b[1] for b in ep])
        xs = np.concatenate([b[0] for b in ep])
        order = [int(np.flatnonzero((ds.x == row).all(1))[0]) for row in xs]
        assert sorted(order) == list(range(len(ds)))
        np.testing.assert_array_equal(ys, ds.y[order])
    assert not all(np.array_equal(a[0], b[0])
                   for a, b in zip(*epochs)), "two epochs, one order"
    P.seed(3)
    again = port_epoch(ds, batch_size=4, shuffle=True)
    assert_same(again, epochs[0])


def test_pad_last_batch_and_mask_equal_the_reference():
    ds = Rows(10)
    got = tio.DataLoader(ds, batch_size=4, pad_last_batch=True,
                         places="cpu")
    want = jio.DataLoader(ds, batch_size=4, pad_last_batch=True)
    masks = []
    for (g, w) in zip(got, want):
        for a, b in zip(host(g), host(w)):
            np.testing.assert_array_equal(a, b)
        masks.append((got.last_batch_mask().numpy(),
                      np.asarray(want.last_batch_mask().numpy())))
    assert len(masks) == 3
    for a, b in masks:
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(masks[-1][0], [True, True, False, False])
    assert got.last_batch_valid == want.last_batch_valid == 2


def test_samplers_and_dataset_wrappers_equal_the_reference():
    ds = Rows(10)
    for rank in (0, 1, 2):
        for shuffle in (False, True):
            a = tio.DistributedBatchSampler(ds, 2, num_replicas=3, rank=rank,
                                            shuffle=shuffle)
            b = jio.DistributedBatchSampler(ds, 2, num_replicas=3, rank=rank,
                                            shuffle=shuffle)
            a.set_epoch(4)
            b.set_epoch(4)
            assert list(a) == list(b) and len(a) == len(b)
    a, b = Rows(4), Rows(6)
    for tw, jw in ((tio.ConcatDataset([a, b]), jio.ConcatDataset([a, b])),
                   (tio.ComposeDataset([a, a]), jio.ComposeDataset([a, a])),
                   (tio.Subset(b, [5, 0, 2]), jio.Subset(b, [5, 0, 2]))):
        assert len(tw) == len(jw)
        for i in range(len(tw)):
            for u, v in zip(tw[i], jw[i]):
                np.testing.assert_array_equal(u, v)
    chained = [s for s in tio.ChainDataset([Stream(), Stream()])]
    assert len(chained) == 22 and chained[11][1] == 0
    x = np.arange(12).reshape(6, 2)
    t = tio.TensorDataset([x, x[:, 0]])
    assert len(t) == 6 and t[2][1] == 4
    for s in (tio.SequenceSampler(ds), jio.SequenceSampler(ds)):
        assert list(s) == list(range(10))
    assert list(tio.BatchSampler(ds, batch_size=3)) == \
        list(jio.BatchSampler(ds, batch_size=3))


def test_random_draws_follow_their_generator():
    ds = Rows(12)

    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        parts = tio.random_split(ds, [0.5, 0.25, 0.25], generator=g)
        return ([p.indices for p in parts],
                list(tio.RandomSampler(ds, generator=g)),
                list(tio.RandomSampler(ds, replacement=True, num_samples=5,
                                       generator=g)),
                list(tio.SubsetRandomSampler([3, 5, 7], generator=g)),
                list(tio.WeightedRandomSampler([0.0, 1.0, 3.0], 6,
                                               generator=g)))
    first = draws(7)
    assert first == draws(7) and first != draws(8)
    split, perm, repl, sub, weighted = first
    assert sorted(sum(split, [])) == list(range(12))
    assert [len(s) for s in split] == [6, 3, 3]
    assert sorted(perm) == list(range(12)) and len(repl) == 5
    assert sorted(sub) == [3, 5, 7] and 0 not in weighted


def test_workers_equal_inline_and_persist():
    ds = Rows(40)
    inline = port_epoch(ds, batch_size=8)
    dl = tio.DataLoader(ds, batch_size=8, num_workers=3, places="cpu",
                        persistent_workers=True)
    assert_same([host(b) for b in dl], inline)
    pool = dl._pool
    assert pool is not None
    assert_same([host(b) for b in dl], inline)
    assert dl._pool is pool
    dl.shutdown()
    assert dl._pool is None and not any(w.is_alive() for w in pool._workers)


def test_worker_exception_is_a_worker_error_with_its_traceback():
    dl = tio.DataLoader(Bad(), batch_size=1, num_workers=2, places="cpu")
    with pytest.raises(WorkerError, match="boom at 3") as e:
        list(dl)
    assert e.value.exc_type == "ValueError"
    assert "__getitem__" in e.value.worker_traceback
    assert e.value.worker_id in (0, 1)


def test_worker_failpoint_crash_is_respawned(monkeypatch):
    """Each initial worker hard-crashes once (injected); the pool
    respawns them and the epoch completes in order, as the reference's
    pool does (tests/test_fault_injection.py)."""
    monkeypatch.setenv("PADDLE_WORKER_START_METHOD", "spawn")
    monkeypatch.setenv("FLAGS_fault_injection", "dataloader.worker=error,n=1")
    ds = Rows(32)
    pool = WorkerPool(ds, num_workers=2, collate_fn=np_collate)
    monkeypatch.delenv("FLAGS_fault_injection")
    try:
        batches = [list(range(i, i + 4)) for i in range(0, 32, 4)]
        out = list(pool.run_epoch(batches))
        assert len(out) == len(batches)
        for b, idx in zip(out, batches):
            np.testing.assert_array_equal(b[0], ds.x[idx])
            np.testing.assert_array_equal(b[1], ds.y[idx])
        assert pool._respawns >= 1
    finally:
        pool.shutdown()


def test_get_worker_info_inside_a_worker():
    assert tio.get_worker_info() is None
    rows = np.concatenate([b[0] for b in port_epoch(
        WhoAmI(), batch_size=2, num_workers=2)])
    np.testing.assert_array_equal(rows[:, 0], np.arange(8))
    # batch k goes to worker k % 2
    np.testing.assert_array_equal(rows[:, 1], (np.arange(8) // 2) % 2)
    assert (rows[:, 2] == 2).all()


MAIN_SCRIPT = """
import json, sys
import numpy as np
if sys.argv[1] == "port":
    from paddle_tpu_torch.io import DataLoader, Dataset
    kw = dict(places="cpu")
else:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from paddle_tpu.io import DataLoader, Dataset
    kw = {}


class Squares(Dataset):   # defined in __main__, no main guard
    def __len__(self):
        return 6

    def __getitem__(self, i):
        return np.array([i, i * i], np.int64)


out = [np.asarray(b.numpy()).tolist()
       for b in DataLoader(Squares(), batch_size=4, num_workers=2, **kw)]
print(json.dumps(out))
"""


def test_dataset_defined_in_main_matches_the_reference(tmp_path):
    """A dataset class defined in the main script (no ``__main__`` guard)
    reaches forkserver workers by value, in both packages."""
    script = tmp_path / "main_dataset.py"
    script.write_text(textwrap.dedent(MAIN_SCRIPT))
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    outs = {}
    for pkg in ("port", "reference"):
        res = subprocess.run([sys.executable, str(script), pkg], env=env,
                             capture_output=True, text=True, timeout=240,
                             cwd=tmp_path)
        assert res.returncode == 0, res.stderr[-2000:]
        outs[pkg] = json.loads(res.stdout.strip().splitlines()[-1])
    assert outs["port"] == outs["reference"] == \
        [[[i, i * i] for i in range(4)], [[4, 16], [5, 25]]]
