"""The port's ``metric/`` against the reference's on the same numpy
inputs: ``accuracy``, ``Accuracy`` (top-k, index and one-hot labels, tied
scores), ``Precision``, ``Recall`` and ``Auc`` — the running values after
several updates and the per-batch results, equal (float32 means of 0/1
within 1e-7; counts exact)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as jmetric

from paddle_tpu_torch import metric as tmetric


def batches(seed, n_batches=3, rows=16, classes=5):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        logits = r.randn(rows, classes).astype(np.float32)
        logits[::5, 1] = logits[::5, 3]       # ties: the lower index wins
        labels = r.randint(0, classes, (rows, 1)).astype(np.int64)
        out.append((logits, labels))
    return out


@pytest.mark.parametrize("k", [1, 2])
def test_accuracy_function(k):
    for logits, labels in batches(0):
        got = tmetric.accuracy(torch.from_numpy(logits),
                               torch.from_numpy(labels), k=k)
        want = jmetric.accuracy(paddle.to_tensor(logits),
                                paddle.to_tensor(labels), k=k)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(), float(want.numpy()),
                                   rtol=1e-7)


@pytest.mark.parametrize("onehot", [False, True])
def test_accuracy_metric_topk(onehot):
    got, want = tmetric.Accuracy(topk=(1, 3)), jmetric.Accuracy(topk=(1, 3))
    assert got.name() == want.name() == "acc"
    for logits, labels in batches(1):
        if onehot:
            labels = np.eye(5, dtype=np.float32)[labels[:, 0]]
        c_port = got.compute(torch.from_numpy(logits),
                             torch.from_numpy(labels))
        c_ref = want.compute(paddle.to_tensor(logits),
                             paddle.to_tensor(labels))
        np.testing.assert_array_equal(c_port.numpy(),
                                      np.asarray(c_ref.numpy()))
        assert got.update(c_port) == want.update(c_ref)
    assert got.accumulate() == want.accumulate()
    got.reset()
    assert got.accumulate() == [0.0, 0.0]


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall(cls):
    got, want = getattr(tmetric, cls)(), getattr(jmetric, cls)()
    r = np.random.RandomState(2)
    for _ in range(4):
        preds = r.rand(32, 1).astype(np.float32)
        labels = r.randint(0, 2, (32, 1)).astype(np.int64)
        got.update(torch.from_numpy(preds), torch.from_numpy(labels))
        want.update(paddle.to_tensor(preds), paddle.to_tensor(labels))
    assert got.accumulate() == want.accumulate()
    assert got.name() == want.name()
    got.reset()
    assert got.accumulate() == 0.0


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc(two_columns):
    got, want = tmetric.Auc(num_thresholds=255), \
        jmetric.Auc(num_thresholds=255)
    r = np.random.RandomState(3)
    for _ in range(3):
        p = r.rand(64).astype(np.float32)
        preds = np.stack([1 - p, p], 1) if two_columns else p
        labels = (r.rand(64) < p).astype(np.int64)
        got.update(torch.from_numpy(preds), torch.from_numpy(labels))
        want.update(paddle.to_tensor(preds), paddle.to_tensor(labels))
    np.testing.assert_array_equal(got._stat_pos, want._stat_pos)
    np.testing.assert_array_equal(got._stat_neg, want._stat_neg)
    assert got.accumulate() == want.accumulate()
    assert 0.5 < got.accumulate() <= 1.0
    got.reset()
    assert got.accumulate() == 0.0
