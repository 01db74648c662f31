"""Metrics (counterpart of ``paddle_tpu/metric``; Paddle's
python/paddle/metric: Metric, Accuracy, Precision, Recall, Auc,
paddle.metric.accuracy).

``accuracy`` and ``Accuracy.compute`` run on the tensors' device (the
card in a fit); ``update`` and ``accumulate`` keep the running counts on
the host, as the reference does, so ``update`` reads its input back once.
Top-k uses a stable sort of the negated scores, as the reference's
``argsort`` does, so ties go to the lower class index.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _topk_idx(scores: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(-scores, dim=-1, stable=True).indices[..., :k]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def accuracy(input, label, k=1, correct=None, total=None,
             name=None) -> torch.Tensor:
    """The share of rows whose label is among the top ``k`` scores, a
    0-dim float32 tensor on the input's device."""
    lab = label
    if lab.dim() == input.dim():
        lab = lab.reshape(lab.shape[:-1]) if lab.shape[-1] == 1 else lab
    match = (_topk_idx(input, k) == lab[..., None]).any(dim=-1)
    return match.to(torch.float32).mean()


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs) -> None:
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """(rows, maxk) float32: 1 where the i-th best score is the
        label (an index, or one-hot)."""
        if label.dim() + 1 == pred.dim() or \
                (label.dim() == pred.dim() and label.shape[-1] == 1):
            lab = label.reshape(label.shape[:pred.dim() - 1])
        else:  # one-hot
            lab = label.argmax(dim=-1)
        correct = _topk_idx(pred, self.maxk) == lab[..., None]
        return correct.to(torch.float32)

    def update(self, correct, *args):
        arr = _host(correct)
        arr = arr.reshape(-1, arr.shape[-1])
        accs = []
        for i, k in enumerate(self.topk):
            num = float(arr[:, :k].sum())
            self.total[i] += num
            self.count[i] += arr.shape[0]
            accs.append(num / arr.shape[0])
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


def _binary(preds, labels):
    p = (_host(preds).reshape(-1) > 0.5).astype(np.int32)
    lab = _host(labels).reshape(-1).astype(np.int32)
    return p, lab


class Precision(Metric):
    def __init__(self, name=None) -> None:
        self._name = name or "precision"
        self.reset()

    def update(self, preds, labels):
        p, lab = _binary(preds, labels)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None) -> None:
        self._name = name or "recall"
        self.reset()

    def update(self, preds, labels):
        p, lab = _binary(preds, labels)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None) -> None:
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _host(preds)
        lab = _host(labels)
        if p.ndim == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        lab = lab.reshape(-1)
        bins = np.minimum((p * self.num_thresholds).astype(np.int64),
                          self.num_thresholds - 1)
        pos = lab.astype(bool)
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # accumulate from the highest threshold down
        tpr = self._stat_pos[::-1].cumsum() / tot_pos
        fpr = self._stat_neg[::-1].cumsum() / tot_neg
        return float(np.trapezoid(tpr, fpr)) if hasattr(np, "trapezoid") \
            else float(np.trapz(tpr, fpr))

    def name(self):
        return self._name
