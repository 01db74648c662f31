"""``Model`` — the high-level train/eval/predict facade (counterpart of
``paddle_tpu/hapi/model.py``; Paddle's python/paddle/hapi/model.py:
Model:1054, fit:1756, evaluate:2005, predict:2116, save:1432, load:1508,
summary:2308).

One eager loop over the network, as in the reference: ``train_batch`` is
forward, loss, ``backward()``, ``optimizer.step()`` and ``clear_grad()``,
then the loss read back as a Python float (one host sync a step, the
reference's contract).  ``fit`` feeds it from a ``DataLoader`` (worker
processes and the pin-memory stager when ``num_workers > 0``).
``save``/``load`` write and read the reference's ``.pdparams``/``.pdopt``
files (``framework/io_utils.py``).  The reference's device-profiler and
numerics hooks in ``train_batch`` are ROADMAP item A5; ``save(training=
False)`` (``jit.save``) is A9.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..framework import io_utils as _io
from ..io.dataloader import DataLoader
from ..io.dataset import Dataset
from ..metric import Metric
from .callbacks import config_callbacks

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _item(x):
    """A one-element tensor as a Python float (one device-to-host sync),
    a larger one as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.item() if x.numel() == 1 else _numpy(x)
    return x


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; bfloat16, which numpy lacks, as
    float32 (exact)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _len_or_none(loader):
    try:
        return len(loader)
    except TypeError:  # iterable-mode DataLoader defines __len__ but raises
        return None


class Model:
    """High-level model wrapping a ``Layer``; Paddle's model.py:1054."""

    def __init__(self, network, inputs=None, labels=None) -> None:
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._save_dir = None
        self.stop_training = False

    # ------------------------------------------------------------- prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """Paddle's model.py:1700."""
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("loss must be callable (a function or Layer)")
        self._loss = loss
        for m in _to_list(metrics):
            if not isinstance(m, Metric):
                raise TypeError(f"metric must be paddle.metric.Metric, "
                                f"got {type(m)}")
        self._metrics = _to_list(metrics)
        self._amp_configs = amp_configs

    # ------------------------------------------------------- batch methods
    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            raise RuntimeError("loss not set; call prepare(loss=...) first")
        return self._loss(*(_to_list(outputs) + _to_list(labels)))

    def _update_metrics(self, outputs, labels) -> list:
        out = []
        for metric in self._metrics:
            res = metric.compute(*(_to_list(outputs) + labels))
            metric.update(*_to_list(res))
            out.append(metric.accumulate())
        return out

    def train_batch(self, inputs, labels=None, update=True):
        """One optimizer step; Paddle's model.py:1231.  Returns the loss as
        a float (with the metrics' values where there are metrics)."""
        self.network.train()
        inputs = _to_list(inputs)
        labels = _to_list(labels)
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels)
        loss.backward()
        if update and self._optimizer is not None:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        loss_val = _item(loss)
        return (loss_val, metrics) if metrics else loss_val

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """Paddle's model.py:1291."""
        self.network.eval()
        inputs = _to_list(inputs)
        labels = _to_list(labels)
        outputs = self.network(*inputs)
        loss = self._compute_loss(outputs, labels) if self._loss else None
        metrics = self._update_metrics(outputs, labels)
        if loss is None:
            return metrics
        return (_item(loss), metrics) if metrics else _item(loss)

    @torch.no_grad()
    def predict_batch(self, inputs):
        """Paddle's model.py:1347: the outputs as numpy arrays."""
        self.network.eval()
        outputs = self.network(*_to_list(inputs))
        return [_numpy(o) if isinstance(o, torch.Tensor) else o
                for o in _to_list(outputs)]

    # --------------------------------------------------------- fit / eval
    def _make_loader(self, data, batch_size, shuffle, num_workers,
                     drop_last=False, pad_last_batch=False):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset) or hasattr(data, "__getitem__"):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last,
                              pad_last_batch=pad_last_batch)
        return data  # already an iterable of batches

    @staticmethod
    def _split_batch(batch, n_labels):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        if n_labels:
            return batch[:-n_labels], batch[-n_labels:]
        # convention: last element is the label when a loss is set
        if len(batch) > 1:
            return batch[:-1], batch[-1:]
        return batch, []

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, pad_last_batch=False):
        """Paddle's model.py:1756.  ``pad_last_batch=True`` pads a ragged
        final batch to the steady-state shape (repeats of the final
        sample, which DO train: fit's loss has no mask slot); use
        ``drop_last=True`` where that bias matters, or a loop of your own
        with a masked loss fed from ``loader.last_batch_mask()``."""
        if train_data is None:
            raise ValueError("train_data must be given")
        self._save_dir = save_dir
        loader = self._make_loader(train_data, batch_size, shuffle,
                                   num_workers, drop_last=drop_last,
                                   pad_last_batch=pad_last_batch)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers)
        if epochs > 1:
            # bare generators exhaust after one pass; materialise so every
            # epoch (and every eval round) sees the data
            if iter(loader) is loader:
                loader = list(loader)
            if eval_loader is not None and iter(eval_loader) is eval_loader:
                eval_loader = list(eval_loader)
        steps = _len_or_none(loader)
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            batch_size=batch_size, log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir,
            metrics=["loss"] + [m.name() for m in self._metrics])
        self.stop_training = False
        cbks.on_train_begin()
        n_labels = len(self._labels)
        it = 0
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            update = True
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                inputs, labels = self._split_batch(batch, n_labels)
                update = (step + 1) % accumulate_grad_batches == 0
                out = self.train_batch(inputs, labels, update=update)
                logs = self._pack_logs(out)
                cbks.on_train_batch_end(step, logs)
                it += 1
                if self.stop_training or (num_iters is not None and
                                          it >= num_iters):
                    break
            if not update and self._optimizer is not None:
                # flush a partial accumulation window so tail gradients are
                # applied rather than leaking into the next epoch
                self._optimizer.step()
                self._optimizer.clear_grad()
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self._run_eval(eval_loader, cbks)
            if self.stop_training or (num_iters is not None and
                                      it >= num_iters):
                break
        cbks.on_train_end(logs)

    def _pack_logs(self, out):
        logs = {}
        if isinstance(out, tuple):
            loss, metrics = out
            logs["loss"] = loss
            for m, v in zip(self._metrics, metrics):
                logs[m.name()] = v
        else:
            logs["loss"] = out
        return logs

    def _run_eval(self, loader, cbks):
        n_labels = len(self._labels)
        cbks.on_eval_begin({"steps": _len_or_none(loader)})
        for m in self._metrics:
            m.reset()
        logs = {}
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            inputs, labels = self._split_batch(batch, n_labels)
            out = self.eval_batch(inputs, labels)
            logs = self._pack_logs(out) \
                if isinstance(out, tuple) or not isinstance(out, list) \
                else {m.name(): v for m, v in zip(self._metrics, out)}
            if "loss" in logs:
                losses.append(logs["loss"])
            cbks.on_eval_batch_end(step, logs)
        if losses:
            # the mean over the eval set, not the last batch's loss —
            # EarlyStopping/ReduceLROnPlateau monitor this value
            logs["loss"] = float(np.mean(losses))
        cbks.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        """Paddle's model.py:2005."""
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        cbks = config_callbacks(
            callbacks, model=self, verbose=verbose, log_freq=log_freq,
            metrics=["loss"] + [m.name() for m in self._metrics])
        return self._run_eval(loader, cbks)

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """Paddle's model.py:2116: ``[n_outputs][steps]`` numpy arrays
        (each output's batches concatenated with ``stack_outputs``)."""
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose)
        cbks.on_predict_begin()
        outputs = []
        for step, batch in enumerate(loader):
            cbks.on_predict_batch_begin(step)
            batch = list(batch) if isinstance(batch, (list, tuple)) \
                else [batch]
            # input/label split precedence: declared input specs, declared
            # label specs, then the (x, y) heuristic for loss-prepared models
            if self._inputs:
                inputs = batch[: len(self._inputs)]
            elif self._labels:
                inputs, _ = self._split_batch(batch, len(self._labels))
            elif self._loss is not None and len(batch) > 1:
                inputs = batch[:-1]
            else:
                inputs = batch
            outputs.append(self.predict_batch(inputs))
            cbks.on_predict_batch_end(step)
        cbks.on_predict_end()
        # transpose [steps][n_out] -> [n_out][steps]
        res = [list(col) for col in zip(*outputs)] if outputs else []
        if stack_outputs:
            res = [np.concatenate(col, axis=0) for col in res]
        return res

    # --------------------------------------------------------- persistence
    def save(self, path: str, training: bool = True) -> None:
        """Paddle's model.py:1432: ``path.pdparams`` (and ``path.pdopt``
        with an optimizer) in the reference's format."""
        if not training:
            raise NotImplementedError(
                "Model.save(training=False) writes an inference program "
                "through jit.save, which the port does not have yet "
                "(ROADMAP A9)")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _io.save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            _io.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer: bool = False):
        """Paddle's model.py:1508: read ``path.pdparams`` (and
        ``path.pdopt`` unless ``reset_optimizer``) into the network and
        the optimizer, written by either package."""
        params = _io.load(path + ".pdparams", device="cpu")
        if skip_mismatch:
            current = self.network.state_dict()
            params = {k: v for k, v in params.items()
                      if k in current and tuple(v.shape) ==
                      tuple(current[k].shape)}
        self.network.set_state_dict(params)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(_io.load(opt_path, device="cpu"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        """Paddle's model.py:2308."""
        from .model_summary import summary
        input_size = input_size or \
            [tuple(s.shape) for s in self._inputs] or None
        return summary(self.network, input_size, dtypes=dtype)
