"""High-level training callbacks (counterpart of
``paddle_tpu/hapi/callbacks.py``; Paddle's python/paddle/hapi/callbacks.py:
Callback:116, CallbackList:24, ProgBarLogger:280, ModelCheckpoint:576,
LRScheduler:651, EarlyStopping:743, ReduceLROnPlateau:957, VisualDL:881).

Callbacks observe the host-side training loop only; the logs they see
hold Python floats (``Model.train_batch`` reads the loss back once a
step).  The reference's ``TelemetryCallback`` (step-time, throughput and
memory telemetry, installed while ``FLAGS_telemetry`` is armed) is ROADMAP
item A5.
"""

from __future__ import annotations

import json
import numbers
import os
import time
from typing import Dict, List, Optional

__all__ = ["Callback", "CallbackList", "config_callbacks", "ProgBarLogger",
           "ModelCheckpoint", "LRScheduler", "EarlyStopping", "VisualDL",
           "ReduceLROnPlateau"]


class Callback:
    """Base class; Paddle's python/paddle/hapi/callbacks.py:116."""

    def __init__(self) -> None:
        self.model = None
        self.params: Dict = {}

    def set_params(self, params: Dict) -> None:
        self.params = params or {}

    def set_model(self, model) -> None:
        self.model = model

    # training
    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    # evaluation
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    # prediction
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    """Dispatch fan-out; Paddle's callbacks.py:24."""

    def __init__(self, callbacks: Optional[List[Callback]] = None) -> None:
        self.callbacks = list(callbacks or [])

    def append(self, callback: Callback) -> None:
        self.callbacks.append(callback)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params: Dict) -> None:
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model) -> None:
        for c in self.callbacks:
            c.set_model(model)

    def _call(self, name: str, *args) -> None:
        for c in self.callbacks:
            getattr(c, name)(*args)

    def __getattr__(self, name: str):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train") -> CallbackList:
    """Paddle's callbacks.py:58 config_callbacks: the user's callbacks,
    a ProgBarLogger first where ``verbose``, an LRScheduler and (with a
    ``save_dir``) a ModelCheckpoint last, unless given."""
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir is not None and not any(
            isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or [],
    })
    return lst


class ProgBarLogger(Callback):
    """Console progress logging; Paddle's callbacks.py:280."""

    def __init__(self, log_freq: int = 1, verbose: int = 2) -> None:
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self.epochs = None
        self.steps = None

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.steps = self.params.get("steps")
        self._epoch = epoch
        self._step = 0
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def _fmt(self, logs: Dict) -> str:
        parts = []
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                parts.append(f"{k}: {v:.4f}")
            elif isinstance(v, (list, tuple)) and v and \
                    isinstance(v[0], numbers.Number):
                parts.append(f"{k}: " + ",".join(f"{x:.4f}" for x in v))
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        self._step = step + 1
        if self.verbose == 1 or (self.verbose and
                                 self._step % self.log_freq == 0):
            total = f"/{self.steps}" if self.steps else ""
            print(f"step {self._step}{total} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1} done - {self._fmt(logs)}")

    def on_eval_begin(self, logs=None):
        if self.verbose:
            n = (logs or {}).get("steps")
            print(f"Eval begin... ({n} steps)" if n else "Eval begin...")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval done - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """Periodic ``model.save``; Paddle's callbacks.py:576."""

    def __init__(self, save_freq: int = 1,
                 save_dir: Optional[str] = None) -> None:
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and self.save_dir and \
                (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            print(f"save checkpoint at {os.path.abspath(path)}")
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None and self.save_dir:
            path = os.path.join(self.save_dir, "final")
            print(f"save checkpoint at {os.path.abspath(path)}")
            self.model.save(path)


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler; Paddle's callbacks.py:651."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False) -> None:
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None) if self.model else None
        from ..optimizer.lr import LRScheduler as _Sched
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, _Sched) else None

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch and self._sched() is not None:
            self._sched().step()

    def on_train_batch_end(self, step, logs=None):
        if self.by_step and self._sched() is not None:
            self._sched().step()


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving; Paddle's
    callbacks.py:743."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True) -> None:
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.baseline = baseline
        self.min_delta = abs(min_delta)
        self.wait_epoch = 0
        self.best_weights = None
        self.stopped_epoch = 0
        self.save_best_model = save_best_model
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        self.greater = not (mode == "min" or
                            (mode == "auto" and "acc" not in self.monitor))
        self.best_value = None

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        self.best_value = self.baseline if self.baseline is not None else (
            float("-inf") if self.greater else float("inf"))

    def on_eval_end(self, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        if isinstance(value, (list, tuple)):
            value = value[0]
        improved = (value - self.min_delta > self.best_value) \
            if self.greater else (value + self.min_delta < self.best_value)
        if improved:
            self.best_value = value
            self.wait_epoch = 0
            if self.save_best_model and self.model is not None and \
                    getattr(self.model, "_save_dir", None):
                self.model.save(os.path.join(self.model._save_dir,
                                             "best_model"))
        else:
            self.wait_epoch += 1
        if self.wait_epoch > self.patience and self.model is not None:
            self.model.stop_training = True
            if self.verbose:
                print(f"Epoch early stopped: best {self.monitor} = "
                      f"{self.best_value}")


class VisualDL(Callback):
    """Scalar-log callback; Paddle's logs to VisualDL (callbacks.py:881) —
    here, as in the reference, a plain JSONL, ``<log_dir>/scalars.jsonl``:
    one record a train step (``tag`` "train") and an evaluation
    ("eval"), with the step and each numeric log."""

    def __init__(self, log_dir: str) -> None:
        super().__init__()
        self.log_dir = log_dir
        self._step = 0
        self._path = None

    def _write(self, tag: str, logs: Dict) -> None:
        if self._path is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._path = os.path.join(self.log_dir, "scalars.jsonl")
        rec = {"tag": tag, "step": self._step}
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                rec[k] = float(v)
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)


class ReduceLROnPlateau(Callback):
    """Reduce the optimizer's learning rate when a metric plateaus;
    Paddle's callbacks.py:957."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0) -> None:
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.greater = mode == "max" or (mode == "auto" and "acc" in monitor)
        self.wait = 0
        self.cooldown_counter = 0
        self.best = None

    def on_train_begin(self, logs=None):
        self.best = float("-inf") if self.greater else float("inf")

    def on_eval_end(self, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        if isinstance(value, (list, tuple)):
            value = value[0]
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        improved = value > self.best + self.min_delta if self.greater \
            else value < self.best - self.min_delta
        if improved:
            self.best = value
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None:
                    new_lr = max(float(opt.get_lr()) * self.factor,
                                 self.min_lr)
                    opt.set_lr(new_lr)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr -> {new_lr}")
                self.cooldown_counter = self.cooldown
                self.wait = 0
