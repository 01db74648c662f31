"""paddle_tpu_torch.optimizer (counterpart of ``paddle_tpu/optimizer``):
SGD, Adam and AdamW, updating in place, and the LR schedulers."""

from . import lr  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Optimizer  # noqa: F401

__all__ = ["lr", "Optimizer", "SGD", "Adam", "AdamW"]
