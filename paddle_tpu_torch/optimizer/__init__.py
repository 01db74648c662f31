"""paddle_tpu_torch.optimizer (counterpart of ``paddle_tpu/optimizer``):
the reference's optimizers, updating in place through one hand-written
multi-tensor kernel on the card, LBFGS, and the LR schedulers."""

from . import lr  # noqa: F401
from .optimizer import (Adadelta, Adagrad, Adam, Adamax, AdamW, ASGD, Lamb,  # noqa: F401
                        Momentum, NAdam, Optimizer, RAdam, RMSProp, Rprop, SGD)
from .lbfgs import LBFGS  # noqa: F401

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adamax", "RMSProp", "Lamb", "Adadelta", "Rprop", "NAdam",
           "RAdam", "ASGD", "LBFGS"]
