"""paddle_tpu_torch.jit (counterpart of ``paddle_tpu/jit``): the captured
train step and the recapture bookkeeping."""

from . import compile_cache  # noqa: F401
from .api import CapturedGraph, TrainStepCapture  # noqa: F401
from .compile_cache import warmup  # noqa: F401

__all__ = ["TrainStepCapture", "CapturedGraph", "compile_cache", "warmup"]
