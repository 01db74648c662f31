"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The package mirrors ``paddle_tpu``'s module paths, so every file here has
exactly one counterpart there; ``paddle_tpu`` stays the reference the tests
hold this package to.  It covers Llama serving and Llama training (eager or captured):

  flags.py           — the serving flags (same names and defaults)
  core/place.py      — device resolution (CUDA unless the caller asks for
                       the CPU)
  nn/                — silu, rms_norm, linear, embedding, attention
                       (flash_sdpa over the flash kernels; plain sdpa for
                       masks and dropout), cross_entropy; Linear,
                       Embedding, RMSNorm with Paddle's (in, out) weight
                       layout; gradient clips
  models/llama.py    — Llama with the paged-KV serving forward and the
                       full-sequence training forward, compute_loss
  optimizer/         — SGD, Adam, AdamW (in-place updates), LR schedulers
  jit/               — TrainStepCapture (one CUDA graph a batch signature)
                       and the recapture counters
  regularizer.py     — L1Decay, L2Decay
  ops/cuda/          — hand-written Hopper kernels (ctypes-bound, built with
                       nvcc at first use) and their plain PyTorch versions
  serving/           — paged KV allocator + prefix cache, continuous-batching
                       scheduler, ServingEngine (its two step signatures
                       captured as CUDA graphs on the card)

Importing the package needs neither a GPU nor nvcc: kernels are compiled and
loaded at their first CUDA launch.
"""

from __future__ import annotations

__version__ = "0.1.0"

from . import flags  # noqa: F401
from .core.place import resolve_device  # noqa: F401
