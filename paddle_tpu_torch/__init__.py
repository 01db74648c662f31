"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The package mirrors ``paddle_tpu``'s module paths, so every file here has
exactly one counterpart there; ``paddle_tpu`` stays the reference the tests
hold this package to.  It covers Llama serving and Llama training (eager or
captured), and the op surface:

  flags.py           — the serving flags (same names and defaults)
  core/place.py      — device resolution (CUDA unless the caller asks for
                       the CPU)
  nn/                — Layer (a torch.nn.Module with Paddle's surface),
                       initializers, containers, the activation, common,
                       norm and loss functionals and layers, attention
                       (flash_sdpa over the flash kernels; plain sdpa for
                       masks and dropout), nn.utils, gradient clips;
                       Paddle's (in, out) weight layout
  distributed/fleet/ — the single-device Column/RowParallelLinear and
                       VocabParallelEmbedding the Llama builds
  framework/         — save/load in the reference's checkpoint format
                       (paddle_tpu_torch.save / load)
  models/llama.py    — Llama with the paged-KV serving forward and the
                       full-sequence training forward, compute_loss
  optimizer/         — SGD, Momentum, Adam, AdamW, Adagrad, Adamax,
                       RMSProp, Lamb, Adadelta, Rprop, NAdam, RAdam, ASGD
                       (in place, one fused kernel launch a dtype group
                       on the card, Lamb two; parameter groups,
                       state_dict, the device-side skip of loss
                       scaling), LBFGS, LR schedulers
  incubate/          — LookAhead, ModelAverage
  quantization/      — QAT and PTQ (QuantConfig, observers, fake quanters,
                       fake_quant_dequant with its straight-through grad)
  amp/               — auto_cast (O1/O2 at the reference's call sites),
                       decorate, GradScaler (no host sync a step),
                       debugging (check_numerics, operator stats)
  autograd/          — backward, grad, PyLayer, jacobian/hessian/jvp/vjp,
                       saved_tensors_hooks, over torch's engine
  utils/             — the failpoint registry and the retry policy
  core/tensor.py     — the reference Tensor's methods as free functions
  jit/               — TrainStepCapture (one CUDA graph a batch signature),
                       the recapture counters and the persistent cache of
                       kernel libraries (FLAGS_compile_cache_dir)
  io/                — Dataset, samplers, DataLoader (worker processes,
                       a pin-memory stager to the card)
  hapi/, metric/     — Model (fit/evaluate/predict, callbacks, save/load),
                       summary, flops; Accuracy, Precision, Recall, Auc
  distributed/       — rank and world size; checkpoint/: sharded
                       save_state_dict (async) and load_state_dict
  regularizer.py     — L1Decay, L2Decay
  ops/op.py,         — the op registry (the reference's tensor ops under
  ops/infermeta.py     their names) and the shape rules that name the op
  tensor/            — the op surface: creation, math, manipulation, logic,
                       search, stat, linalg, random (exported at the top
                       level, as paddle.concat, paddle.matmul, ...)
  core/              — dtypes, devices (set_device), grad mode, the random
                       generators (seed), the error classes
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
from .core.dtype import (  # noqa: F401
    bfloat16, bool_, complex64, complex128, float16, float32, float64,
    get_default_dtype, int8, int16, int32, int64, set_default_dtype, uint8)
from .core.grad_mode import (  # noqa: F401
    enable_grad, is_grad_enabled, no_grad, set_grad_enabled)
from .core.place import get_device, resolve_device, set_device  # noqa: F401
from .core.random_state import get_rng_state, seed, set_rng_state  # noqa: F401
from . import tensor  # noqa: F401  (the op surface)
from .tensor import *  # noqa: F401,F403
from .tensor.logic import is_tensor  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401,E402
from . import nn  # noqa: F401,E402
from .framework.io_utils import load, save  # noqa: F401,E402
from . import autograd, amp, utils  # noqa: F401,E402
from .autograd.backward_api import grad  # noqa: F401,E402
# the modules that register the rest of the reference's registry ops
from . import models, quantize, serving  # noqa: F401,E402
from . import distributed, hapi, io, metric  # noqa: F401,E402
from . import incubate, optimizer, quantization  # noqa: F401,E402
from .hapi import Model, flops, summary  # noqa: F401,E402

import torch as _torch  # noqa: E402

dtype = _torch.dtype
finfo = _torch.finfo
iinfo = _torch.iinfo


def is_compiled_with_cuda() -> bool:
    """The port runs on CUDA: True where torch was built with it."""
    return _torch.backends.cuda.is_built()


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_rocm() -> bool:
    return _torch.version.hip is not None


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_custom_device(name: str) -> bool:
    return False


def in_dynamic_mode() -> bool:
    """Eager is the only mode, as in the reference."""
    return True


in_dygraph_mode = in_dynamic_mode


def disable_static(place=None) -> None:
    """Eager is the default and only mode: nothing to switch."""


def enable_static() -> None:
    """Static graphs are not ported (ROADMAP A9); eager stays on."""


def version() -> str:
    return __version__


def get_cuda_rng_state():
    """Each card's generator state (``core/random_state``), in device
    order."""
    from .core import random_state
    return [random_state.get_rng_state(f"cuda:{i}")
            for i in range(_torch.cuda.device_count())]


def set_cuda_rng_state(state) -> None:
    from .core import random_state
    for i, s in enumerate(state):
        random_state.set_rng_state(s, f"cuda:{i}")


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None) -> None:
    _torch.set_printoptions(precision=precision, threshold=threshold,
                            edgeitems=edgeitems, linewidth=linewidth,
                            sci_mode=sci_mode)


def check_shape(shape) -> bool:
    """Raise ``ShapeError`` for a dim below -1."""
    from .ops.infermeta import ShapeError
    for s in (shape or []):
        if isinstance(s, int) and s < -1:
            raise ShapeError(f"invalid dim {s} in shape {shape}")
    return True
