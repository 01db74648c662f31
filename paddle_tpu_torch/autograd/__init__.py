"""Autograd (counterpart of ``paddle_tpu/autograd``): ``backward``,
``grad``, ``PyLayer``, the functional transforms and
``saved_tensors_hooks``, over torch's engine."""

import torch

from ..core.grad_mode import (enable_grad, is_grad_enabled,  # noqa: F401
                              no_grad, set_grad_enabled)
from .backward_api import grad  # noqa: F401
from .engine import backward  # noqa: F401
from .functional import hessian, jacobian, jvp, vjp  # noqa: F401
from .py_layer import PyLayer, PyLayerContext  # noqa: F401

__all__ = ["saved_tensors_hooks", "backward", "grad", "PyLayer",
           "PyLayerContext", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "jacobian", "hessian", "jvp", "vjp"]


class saved_tensors_hooks(torch.autograd.graph.saved_tensors_hooks):
    """Pack/unpack hooks applied to every tensor the backward saves (e.g.
    offload to the host) while the context is active: torch's, which
    covers every op; ``current_saved_tensors_hooks()`` names the active
    one, as the reference's does."""

    _active = None

    def __init__(self, pack_hook, unpack_hook) -> None:
        super().__init__(pack_hook, unpack_hook)
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook
        self._prev = None

    def __enter__(self):
        self._prev = saved_tensors_hooks._active
        saved_tensors_hooks._active = self
        super().__enter__()
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        saved_tensors_hooks._active = self._prev
        return False


def current_saved_tensors_hooks():
    return saved_tensors_hooks._active
