"""The reference Tensor's methods as free functions over ``torch.Tensor``
(counterpart of ``paddle_tpu/core/tensor.py``).

Tensors stay plain ``torch.Tensor`` (nothing is patched onto the class),
so the reference's ``x.stop_gradient``, ``x.numpy()``, ``x.place`` ...
are ``stop_gradient(x)``, ``numpy(x)``, ``place(x)`` here; torch's own
methods serve where they mean the same (``x.dim()``, ``x.numel()``,
``x.detach()``).  ``stop_gradient`` is the inverse of ``requires_grad``.
``to_tensor`` and ``clone`` live in ``tensor/creation.py``.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from .dtype import to_torch_dtype

__all__ = [
    "shape", "ndim", "ndimension", "size", "dtype", "place", "is_leaf", "T",
    "numel", "element_size", "dim", "strides", "is_contiguous",
    "contiguous", "numpy", "item", "tolist", "grad", "set_grad",
    "register_hook", "backward", "clear_grad", "clear_gradient",
    "retain_grads", "detach", "detach_", "stop_gradient",
    "set_stop_gradient", "requires_grad", "set_requires_grad", "set_value",
    "copy_", "to", "cpu", "cuda", "pin_memory", "astype",
]


# -- metadata ---------------------------------------------------------------
def shape(x: torch.Tensor) -> List[int]:
    return list(x.shape)


def ndim(x: torch.Tensor) -> int:
    return x.dim()


ndimension = ndim


def size(x: torch.Tensor) -> int:
    """The number of elements (the reference's ``size`` property)."""
    return x.numel()


def dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype


def place(x: torch.Tensor) -> torch.device:
    return x.device


def is_leaf(x: torch.Tensor) -> bool:
    return x.grad_fn is None


def T(x: torch.Tensor) -> torch.Tensor:
    """All axes reversed."""
    return x.permute(*range(x.dim() - 1, -1, -1))


def numel(x: torch.Tensor) -> int:
    return x.numel()


def element_size(x: torch.Tensor) -> int:
    return x.element_size()


def dim(x: torch.Tensor) -> int:
    return x.dim()


def strides(x: torch.Tensor) -> List[int]:
    """Strides in elements."""
    return list(x.stride())


def is_contiguous(x: torch.Tensor) -> bool:
    return x.is_contiguous()


def contiguous(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous()


# -- values -------------------------------------------------------------------
def numpy(x: torch.Tensor) -> np.ndarray:
    """A host copy (bfloat16 widens to float32: numpy has no bfloat16)."""
    t = x.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def item(x: torch.Tensor, *args) -> Any:
    return numpy(x).item(*args)


def tolist(x: torch.Tensor):
    return numpy(x).tolist()


# -- autograd ---------------------------------------------------------------
def grad(x: torch.Tensor) -> Optional[torch.Tensor]:
    return x.grad


def set_grad(x: torch.Tensor, value) -> None:
    x.grad = None if value is None else torch.as_tensor(
        value, dtype=x.dtype, device=x.device)


def register_hook(x: torch.Tensor, hook):
    """``hook(grad) -> grad or None`` during backward; returns a handle
    with ``remove()``."""
    return x.register_hook(hook)


def backward(x: torch.Tensor, grad_tensor=None,
             retain_graph: bool = False) -> None:
    from ..autograd.engine import backward as _backward
    _backward([x], [grad_tensor], retain_graph=retain_graph)


def clear_grad(x: torch.Tensor) -> None:
    x.grad = None


clear_gradient = clear_grad


def retain_grads(x: torch.Tensor) -> None:
    if x.grad_fn is not None:
        x.retain_grad()


def detach(x: torch.Tensor) -> torch.Tensor:
    return x.detach()


def detach_(x: torch.Tensor) -> torch.Tensor:
    return x.detach_()


def stop_gradient(x: torch.Tensor) -> bool:
    return not x.requires_grad


def set_stop_gradient(x: torch.Tensor, value: bool) -> None:
    x.requires_grad_(not value)


def requires_grad(x: torch.Tensor) -> bool:
    return x.requires_grad


def set_requires_grad(x: torch.Tensor, value: bool) -> None:
    x.requires_grad_(bool(value))


# -- mutation -------------------------------------------------------------
@torch.no_grad()
def set_value(x: torch.Tensor, value) -> None:
    """x takes ``value`` (broadcast to x's shape, cast to its dtype)."""
    x.copy_(torch.as_tensor(np.asarray(value)).to(x.dtype)
            .broadcast_to(x.shape))


@torch.no_grad()
def copy_(x: torch.Tensor, other, blocking: bool = True) -> torch.Tensor:
    src = other if isinstance(other, torch.Tensor) else \
        torch.as_tensor(np.asarray(other))
    return x.copy_(src.to(x.dtype), non_blocking=not blocking)


# -- devices and dtypes -----------------------------------------------------
def _device(d) -> torch.device:
    name = str(d)
    if name.startswith("gpu"):
        name = "cuda" + name[3:]
    return torch.device(name)


def _is_device(a) -> bool:
    return isinstance(a, torch.device) or (
        isinstance(a, str) and a.split(":")[0] in ("cpu", "gpu", "cuda"))


def to(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """``to(x, "gpu:0")``, ``to(x, "float16")``, ``to(x, device=...,
    dtype=...)``."""
    device = kwargs.pop("device", None)
    dt = kwargs.pop("dtype", None)
    for a in args:
        if _is_device(a):
            device = a
        else:
            dt = a
    out = x
    if dt is not None:
        out = out.to(to_torch_dtype(dt))
    if device is not None:
        out = out.to(_device(device))
    return out


def cpu(x: torch.Tensor) -> torch.Tensor:
    return x.cpu()


def cuda(x: torch.Tensor) -> torch.Tensor:
    return x.cuda()


def pin_memory(x: torch.Tensor) -> torch.Tensor:
    return x


def astype(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(to_torch_dtype(dtype))
