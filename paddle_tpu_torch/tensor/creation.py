"""Creation ops (counterpart of ``paddle_tpu/tensor/creation.py``,
Paddle's ``python/paddle/tensor/creation.py``).

Functions that make a tensor from nothing (``to_tensor``, ``zeros``,
``arange``, ...) put it on the current device (``set_device``; the card by
default, raising where there is none) unless given ``device=``/``place=``;
``*_like`` functions follow their input's device."""

from __future__ import annotations

import numpy as np
import torch

from ..core import random_state
from ..core.dtype import get_default_dtype, to_torch_dtype
from ..core.place import resolve_device
from ..ops.op import apply, register_many, register_op
from ._helpers import as_tensor, tdtype, to_static_int_list

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "empty", "empty_like", "arange", "linspace", "logspace",
    "eye", "meshgrid", "diag", "diagflat", "tril", "triu", "assign",
    "clone", "tril_indices", "triu_indices", "diag_embed", "complex",
    "polar", "cauchy_", "geometric_",
]

register_op("assign", torch.clone, "unary")
register_many("gather_like", {
    "tril_op": lambda x, diagonal: torch.tril(x, diagonal),
    "triu_op": lambda x, diagonal: torch.triu(x, diagonal),
    "diag_op": lambda x, offset: torch.diag(x, offset),
    "diag_embed_op": lambda x, offset, dim1, dim2: torch.diag_embed(
        x, offset, dim1, dim2),
})
register_op("complex_op", torch.complex, "binary_broadcast")


def _shape(shape) -> tuple:
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(to_static_int_list(shape) or ())


def to_tensor(data, dtype=None, place=None, stop_gradient=True,
              device=None):
    """A tensor of ``data`` (a tensor is copied) on ``place``/``device``
    (the current device by default); ``stop_gradient=False`` makes it
    require grad."""
    dev = device if device is not None else place
    if isinstance(data, torch.Tensor):
        out = data.detach().clone().to(
            device=resolve_device(dev) if dev is not None else data.device,
            dtype=tdtype(dtype))
    else:
        if dtype is None and isinstance(data, (list, tuple)) and \
                np.asarray(data).dtype == np.float64:
            dtype = get_default_dtype()
        out = as_tensor(np.asarray(data) if isinstance(data, (list, tuple))
                        else data, device=dev, dtype=dtype)
        if isinstance(data, np.ndarray):
            out = out.clone()
    if not stop_gradient:
        out.requires_grad_(True)
    return out


def zeros(shape, dtype=None, name=None, device=None):
    return torch.zeros(_shape(shape), dtype=to_torch_dtype(dtype),
                       device=resolve_device(device))


def ones(shape, dtype=None, name=None, device=None):
    return torch.ones(_shape(shape), dtype=to_torch_dtype(dtype),
                      device=resolve_device(device))


def full(shape, fill_value, dtype=None, name=None, device=None):
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        if isinstance(fill_value, bool):
            dt = torch.bool
        elif isinstance(fill_value, int):
            dt = torch.int64
        else:
            dt = get_default_dtype()
    else:
        dt = to_torch_dtype(dtype)
    return torch.full(_shape(shape), fill_value, dtype=dt,
                      device=resolve_device(device))


def empty(shape, dtype=None, name=None, device=None):
    return zeros(shape, dtype=dtype, device=device)


def _like(x, dtype):
    x = as_tensor(x)
    return x, (tdtype(dtype) if dtype is not None else x.dtype)


def zeros_like(x, dtype=None, name=None):
    x, dt = _like(x, dtype)
    return torch.zeros(x.shape, dtype=dt, device=x.device)


def ones_like(x, dtype=None, name=None):
    x, dt = _like(x, dtype)
    return torch.ones(x.shape, dtype=dt, device=x.device)


def full_like(x, fill_value, dtype=None, name=None):
    x, dt = _like(x, dtype)
    return torch.full(x.shape, fill_value, dtype=dt, device=x.device)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype=dtype)


def _item(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def arange(start=0, end=None, step=1, dtype=None, name=None, device=None):
    start, end, step = _item(start), _item(end), _item(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
                 else get_default_dtype())
    return torch.arange(start, end, step, dtype=to_torch_dtype(dtype),
                        device=resolve_device(device))


def linspace(start, stop, num, dtype=None, name=None, device=None):
    return torch.linspace(_item(start), _item(stop), int(_item(num)),
                          dtype=to_torch_dtype(dtype),
                          device=resolve_device(device))


def logspace(start, stop, num, base=10.0, dtype=None, name=None,
             device=None):
    return torch.logspace(_item(start), _item(stop), int(_item(num)),
                          base=float(_item(base)),
                          dtype=to_torch_dtype(dtype),
                          device=resolve_device(device))


def eye(num_rows, num_columns=None, dtype=None, name=None, device=None):
    cols = int(num_rows) if num_columns is None else int(num_columns)
    return torch.eye(int(num_rows), cols, dtype=to_torch_dtype(dtype),
                     device=resolve_device(device))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(torch.meshgrid(*[as_tensor(a) for a in args],
                               indexing="ij"))


def diag(x, offset=0, padding_value=0, name=None):
    out = apply("diag_op", x, offset=int(offset))
    if padding_value != 0 and x.dim() == 1:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), int(offset))
        out = torch.where(mask, out, torch.full_like(out, padding_value))
    return out


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, int(offset))


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply("diag_embed_op", as_tensor(x), offset=int(offset),
                 dim1=int(dim1), dim2=int(dim2))


def tril(x, diagonal=0, name=None):
    return apply("tril_op", x, diagonal=int(diagonal))


def triu(x, diagonal=0, name=None):
    return apply("triu_op", x, diagonal=int(diagonal))


def tril_indices(row, col, offset=0, dtype="int64", device=None):
    return torch.tril_indices(row, col, offset, dtype=to_torch_dtype(dtype),
                              device=resolve_device(device))


def triu_indices(row, col=None, offset=0, dtype="int64", device=None):
    return torch.triu_indices(row, row if col is None else col, offset,
                              dtype=to_torch_dtype(dtype),
                              device=resolve_device(device))


def assign(x, output=None):
    out = apply("assign", as_tensor(x))
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x, name=None):
    return apply("assign", x)


def complex(real, imag, name=None):
    return apply("complex_op", real, imag)


def polar(abs, angle, name=None):
    return complex(abs * apply("cos", angle), abs * apply("sin", angle))


def cauchy_(x, loc=0, scale=1, name=None):
    """In place: Cauchy samples from the device's generator."""
    u = torch.rand(x.shape, generator=random_state.generator(x.device),
                   device=x.device).clamp(1e-6, 1 - 1e-6)
    with torch.no_grad():
        x.copy_(loc + scale * torch.tan(torch.pi * (u - 0.5)))
    return x


def geometric_(x, probs, name=None):
    """In place: geometric samples (trials to the first success)."""
    u = torch.rand(x.shape, generator=random_state.generator(x.device),
                   device=x.device).clamp(1e-6, 1 - 1e-6)
    with torch.no_grad():
        x.copy_(torch.ceil(torch.log(u) / np.log1p(-probs)))
    return x
