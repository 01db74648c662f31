"""``Layer``, the module base class (counterpart of
``paddle_tpu/nn/layer/layers.py``).

A ``Layer`` is a ``torch.nn.Module`` with Paddle's surface on top:
``create_parameter`` (``ParamAttr``, initializers), ``add_parameter``,
``add_sublayer``, ``register_buffer(persistable=)``, ``parameters()`` as a
list, ``sublayers``, pre/post forward hooks, ``state_dict`` in the
reference's order with ``set_state_dict``/``load_dict``, and ``to`` with
Paddle's dtype and device names.  Underneath it is an ordinary module:
parameters are ``torch.nn.Parameter``, buffers, hooks, ``train``/``eval``
and autograd are torch's, so ``TrainStepCapture``, the serving engine and
``torch.profiler`` see plain torch.

Tensors stay plain ``torch.Tensor``.  The attributes Paddle puts on a
parameter (``name``, ``trainable``, ``optimize_attr``, ``regularizer``,
``need_clip``) go onto the ``nn.Parameter`` itself; ``trainable=False``
is ``requires_grad=False``, which the optimizers skip.  ``name`` is a
read-only property of torch tensors, so the parameter is a ``ParamBase``,
an ``nn.Parameter`` subclass that only makes ``name`` settable.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.hooks import RemovableHandle

from ...core.dtype import _NAMES, to_torch_dtype
from ...core.place import resolve_device

__all__ = ["Layer", "HookRemoveHelper", "ParamBase"]

# what register_forward_pre_hook/register_forward_post_hook return: an
# object whose remove() takes the hook out
HookRemoveHelper = RemovableHandle


def _device_name(device):
    if isinstance(device, str) and device.startswith("gpu"):
        return "cuda" + device[3:]
    return device


def as_source_tensor(value) -> torch.Tensor:
    """A state-dict value (a tensor, a numpy array, or the ``(uint16
    array, "bfloat16")`` pair that ``load(return_numpy=True)`` gives for
    bf16) as a tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach()
    if isinstance(value, tuple) and len(value) == 2 and \
            value[1] == "bfloat16":
        bits = np.require(value[0], np.uint16, ["C", "W"])
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":      # an ml_dtypes array
        return as_source_tensor((arr.view(np.uint16), "bfloat16"))
    return torch.from_numpy(np.require(arr, None, ["C", "W"]))


class ParamBase(nn.Parameter):
    """The parameter ``create_parameter`` makes: an ``nn.Parameter`` whose
    ``name`` (read-only and None on a torch tensor) holds Paddle's
    parameter name."""

    @property
    def name(self) -> str:
        return self.__dict__.get("_paddle_name", "")

    @name.setter
    def name(self, value) -> None:
        self.__dict__["_paddle_name"] = value or ""


class Layer(nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"
                 ) -> None:
        super().__init__()
        self._dtype = to_torch_dtype(dtype) if dtype is not None \
            else torch.float32
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- registration -------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None,
                         generator: Optional[torch.Generator] = None
                         ) -> Optional[nn.Parameter]:
        """A new parameter of ``shape``: ``attr``'s initializer, else
        ``default_initializer``, else ``Constant(0)`` for a bias and
        ``XavierUniform`` otherwise; ``attr=False`` gives None.  Drawn on
        ``device`` (None: the current device, the card unless set) from
        ``generator`` (None: that device's global generator)."""
        from ..initializer import (Constant, XavierUniform,
                                   apply_initializer, resolve_param_attr)
        if attr is False:
            return None
        attr = resolve_param_attr(attr)
        if attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = default_initializer
        else:
            init = Constant(0.0) if is_bias else XavierUniform()
        data = apply_initializer(init, shape, dtype or self._dtype,
                                 resolve_device(device), generator)
        p = ParamBase(data, requires_grad=bool(attr.trainable))
        p.name = attr.name
        p.trainable = bool(attr.trainable)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name: str, parameter: Optional[nn.Parameter]
                      ) -> Optional[nn.Parameter]:
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer: nn.Module) -> nn.Module:
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[torch.Tensor],
                        persistable: bool = True, persistent=None) -> None:
        """``persistable=False`` keeps the buffer out of ``state_dict``
        (torch's ``persistent`` is the same switch)."""
        super().register_buffer(name, tensor, persistent=persistable
                                if persistent is None else persistent)

    # -- traversal ----------------------------------------------------------
    def parameters(self, include_sublayers: bool = True) -> List[nn.Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         remove_duplicate: bool = True, *, recurse=None
                         ) -> Iterator[Tuple[str, nn.Parameter]]:
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers: bool = True) -> List[torch.Tensor]:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix: str = "", include_sublayers: bool = True,
                      remove_duplicate: bool = True, *, recurse=None
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False,
                        layers_set=None) -> Iterator[Tuple[str, nn.Module]]:
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def apply(self, fn: Callable) -> "Layer":
        """``fn`` on this layer, then on every sublayer, parents first."""
        for m in self.sublayers(include_self=True):
            fn(m)
        return self

    # -- hooks: register_forward_pre_hook(hook(layer, inputs)) is torch's --
    def register_forward_post_hook(self, hook: Callable) -> HookRemoveHelper:
        """``hook(layer, inputs, outputs)``; a non-None result replaces the
        outputs."""
        return self.register_forward_hook(hook)

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", use_hook: bool = True,
                   *, prefix=None, keep_vars=None) -> Dict[str, torch.Tensor]:
        """Every parameter (the parameters themselves), then every
        persistable buffer, in the reference's order.  Called with torch's
        ``prefix``/``keep_vars`` (by a torch module above this one) it is
        torch's ``state_dict``."""
        if prefix is not None or keep_vars is not None:
            return super().state_dict(destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=bool(keep_vars))
        dest = collections.OrderedDict() if destination is None \
            else destination
        for name, p in self.named_parameters(structured_name_prefix,
                                             include_sublayers):
            dest[name] = p
        mods = self.named_modules(prefix=structured_name_prefix) \
            if include_sublayers else [(structured_name_prefix, self)]
        for name, m in mods:
            for bname, b in m._buffers.items():
                if b is None or bname in m._non_persistent_buffers_set:
                    continue
                dest[f"{name}.{bname}" if name else bname] = b
        return dest

    def set_state_dict(self, state_dict: Dict[str, Any],
                       use_structured_name: bool = True
                       ) -> Tuple[List[str], List[str]]:
        """Copy ``state_dict``'s values (tensors or numpy arrays) into this
        layer's parameters and buffers, cast to each one's dtype and
        device; returns ``(missing, unexpected)`` keys.  A shape mismatch
        raises before anything is copied."""
        own = self.state_dict()
        unexpected = [k for k in state_dict if k not in own]
        missing = [k for k in own if k not in state_dict]
        src = {k: as_source_tensor(v) for k, v in state_dict.items()
               if k in own}
        bad = [f"{k}: {tuple(v.shape)} vs {tuple(own[k].shape)}"
               for k, v in src.items() if tuple(v.shape) != tuple(
                   own[k].shape)]
        if bad:
            raise ValueError("shape mismatch: " + "; ".join(bad))
        with torch.no_grad():
            for k, v in src.items():
                own[k].copy_(v)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- dtype and device ---------------------------------------------------
    def to(self, *args, **kwargs) -> "Layer":
        """Paddle's ``to(device=None, dtype=None, blocking=None)`` (a dtype
        by name, a device as "gpu:N"), or any of torch's forms.  Floating
        parameters and buffers are cast; others only move."""
        args = [_NAMES.get(a, _device_name(a)) if isinstance(a, str) else a
                for a in args]
        blocking = kwargs.pop("blocking", None)
        if blocking is not None:
            kwargs["non_blocking"] = not blocking
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = to_torch_dtype(kwargs["dtype"])
        if "device" in kwargs:
            kwargs["device"] = _device_name(kwargs["device"])
        out = super().to(*args, **kwargs)
        dt = kwargs.get("dtype", next(
            (a for a in args if isinstance(a, torch.dtype)), None))
        if dt is not None:
            self._dtype = dt
        return out

    def astype(self, dtype) -> "Layer":
        return self.to(dtype=dtype)

    # -- misc ---------------------------------------------------------------
    def full_name(self) -> str:
        return self._name_scope

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None
