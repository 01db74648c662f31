"""``save`` and ``load`` (counterpart of
``paddle_tpu/framework/io_utils.py``), in the reference's on-disk format.

A checkpoint is a protocol-4 pickle of the saved object (nested dicts,
lists and tuples) whose tensor leaves are ``_TensorPayload``s holding a
numpy array, ``is_parameter``, ``name`` and ``stop_gradient``; a
bfloat16 array is stored as the pair ``(uint16 array, "bfloat16")``.
``_QuantPayload`` leaves (int8/int4 codes and scales) are dequantized at
load.  pickle names a class by its module path, and the reference's
payload classes live at ``paddle_tpu.framework.io_utils``: the port reads
those names into its own classes (``RefUnpickler.find_class``) and writes
them under the reference's names (``RefPickler.save_global``), so each
package reads the other's files, and neither imports the other.  bf16
goes through ``uint16`` and ``Tensor.view(torch.bfloat16)``, never numpy's
bf16 (``ml_dtypes`` is not needed).
"""

from __future__ import annotations

import copyreg
import os
import pickle
from typing import Any

import numpy as np
import torch
from torch import nn

from ..core.dtype import to_torch_dtype

__all__ = ["save", "load"]

_PROTOCOL = 4
_REF_MODULE = "paddle_tpu.framework.io_utils"


class _TensorPayload:
    """A tensor leaf on disk.  ``save`` makes it around the tensor itself
    and pickling copies that to the host as numpy, so a save holds one
    tensor's host copy at a time."""

    __slots__ = ("array", "is_parameter", "name", "stop_gradient")

    def __init__(self, array, is_parameter, name, stop_gradient) -> None:
        self.array = array
        self.is_parameter = is_parameter
        self.name = name
        self.stop_gradient = stop_gradient

    def __reduce_ex__(self, protocol):
        arr = self.array
        if isinstance(arr, torch.Tensor):
            arr = _to_numpy(arr)
        return (copyreg.__newobj__, (_TensorPayload,),
                (None, {"array": arr, "is_parameter": self.is_parameter,
                        "name": self.name,
                        "stop_gradient": self.stop_gradient}))


class _QuantPayload:
    """A weight-only quantized leaf on disk (the reference's
    ``inference.convert_to_int8``): codes ``q``, scales, the scaled axis,
    the dtype to restore; dequantized at load."""

    __slots__ = ("q", "scale", "axis", "dtype", "is_parameter", "name",
                 "stop_gradient", "bound")

    def dequantized(self) -> torch.Tensor:
        q = torch.from_numpy(np.asarray(self.q)).to(torch.float32)
        shape = [1] * q.dim()
        shape[self.axis % q.dim()] = -1
        s = torch.from_numpy(np.asarray(self.scale, np.float32))
        w = q * (s.reshape(shape) / float(self.bound))
        return w.to(to_torch_dtype(str(self.dtype)))


_CLASSES = {"_TensorPayload": _TensorPayload, "_QuantPayload": _QuantPayload}


def _to_numpy(t: torch.Tensor):
    """numpy array of ``t`` (bf16 as the ``(uint16, "bfloat16")`` pair)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return (t.view(torch.int16).cpu().numpy().view(np.uint16),
                "bfloat16")
    return t.cpu().numpy()


def _from_numpy(arr) -> torch.Tensor:
    if isinstance(arr, tuple) and len(arr) == 2 and arr[1] == "bfloat16":
        bits = np.require(arr[0], np.uint16, ["C", "W"]).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.require(arr, None, ["C", "W"]))


def _pack(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj, isinstance(obj, nn.Parameter),
                              getattr(obj, "name", None) or "",
                              not obj.requires_grad)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _leaf(t: torch.Tensor, payload, device, return_numpy: bool):
    if return_numpy:
        return _to_numpy(t)
    t = t.to(device)
    grad = not payload.stop_gradient and t.is_floating_point()
    if payload.is_parameter:
        from ..nn.layer.layers import ParamBase
        p = ParamBase(t, requires_grad=grad)
        p.name = payload.name
        return p
    return t.requires_grad_(grad)


def _unpack(obj: Any, device, return_numpy: bool) -> Any:
    if isinstance(obj, _QuantPayload):
        return _leaf(obj.dequantized(), obj, device, return_numpy)
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return obj.array
        return _leaf(_from_numpy(obj.array), obj, device, False)
    if isinstance(obj, dict):
        return {k: _unpack(v, device, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, device, return_numpy) for v in obj)
    return obj


class RefPickler(pickle._Pickler):
    """The pure-Python pickler (its ``save_global`` can be overridden),
    writing each class of ``classes`` ({name: class}) under the
    reference's module path ``module``."""

    def __init__(self, file, protocol: int, module: str, classes) -> None:
        super().__init__(file, protocol=protocol)
        self._module, self._classes = module, classes

    def save_global(self, obj, name=None):
        ref = next((n for n, c in self._classes.items() if obj is c), None)
        if ref is None:
            return super().save_global(obj, name)
        self.save(self._module)
        self.save(ref)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class RefUnpickler(pickle.Unpickler):
    """Reads the names of ``classes`` under ``modules`` (the reference's
    module path and the port's) into the port's classes."""

    def __init__(self, file, modules, classes) -> None:
        super().__init__(file)
        self._modules, self._classes = modules, classes

    def find_class(self, module, name):
        if module in self._modules and name in self._classes:
            return self._classes[name]
        return super().find_class(module, name)


def save(obj: Any, path: str, protocol: int = _PROTOCOL, **configs) -> None:
    """Write ``obj`` (a state dict, or any nesting of dicts, lists and
    tuples with tensor leaves) to ``path`` in the reference's format."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        RefPickler(f, protocol, _REF_MODULE, _CLASSES).dump(_pack(obj))


def load(path: str, **configs) -> Any:
    """Read a checkpoint written by either package.  Tensor leaves come
    back as tensors on ``configs["device"]`` (default: the current
    device, the card unless ``set_device`` says otherwise),
    ``nn.Parameter`` where the file says so.  ``return_numpy=True`` gives
    numpy arrays instead; a bf16 leaf then comes back as the ``(uint16
    array, "bfloat16")`` pair, since numpy holds no bf16 without
    ``ml_dtypes`` (``Layer.set_state_dict`` takes the pair)."""
    return_numpy = bool(configs.get("return_numpy", False))
    device = None
    if not return_numpy:
        from ..core.place import resolve_device
        device = resolve_device(configs.get("device"))
    with open(path, "rb") as f:
        obj = RefUnpickler(f, (_REF_MODULE, __name__), _CLASSES).load()
    return _unpack(obj, device, return_numpy)
