"""Dtype names → torch dtypes (counterpart of
``paddle_tpu/core/dtype.py``), and the default floating dtype.

A dtype may be given as a torch dtype, a name ("float32", "int64",
"bool", ...), a numpy dtype or type; all map onto torch dtypes, which are
the port's dtype objects (``paddle_tpu_torch.float32`` is
``torch.float32``)."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

__all__ = ["to_torch_dtype", "get_default_dtype", "set_default_dtype",
           "bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAMES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
}
_FLOATS = (float16, bfloat16, float32, float64)
_default = float32


def to_torch_dtype(dtype: Union[str, torch.dtype, np.dtype, type, None]
                   ) -> torch.dtype:
    """The torch dtype of ``dtype``; None gives the default floating
    dtype."""
    if dtype is None:
        return _default
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype
    if not isinstance(dtype, str):
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = getattr(dtype, "name", str(dtype))
    name = {"bool_": "bool", "float": "float32", "int": "int64",
            "double": "float64", "half": "float16"}.get(name, name)
    if name not in _NAMES:
        raise ValueError(f"unsupported dtype {dtype!r}; expected one of "
                         f"{sorted(_NAMES)}")
    return _NAMES[name]


def get_default_dtype() -> torch.dtype:
    return _default


def set_default_dtype(dtype) -> None:
    """The dtype of floating tensors made from Python floats and of
    ``zeros``/``ones``/... without a dtype."""
    global _default
    dt = to_torch_dtype(dtype)
    if dt not in _FLOATS:
        raise ValueError(f"the default dtype must be floating, got {dt}")
    _default = dt
