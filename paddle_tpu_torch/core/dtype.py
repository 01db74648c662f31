"""Dtype names → torch dtypes (counterpart of
``paddle_tpu/core/dtype.py``)."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["to_torch_dtype"]

_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def to_torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _NAMES:
        raise ValueError(f"unsupported dtype {dtype!r}; expected one of "
                         f"{sorted(_NAMES)}")
    return _NAMES[dtype]
