"""Shared helpers of the op-surface modules (counterpart of
``paddle_tpu/tensor/_helpers.py``)."""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.dtype import get_default_dtype, to_torch_dtype
from ..core.place import resolve_device

__all__ = ["as_tensor", "to_static_int_list", "tdtype", "encode_index",
           "decode_index", "long_index", "axis_tuple"]


def tdtype(dt) -> Optional[torch.dtype]:
    """A dtype attribute (None, a name, a numpy or a torch dtype) as a
    torch dtype; None stays None."""
    return None if dt is None else to_torch_dtype(dt)


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: tensors pass through (cast to ``dtype`` if
    given); Python and numpy values go to ``device`` (the current device
    by default), Python floats in the default floating dtype."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(tdtype(dtype))
    dev = resolve_device(device)
    if dtype is None and isinstance(x, float):
        dtype = get_default_dtype()
    if isinstance(x, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.to(device=dev, dtype=tdtype(dtype))
    return torch.as_tensor(x, dtype=tdtype(dtype), device=dev)


def long_index(index) -> torch.Tensor:
    """An index tensor as int64 (torch's index ops take no int32)."""
    return index.long() if index.dtype != torch.int64 else index


def axis_tuple(axis):
    """A reduction axis as a hashable attribute: None, an int or a tuple."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        v = axis.reshape(-1).tolist()
        return tuple(int(a) for a in v) if len(v) > 1 else int(v[0])
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def to_static_int_list(x) -> Optional[Tuple[int, ...]]:
    """Shapes/axes given as a tensor, a list or a numpy array → a tuple of
    Python ints."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return tuple(int(v) for v in x.reshape(-1).tolist())
    if isinstance(x, (int, np.integer)):
        return (int(x),)
    return tuple(int(v.item()) if isinstance(v, torch.Tensor) else int(v)
                 for v in x)


def encode_index(idx) -> Tuple[Tuple, List]:
    """A ``__getitem__`` index as (hashable static form, dynamic tensors):
    tensors and arrays inside the index become dynamic inputs referenced by
    position; ints, slices, None, Ellipsis and bools are static."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    static: List[Any] = []
    dynamic: List[Any] = []
    for item in idx:
        if isinstance(item, torch.Tensor):
            static.append(("dyn", len(dynamic)))
            dynamic.append(item)
        elif isinstance(item, np.ndarray):
            static.append(("dyn", len(dynamic)))
            dynamic.append(torch.from_numpy(item))
        elif isinstance(item, slice):
            static.append(("slice", item.start, item.stop, item.step))
        elif item is None:
            static.append(("none",))
        elif item is Ellipsis:
            static.append(("ellipsis",))
        elif isinstance(item, bool):
            static.append(("bool", item))
        elif isinstance(item, (int, np.integer)):
            static.append(("int", int(item)))
        elif isinstance(item, (list, tuple)):
            a = np.asarray(item)
            if a.dtype == object:
                raise TypeError(f"unsupported index element {item!r}")
            static.append(("dyn", len(dynamic)))
            dynamic.append(torch.from_numpy(a))
        else:
            raise TypeError(f"unsupported index element {item!r}")
    return tuple(static), dynamic


def decode_index(static, dynamic, device=None):
    out = []
    for item in static:
        tag = item[0]
        if tag == "dyn":
            d = dynamic[item[1]]
            if d.dtype != torch.bool:
                d = long_index(d)
            out.append(d if device is None else d.to(device))
        elif tag == "slice":
            out.append(slice(item[1], item[2], item[3]))
        elif tag == "none":
            out.append(None)
        elif tag == "ellipsis":
            out.append(Ellipsis)
        elif tag in ("bool", "int"):
            out.append(item[1])
    return tuple(out)
