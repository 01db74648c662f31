"""Shape and layout manipulation ops (counterpart of
``paddle_tpu/tensor/manipulation.py``, Paddle's
``python/paddle/tensor/manipulation.py``), with Paddle's semantics:
``reshape``'s 0 copies the input's dim and -1 is inferred, ``concat`` and
``stack`` take ``axis``, ``split`` takes a count or sections (one of them
may be -1), ``squeeze`` keeps axes whose size is not 1."""

from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtype import to_torch_dtype
from ..ops.infermeta import ShapeError
from ..ops.op import apply, register_many, register_op
from ._helpers import (as_tensor, decode_index, encode_index, long_index,
                       to_static_int_list)

__all__ = [
    "reshape", "reshape_", "flatten", "transpose", "moveaxis", "squeeze",
    "squeeze_", "unsqueeze", "unsqueeze_", "concat", "stack", "split",
    "vsplit", "hsplit", "dsplit", "tensor_split", "chunk", "tile", "expand",
    "expand_as", "broadcast_to", "broadcast_tensors", "flip", "roll",
    "gather", "gather_nd", "scatter", "scatter_", "scatter_nd",
    "scatter_nd_add", "index_select", "index_sample", "index_add",
    "index_put", "masked_select", "masked_fill", "masked_scatter",
    "take_along_axis", "put_along_axis", "pad", "unbind", "unstack",
    "repeat_interleave", "slice", "strided_slice", "cast", "crop",
    "as_strided", "view", "view_as", "unfold", "tensordot",
    "atleast_1d", "atleast_2d", "atleast_3d", "select_scatter",
    "diagonal", "getitem", "setitem",
]


# -- registrations ----------------------------------------------------------------

def _unsqueeze(x, axis):
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    nd = x.dim() + len(axes)
    for a in sorted(int(a) % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def _split(x, indices, axis):
    return tuple(torch.tensor_split(
        x, indices if isinstance(indices, int) else list(indices), axis))


def _gather(x, index, axis):
    """jnp.take: the index's shape replaces ``axis``."""
    idx = long_index(index)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _nd_index(index):
    idx = long_index(index)
    return tuple(idx.movedim(-1, 0))


def _put_along(x, idx, value, axis, reduce):
    idx = long_index(idx)
    value = torch.broadcast_to(value.to(x.dtype), idx.shape)
    if reduce == "assign":
        return torch.scatter(x, axis, idx, value)
    f = {"add": torch.add, "multiply": torch.mul, "mul": torch.mul}[reduce]
    cur = torch.take_along_dim(x, idx, axis)
    return torch.scatter(x, axis, idx, f(cur, value))


def _pad_index(n, lo, hi, mode, device):
    """The source positions of a dim of size ``n`` padded by (lo, hi)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i.remainder(n)
    # reflect (the edge is not repeated)
    period = 2 * (n - 1)
    i = i.remainder(period) if period else torch.zeros_like(i)
    return torch.where(i >= n, period - i, i)


def _pad(x, pad_width, mode, value):
    if mode == "constant":
        flat = [v for lo_hi in reversed(pad_width) for v in lo_hi]
        return F.pad(x, flat, value=value)
    for d, (lo, hi) in enumerate(pad_width):
        if lo or hi:
            x = torch.index_select(
                x, d, _pad_index(x.shape[d], lo, hi, mode, x.device))
    return x


def _unfold(x, axis, size, step):
    # torch puts the window's own axis last; jnp.stack puts it after axis
    return x.unfold(axis, size, step).movedim(-1, axis + 1)


def _cast(x, dtype, src_dtype):
    return x.to(to_torch_dtype(dtype))


def _getitem(x, *dyn, static):
    return x[decode_index(static, dyn, x.device)]


def _setitem(x, value, *dyn, static):
    out = x.clone()
    out[decode_index(static, dyn, x.device)] = value.to(x.dtype)
    return out


register_op("reshape_op", lambda x, shape: torch.reshape(x, shape),
            "reshape")
register_op("transpose_op", lambda x, perm: x.permute(perm), "transpose")
register_op("concat_op", lambda *xs, axis: torch.cat(xs, axis), "concat")
register_op("stack_op", lambda *xs, axis: torch.stack(xs, axis), "stack")
register_op("squeeze_op", lambda x, axis: torch.squeeze(x, axis), "squeeze")
register_op("unsqueeze_op", _unsqueeze, "unsqueeze")
register_op("cast_op", _cast, "cast")
register_op("masked_fill_op", lambda x, mask, value: torch.where(
    mask, value.to(x.dtype), x), "norm_layer")
register_op("where_op", torch.where, "ternary_broadcast")
register_many("gather_like", {
    "diagonal_op": lambda x, offset, axis1, axis2: torch.diagonal(
        x, offset, axis1, axis2),
    "split_op": _split,
    "flip_op": lambda x, axis: torch.flip(x, axis),
    "roll_op": lambda x, shifts, axis: torch.roll(x, shifts, axis),
    "moveaxis_op": lambda x, src, dst: torch.movedim(x, src, dst),
    "take_along_axis_op": lambda x, idx, axis: torch.take_along_dim(
        x, long_index(idx), axis),
    "put_along_axis_op": _put_along,
    "gather_op": _gather,
    "gather_nd_op": lambda x, index: x[_nd_index(index)],
    "index_select_op": lambda x, index, axis: torch.index_select(
        x, axis, long_index(index)),
    "index_sample_op": lambda x, index: torch.take_along_dim(
        x, long_index(index), 1),
    "scatter_op": lambda x, index, updates, overwrite: torch.index_put(
        x, (long_index(index),), updates, accumulate=not overwrite),
    "scatter_nd_add_op": lambda x, index, updates: torch.index_put(
        x, _nd_index(index), updates, accumulate=True),
    "index_add_op": lambda x, index, value, axis: torch.index_add(
        x, axis, long_index(index), value),
    "repeat_interleave_op": lambda x, repeats, axis: torch.repeat_interleave(
        x, repeats, axis),
})
register_many("opaque", {
    "tile_op": lambda x, reps: torch.tile(x, reps),
    "broadcast_to_op": lambda x, shape: torch.broadcast_to(x, shape),
    "pad_nd": _pad,
    "getitem_op": _getitem,
    "setitem_op": _setitem,
    "as_strided_op": lambda x, shape, stride, offset: torch.as_strided(
        x.contiguous(), shape, stride, offset),
    "unfold_op": _unfold,
    "tensordot_op": lambda x, y, axes: torch.tensordot(x, y, axes),
})


# -- wrappers ----------------------------------------------------------------------

def reshape(x, shape, name=None):
    if isinstance(shape, torch.Tensor):
        shape = to_static_int_list(shape)
    else:
        shape = tuple(int(s.item()) if isinstance(s, torch.Tensor)
                      else int(s) for s in shape)
    # Paddle: 0 copies the input's dim at that position
    if any(s == 0 for s in shape):
        shape = tuple(x.shape[i] if s == 0 else s
                      for i, s in enumerate(shape))
    return apply("reshape_op", x, shape=shape)


def _rebind(x, out):
    """In place: ``x`` takes ``out``'s shape and values."""
    with torch.no_grad():
        x.set_(out.detach().clone())
    return x


def reshape_(x, shape, name=None):
    return _rebind(x, reshape(x, shape))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    nd = x.dim()
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    mid = int(np.prod(x.shape[s:e + 1] or [1]))
    return reshape(x, list(x.shape[:s]) + [mid] + list(x.shape[e + 1:]))


def transpose(x, perm=None, name=None):
    if perm is None:
        perm = list(range(x.dim()))[::-1]
    return apply("transpose_op", x, perm=tuple(int(p) % x.dim()
                                               for p in perm))


def moveaxis(x, source, destination, name=None):
    src = tuple(source) if isinstance(source, (list, tuple)) else \
        (int(source),)
    dst = tuple(destination) if isinstance(destination, (list, tuple)) \
        else (int(destination),)
    return apply("moveaxis_op", x, src=src, dst=dst)


def squeeze(x, axis=None, name=None):
    def _norm(a):
        a = int(a)
        if not -x.dim() <= a < x.dim():
            raise ShapeError(f"squeeze: axis {a} out of range for "
                             f"rank-{x.dim()} input")
        return a % x.dim()

    if axis is None:
        ax = tuple(i for i, s in enumerate(x.shape) if s == 1)
    elif isinstance(axis, (list, tuple)):
        ax = tuple(a for a in map(_norm, axis) if x.shape[a] == 1)
    else:
        a = _norm(axis)
        ax = (a,) if x.shape[a] == 1 else ()
    if not ax:
        return apply("assign", x)
    return apply("squeeze_op", x, axis=ax)


def squeeze_(x, axis=None, name=None):
    return _rebind(x, squeeze(x, axis))


def unsqueeze(x, axis, name=None):
    if isinstance(axis, torch.Tensor):
        axis = to_static_int_list(axis)
    if isinstance(axis, (list, tuple)):
        out = x
        for a in axis:
            out = apply("unsqueeze_op", out, axis=int(a))
        return out
    return apply("unsqueeze_op", x, axis=int(axis))


def unsqueeze_(x, axis, name=None):
    return _rebind(x, unsqueeze(x, axis))


def _tensors(xs):
    dev = next((t.device for t in xs if isinstance(t, torch.Tensor)), None)
    return [t if isinstance(t, torch.Tensor) else as_tensor(t, device=dev)
            for t in xs]


def concat(x, axis=0, name=None):
    tensors = _tensors(x)
    if isinstance(axis, torch.Tensor):
        axis = int(axis.item())
    if len(tensors) == 1:
        return apply("assign", tensors[0])
    nd = tensors[0].dim()
    return apply("concat_op", *tensors, axis=int(axis) % nd if nd else 0)


def stack(x, axis=0, name=None):
    return apply("stack_op", *_tensors(x), axis=int(axis))


def split(x, num_or_sections, axis=0, name=None):
    axis = int(axis.item() if isinstance(axis, torch.Tensor) else axis) \
        % x.dim()
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(f"dim {dim} not divisible into "
                             f"{num_or_sections} sections")
        indices = tuple(dim // num_or_sections * i
                        for i in range(1, num_or_sections))
    else:
        sections = [int(s.item() if isinstance(s, torch.Tensor) else s)
                    for s in num_or_sections]
        if any(s < 0 for s in sections):
            rest = dim - builtins.sum(s for s in sections if s >= 0)
            sections = [rest if s < 0 else s for s in sections]
        indices = tuple(np.cumsum(sections)[:-1].tolist())
    return list(apply("split_op", x, indices=indices, axis=axis))


def tensor_split(x, num_or_indices, axis=0, name=None):
    axis = int(axis) % x.dim()
    dim = x.shape[axis]
    if isinstance(num_or_indices, int):
        base, extra = divmod(dim, num_or_indices)
        sizes = [base + (1 if i < extra else 0)
                 for i in range(num_or_indices)]
        indices = tuple(np.cumsum(sizes)[:-1].tolist())
    else:
        indices = tuple(int(i) for i in num_or_indices)
    return list(apply("split_op", x, indices=indices, axis=axis))


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1 if x.dim() > 1 else 0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def chunk(x, chunks, axis=0, name=None):
    return tensor_split(x, int(chunks), axis=axis)


def tile(x, repeat_times, name=None):
    return apply("tile_op", x, reps=to_static_int_list(repeat_times))


def expand(x, shape, name=None):
    target = list(to_static_int_list(shape))
    offset = len(target) - x.dim()
    for i, t in enumerate(target):
        if t in (-1, 0) and i >= offset:
            target[i] = x.shape[i - offset]
    return apply("broadcast_to_op", x, shape=tuple(target))


def expand_as(x, y, name=None):
    return apply("broadcast_to_op", x, shape=tuple(y.shape))


def broadcast_to(x, shape, name=None):
    return apply("broadcast_to_op", x, shape=to_static_int_list(shape))


def broadcast_tensors(inputs, name=None):
    shape = tuple(torch.broadcast_shapes(*[tuple(t.shape) for t in inputs]))
    return [apply("broadcast_to_op", t, shape=shape) for t in inputs]


def flip(x, axis, name=None):
    ax = tuple(int(a) for a in axis) if isinstance(axis, (list, tuple)) \
        else (int(axis),)
    return apply("flip_op", x, axis=ax)


def roll(x, shifts, axis=None, name=None):
    sh = tuple(shifts) if isinstance(shifts, (list, tuple)) else int(shifts)
    if axis is None:
        return reshape(apply("roll_op", reshape(x, [-1]), shifts=sh,
                             axis=None), x.shape)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else int(axis)
    return apply("roll_op", x, shifts=sh, axis=ax)


def gather(x, index, axis=0, name=None):
    if isinstance(axis, torch.Tensor):
        axis = int(axis.item())
    if isinstance(index, torch.Tensor) and index.dim() > 1:
        index = reshape(index, [-1])
    return apply("gather_op", x, index, axis=int(axis))


def gather_nd(x, index, name=None):
    return apply("gather_nd_op", x, index)


def scatter(x, index, updates, overwrite=True, name=None):
    if isinstance(index, torch.Tensor) and index.dim() == 2 and \
            index.shape[1] == 1:
        index = reshape(index, [-1])
    return apply("scatter_op", x, index, updates, overwrite=bool(overwrite))


def scatter_(x, index, updates, overwrite=True, name=None):
    out = scatter(x, index, updates, overwrite)
    with torch.no_grad():
        x.copy_(out)
    return x


def scatter_nd_add(x, index, updates, name=None):
    return apply("scatter_nd_add_op", x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    zeros = torch.zeros(to_static_int_list(shape), dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


def index_select(x, index, axis=0, name=None):
    return apply("index_select_op", x, index, axis=int(axis))


def index_sample(x, index):
    return apply("index_sample_op", x, index)


def index_add(x, index, axis, value, name=None):
    return apply("index_add_op", x, index, value, axis=int(axis))


def index_put(x, indices, value, accumulate=False, name=None):
    idx = tuple(long_index(i) if i.dtype != torch.bool else i
                for i in _tensors(indices))
    value = value if isinstance(value, torch.Tensor) else as_tensor(
        value, device=x.device, dtype=x.dtype)
    return torch.index_put(x, idx, value.to(x.dtype), accumulate=accumulate)


def masked_select(x, mask, name=None):
    """The elements where ``mask`` holds (a data-dependent shape)."""
    return torch.masked_select(x, mask)


def masked_fill(x, mask, value, name=None):
    if not isinstance(value, torch.Tensor):
        value = torch.tensor(value, dtype=x.dtype, device=x.device)
    return apply("masked_fill_op", x, mask, value)


def masked_scatter(x, mask, value, name=None):
    return torch.masked_scatter(x, mask, value.to(x.dtype))


def take_along_axis(arr, indices, axis, broadcast=True):
    return apply("take_along_axis_op", arr, indices, axis=int(axis))


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True):
    if not isinstance(values, torch.Tensor):
        values = torch.tensor(values, dtype=arr.dtype, device=arr.device)
    return apply("put_along_axis_op", arr, indices, values, axis=int(axis),
                 reduce=reduce)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    pad = to_static_int_list(pad)
    nd = x.dim()
    if len(pad) == 2 * nd:
        width = tuple((pad[2 * i], pad[2 * i + 1]) for i in range(nd))
    else:
        # Paddle: pairs (left, right, top, bottom, ...) from the last
        # spatial dim backwards
        width = [(0, 0)] * nd
        last_spatial = nd - 2 if data_format.endswith("C") else nd - 1
        for i in range(len(pad) // 2):
            width[last_spatial - i] = (pad[2 * i], pad[2 * i + 1])
        width = tuple(width)
    mode = {"constant": "constant", "reflect": "reflect",
            "replicate": "edge", "circular": "wrap"}[mode]
    return apply("pad_nd", x, pad_width=width, mode=mode, value=float(value))


def unbind(x, axis=0, name=None):
    axis = int(axis) % x.dim()
    return [squeeze(o, axis) for o in split(x, x.shape[axis], axis=axis)]


def unstack(x, axis=0, num=None):
    return unbind(x, axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    if axis is None:
        x = reshape(x, [-1])
        axis = 0
    if isinstance(repeats, torch.Tensor):
        return torch.repeat_interleave(x, long_index(repeats), int(axis))
    return apply("repeat_interleave_op", x, repeats=int(repeats),
                 axis=int(axis))


def slice(input, axes, starts, ends):
    idx = [builtins.slice(None)] * input.dim()
    for ax, s, e in zip(to_static_int_list(axes), to_static_int_list(starts),
                        to_static_int_list(ends)):
        idx[ax] = builtins.slice(s, e)
    return getitem(input, tuple(idx))


def strided_slice(x, axes, starts, ends, strides, name=None):
    idx = [builtins.slice(None)] * x.dim()
    for ax, s, e, st in zip(to_static_int_list(axes),
                            to_static_int_list(starts),
                            to_static_int_list(ends),
                            to_static_int_list(strides)):
        if st < 0:
            raise ValueError("strided_slice: negative strides are not "
                             "supported by torch indexing; flip first")
        idx[ax] = builtins.slice(s, e, st)
    return getitem(x, tuple(idx))


def crop(x, shape=None, offsets=None, name=None):
    shape = to_static_int_list(shape)
    offsets = to_static_int_list(offsets) if offsets is not None else \
        (0,) * x.dim()
    idx = tuple(builtins.slice(o, o + (s if s != -1 else x.shape[i] - o))
                for i, (o, s) in enumerate(zip(offsets, shape)))
    return getitem(x, idx)


def cast(x, dtype):
    dt = to_torch_dtype(dtype)
    if x.dtype == dt:
        return x
    return apply("cast_op", x, dtype=dt, src_dtype=x.dtype)


def as_strided(x, shape, stride, offset=0, name=None):
    return apply("as_strided_op", x, shape=tuple(shape), stride=tuple(stride),
                 offset=int(offset))


def unfold(x, axis, size, step, name=None):
    return apply("unfold_op", x, axis=int(axis), size=int(size),
                 step=int(step))


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(int(v) for v in a) if isinstance(a, (list, tuple))
                     else int(a) for a in axes)
    else:
        axes = int(axes)
    return apply("tensordot_op", x, y, axes=axes)


def atleast_1d(*inputs, name=None):
    outs = [reshape(t, [1]) if t.dim() == 0 else t for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = []
    for t in inputs:
        while t.dim() < 2:
            t = unsqueeze(t, 0)
        outs.append(t)
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = []
    for t in inputs:
        while t.dim() < 3:
            t = unsqueeze(t, t.dim())
        outs.append(t)
    return outs[0] if len(outs) == 1 else outs


def select_scatter(x, values, axis, index, name=None):
    if not isinstance(values, torch.Tensor):
        values = torch.tensor(values, dtype=x.dtype, device=x.device)
    return torch.select_scatter(x, torch.broadcast_to(
        values.to(x.dtype), x.select(axis, index).shape), axis, index)


def getitem(x, idx):
    """``x[idx]``; a boolean mask selects (a data-dependent shape)."""
    if isinstance(idx, torch.Tensor) and idx.dtype == torch.bool:
        return masked_select(x, idx)
    static, dynamic = encode_index(idx)
    return apply("getitem_op", x, *dynamic, static=static)


def setitem(x, idx, value):
    """``x[idx] = value``, in place."""
    if not isinstance(value, torch.Tensor):
        value = torch.tensor(value, dtype=x.dtype, device=x.device)
    if isinstance(idx, torch.Tensor) and idx.dtype == torch.bool:
        out = torch.where(idx, value.to(x.dtype), x)
    else:
        static, dynamic = encode_index(idx)
        out = apply("setitem_op", x, value, *dynamic, static=static)
    with torch.no_grad():
        x.copy_(out)
    return x


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply("diagonal_op", x, offset=int(offset), axis1=int(axis1),
                 axis2=int(axis2))
