"""Search and sort ops (counterpart of ``paddle_tpu/tensor/search.py``,
Paddle's ``python/paddle/tensor/search.py``)."""

from __future__ import annotations

import torch

from ..ops.op import apply, register_many, register_op
from ._helpers import as_tensor, tdtype

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "where", "nonzero",
    "masked_select", "searchsorted", "kthvalue", "mode", "index_select",
    "bucketize",
]


def _arg(fn):
    def run(x, axis, keepdim, dtype):
        if axis is None:
            out = fn(x.reshape(-1), 0)
            if keepdim:
                out = out.reshape((1,) * x.dim())
        else:
            out = fn(x, axis, keepdim=keepdim)
        return out.to(tdtype(dtype))
    return run


def _argsort(x, axis, descending, stable):
    # the reference sorts -x for a descending order
    return torch.argsort(-x if descending else x, dim=axis, stable=stable)


def _sort(x, axis, descending):
    return -torch.sort(-x, dim=axis).values if descending else \
        torch.sort(x, dim=axis).values


def _topk(x, k, axis, largest, sorted):
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals, idx = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return vals, idx


register_many("reduction_index", {"argmax_op": _arg(torch.argmax),
                                  "argmin_op": _arg(torch.argmin)})
register_many("gather_like", {
    "argsort_op": _argsort, "sort_op": _sort,
    "searchsorted_op": lambda sorted_seq, values, right: torch.searchsorted(
        sorted_seq, values, right=right),
})
register_op("topk_op", _topk, "gather_like")


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply("argmax_op", x, axis=None if axis is None else int(axis),
                 keepdim=bool(keepdim), dtype=tdtype(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply("argmin_op", x, axis=None if axis is None else int(axis),
                 keepdim=bool(keepdim), dtype=tdtype(dtype))


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return apply("argsort_op", x, axis=int(axis), descending=bool(descending),
                 stable=bool(stable))


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return apply("sort_op", x, axis=int(axis), descending=bool(descending))


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    return apply("topk_op", x, k=int(k),
                 axis=None if axis is None else int(axis),
                 largest=bool(largest), sorted=bool(sorted))


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    dev = condition.device
    x = x if isinstance(x, torch.Tensor) else as_tensor(x, device=dev)
    y = y if isinstance(y, torch.Tensor) else as_tensor(y, device=dev)
    return apply("where_op", condition, x, y)


def nonzero(x, as_tuple=False):
    """Indices of the nonzero elements (a data-dependent shape)."""
    idx = torch.nonzero(x)
    return tuple(idx.unbind(1)) if as_tuple else idx


def masked_select(x, mask, name=None):
    from .manipulation import masked_select as _ms
    return _ms(x, mask)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    out = apply("searchsorted_op", sorted_sequence, values, right=bool(right))
    return out.to(torch.int32 if out_int32 else torch.int64)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    axis = int(axis) % x.dim()
    svals = apply("sort_op", x, axis=axis, descending=False)
    sidx = apply("argsort_op", x, axis=axis, descending=False, stable=True)
    vals = svals.narrow(axis, k - 1, 1)
    idx = sidx.narrow(axis, k - 1, 1)
    if not keepdim:
        vals, idx = vals.squeeze(axis), idx.squeeze(axis)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the largest among ties, as
    np.unique's order gives the reference) and its last index."""
    axis = int(axis) % x.dim()
    xm = x.movedim(axis, -1)
    flat = xm.reshape(-1, xm.shape[-1])
    vals, ids = [], []
    for row in flat:
        u, counts = torch.unique(row, return_counts=True)
        m = u[torch.argmax(counts)]
        vals.append(m)
        ids.append(torch.nonzero(row == m)[-1, 0])
    shape = xm.shape[:-1]
    mv = torch.stack(vals).reshape(shape)
    mi = torch.stack(ids).reshape(shape)
    if keepdim:
        mv, mi = mv.unsqueeze(axis), mi.unsqueeze(axis)
    return mv, mi


def index_select(x, index, axis=0, name=None):
    from .manipulation import index_select as _is
    return _is(x, index, axis)
