"""Statistics ops (counterpart of ``paddle_tpu/tensor/stat.py``, Paddle's
``python/paddle/tensor/stat.py``)."""

from __future__ import annotations

import torch

from ..ops.op import apply, register_many
from ._helpers import axis_tuple

__all__ = ["mean", "std", "var", "median", "nanmedian", "quantile",
           "nanquantile", "numel", "histogram", "histogramdd", "bincount"]


def _moments(fn):
    def run(x, axis, unbiased, keepdim):
        dims = None if axis is None else (
            axis if isinstance(axis, tuple) else (axis,))
        return fn(x, dim=dims, correction=1 if unbiased else 0,
                  keepdim=keepdim)
    return run


def _quantile(fn):
    """torch's quantile takes one axis: several are moved last and
    flattened into one."""
    def run(x, q, axis, keepdim, interpolation="linear"):
        qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
        if axis is None:
            out = fn(x.reshape(-1), qt, dim=0, interpolation=interpolation)
            if keepdim:
                out = out.reshape(out.shape + (1,) * x.dim())
            return out
        axes = sorted(a % x.dim() for a in (axis if isinstance(
            axis, tuple) else (axis,)))
        keep = [d for d in range(x.dim()) if d not in axes]
        xm = x.permute(keep + axes).reshape(
            [x.shape[d] for d in keep] + [-1])
        out = fn(xm, qt, dim=-1, interpolation=interpolation)
        if keepdim:
            for a in axes:
                out = out.unsqueeze(a + (1 if qt.dim() else 0))
        return out
    return run


def _median(fn):
    q = _quantile(fn)

    def run(x, axis, keepdim):
        return q(x, 0.5, axis, keepdim)
    return run


register_many("reduction", {
    "std_op": _moments(torch.std), "var_op": _moments(torch.var),
    "median_op": _median(torch.quantile),
    "nanmedian_op": _median(torch.nanquantile),
})
register_many("opaque", {"quantile_op": _quantile(torch.quantile),
                         "nanquantile_op": _quantile(torch.nanquantile)})


def mean(x, axis=None, keepdim=False, name=None):
    from .math import mean as _mean
    return _mean(x, axis, keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply("std_op", x, axis=axis_tuple(axis), unbiased=bool(unbiased),
                 keepdim=bool(keepdim))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply("var_op", x, axis=axis_tuple(axis), unbiased=bool(unbiased),
                 keepdim=bool(keepdim))


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    if mode == "min" and axis is not None:
        n = x.shape[axis]
        vals = torch.kthvalue(x, (n - 1) // 2 + 1, dim=axis,
                              keepdim=keepdim).values
        return vals
    return apply("median_op", x, axis=axis_tuple(axis), keepdim=bool(keepdim))


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    return apply("nanmedian_op", x, axis=axis_tuple(axis),
                 keepdim=bool(keepdim))


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    qv = q if isinstance(q, (int, float)) else tuple(q)
    return apply("quantile_op", x, q=qv, axis=axis_tuple(axis),
                 keepdim=bool(keepdim), interpolation=interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    qv = q if isinstance(q, (int, float)) else tuple(q)
    return apply("nanquantile_op", x, q=qv, axis=axis_tuple(axis),
                 keepdim=bool(keepdim), interpolation=interpolation)


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    lo, hi = float(min), float(max)
    x = input.detach().float()
    if lo == 0 and hi == 0:
        lo, hi = float(x.min()), float(x.max())
    hist = torch.histc(x.cpu(), bins=int(bins), min=lo, max=hi) \
        if weight is None and not density else torch.histogram(
            x.cpu(), bins=int(bins), range=(lo, hi),
            weight=None if weight is None else weight.detach().float().cpu(),
            density=density).hist
    out_dtype = torch.float32 if density or weight is not None \
        else torch.int64
    return hist.to(device=input.device, dtype=out_dtype)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    flat = None if ranges is None else [float(v) for v in ranges]
    res = torch.histogramdd(x.detach().double().cpu(), bins=bins,
                            range=flat, density=density,
                            weight=None if weights is None
                            else weights.detach().double().cpu())
    return (res.hist.to(x.device),
            [e.to(x.device) for e in res.bin_edges])


def bincount(x, weights=None, minlength=0, name=None):
    return torch.bincount(x, weights=weights, minlength=int(minlength))
