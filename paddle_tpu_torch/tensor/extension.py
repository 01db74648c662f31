"""The long tail of the tensor API (counterpart of
``paddle_tpu/tensor/extension.py``): compositions over the op surface and
torch's special functions, with the reference's semantics.  Functions
whose output shape depends on the data (``unique``,
``unique_consecutive``) read the input on the host, as the reference's
do.  Nothing here registers an op.
"""

from __future__ import annotations

import math as _pymath

import numpy as np
import torch

from ..core.dtype import to_torch_dtype

__all__ = [
    "unique", "unique_consecutive", "argwhere", "take", "block_diag",
    "cartesian_prod", "cdist", "trapezoid", "cumulative_trapezoid",
    "renorm", "multigammaln", "polygamma", "signbit", "sinc", "copysign",
    "gammaln", "gammainc", "gammaincc", "i0", "i1", "i0e", "i1e",
    "isneginf", "isposinf", "isreal", "logaddexp", "logaddexp2",
    "nextafter", "positive", "frexp", "slice_scatter", "index_fill",
    "index_fill_", "column_stack", "row_stack", "hstack", "vstack",
    "dstack", "addmm", "addmm_", "pdist", "sgn", "unflatten",
    "diagonal_scatter", "broadcast_shape", "as_complex", "as_real",
    "shard_index",
]


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _host(x) -> np.ndarray:
    t = _t(x).detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _write_back(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """In place: ``x`` takes ``out``'s values (no gradient, as the op
    surface's other in-place variants)."""
    with torch.no_grad():
        x.copy_(out.detach())
    return x


# -- search ------------------------------------------------------------------
def unique(x, return_index=False, return_inverse=False,
           return_counts=False, axis=None, dtype="int64", name=None):
    """Sorted unique values (and first indices, the inverse, counts), read
    on the host; results on x's device."""
    dev = _t(x).device
    out = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(out, tuple):
        return torch.as_tensor(out, device=dev)
    idt = to_torch_dtype(dtype)
    res = [torch.as_tensor(out[0], device=dev)]
    for extra, kind in zip(out[1:], [k for f, k in (
            (return_index, "index"), (return_inverse, "inverse"),
            (return_counts, "counts")) if f]):
        if kind == "inverse" and axis is None:
            extra = extra.reshape(-1)   # a 1-D inverse of numel elements
        res.append(torch.as_tensor(extra, device=dev).to(idt))
    return tuple(res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    dev = _t(x).device
    a = _host(x)
    if axis is None:
        a = a.reshape(-1)
        axis = 0
    sl = [slice(None)] * a.ndim
    keep = np.ones(a.shape[axis], bool)
    if a.shape[axis] > 1:
        moved = np.moveaxis(a, axis, 0)
        diff = (moved[1:] != moved[:-1]).reshape(moved.shape[0] - 1, -1)
        keep[1:] = diff.any(axis=1)
    sl[axis] = keep
    out = [torch.as_tensor(a[tuple(sl)], device=dev)]
    group = np.cumsum(keep) - 1
    idt = to_torch_dtype(dtype)
    if return_inverse:
        out.append(torch.as_tensor(group, device=dev).to(idt))
    if return_counts:
        out.append(torch.as_tensor(np.bincount(group), device=dev).to(idt))
    return out[0] if len(out) == 1 else tuple(out)


def argwhere(x, name=None) -> torch.Tensor:
    return torch.argwhere(_t(x))


def take(x, index, mode="raise", name=None) -> torch.Tensor:
    """Gather from the flattened input; ``mode`` "raise" (an index out of
    range raises; reads the host), "wrap" or "clip"."""
    flat = _t(x).reshape(-1)
    idx = _t(index).to(flat.device)
    n = flat.shape[0]
    if mode == "wrap":
        ia = torch.remainder(idx, n)
    elif mode == "clip":
        ia = idx.clamp(0, n - 1)
    else:
        if bool(((idx < -n) | (idx >= n)).any()):
            raise IndexError(
                f"take: index out of range for input with {n} elements")
        ia = torch.where(idx < 0, idx + n, idx)
    return flat[ia.reshape(-1).long()].reshape(idx.shape)


# -- construction ---------------------------------------------------------
def block_diag(inputs, name=None) -> torch.Tensor:
    mats = [_t(m) for m in inputs]
    mats = [m.reshape(1, -1) if m.dim() <= 1 else m for m in mats]
    rows = sum(m.shape[0] for m in mats)
    cols = sum(m.shape[1] for m in mats)
    out = mats[0].new_zeros((rows, cols))
    r = c = 0
    for m in mats:
        out[r:r + m.shape[0], c:c + m.shape[1]] = m
        r += m.shape[0]
        c += m.shape[1]
    return out


def cartesian_prod(x, name=None) -> torch.Tensor:
    grids = torch.meshgrid(*[_t(t) for t in x], indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def column_stack(x, name=None) -> torch.Tensor:
    return torch.cat([t[:, None] if t.dim() == 1 else t
                      for t in map(_t, x)], dim=1)


def vstack(x, name=None) -> torch.Tensor:
    return torch.cat([t[None, :] if t.dim() == 1 else t
                      for t in map(_t, x)], dim=0)


row_stack = vstack


def hstack(x, name=None) -> torch.Tensor:
    ts = [_t(t) for t in x]
    return torch.cat(ts, dim=0 if ts[0].dim() == 1 else 1)


def dstack(x, name=None) -> torch.Tensor:
    fixed = []
    for t in map(_t, x):
        if t.dim() == 1:
            t = t[None, :, None]
        elif t.dim() == 2:
            t = t[:, :, None]
        fixed.append(t)
    return torch.cat(fixed, dim=2)


# -- linalg and stat --------------------------------------------------------
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None) -> torch.Tensor:
    """Pairwise p-norm distances, (..., n, d) x (..., m, d) -> (..., n,
    m), by the reference's composition (differentiable)."""
    diff = _t(x).unsqueeze(-2) - _t(y).unsqueeze(-3)
    if p == 2.0:
        return (diff * diff).sum(-1) ** 0.5
    ad = diff.abs()
    if p == float("inf"):
        return ad.amax(-1)
    return (ad ** p).sum(-1) ** (1.0 / p)


def _mid_and_dx(y, x, axis):
    ya = _t(y)
    n = ya.shape[axis]
    mid = (ya.narrow(axis, 0, n - 1) + ya.narrow(axis, 1, n - 1)) * 0.5
    if x is None:
        return mid, None
    xa = _t(x)
    dxs = torch.diff(xa, dim=axis if xa.dim() > 1 else 0)
    if dxs.dim() == 1 and mid.dim() > 1:
        shape = [1] * mid.dim()
        shape[axis if axis >= 0 else mid.dim() + axis] = -1
        dxs = dxs.reshape(shape)
    return mid, dxs


def trapezoid(y, x=None, dx=None, axis=-1, name=None) -> torch.Tensor:
    mid, dxs = _mid_and_dx(y, x, axis)
    if dxs is not None:
        return (mid * dxs).sum(axis)
    return (mid * (dx if dx is not None else 1.0)).sum(axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None
                         ) -> torch.Tensor:
    mid, dxs = _mid_and_dx(y, x, axis)
    if dxs is not None:
        mid = mid * dxs
    elif dx is not None:
        mid = mid * dx
    return mid.cumsum(axis)


def renorm(x, p: float, axis: int, max_norm: float, name=None
           ) -> torch.Tensor:
    """Each slice along ``axis`` whose p-norm exceeds ``max_norm`` scaled
    to ``max_norm / (norm + 1e-7)``; the factor is a constant to the
    gradient, as in the reference."""
    t = _t(x)
    dims = [d for d in range(t.dim()) if d != axis % t.dim()]
    norms = (t.detach().abs() ** p).sum(dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return t * factor


# -- special functions -------------------------------------------------------
def _unary(fn):
    def run(x, name=None):
        return fn(_t(x))
    run.__name__ = getattr(fn, "__name__", "unary")
    return run


sinc = _unary(torch.sinc)
i0 = _unary(torch.special.i0)
i0e = _unary(torch.special.i0e)
i1 = _unary(torch.special.i1)
i1e = _unary(torch.special.i1e)
gammaln = _unary(torch.special.gammaln)
signbit = _unary(torch.signbit)
isneginf = _unary(torch.isneginf)
isposinf = _unary(torch.isposinf)
isreal = _unary(torch.isreal)


def positive(x, name=None) -> torch.Tensor:
    t = _t(x)
    if not (t.is_floating_point() or t.is_complex() or
            t.dtype in (torch.bool, torch.uint8, torch.int8, torch.int16,
                        torch.int32, torch.int64)):
        raise TypeError("positive: numeric tensor required")
    return t


def gammainc(x, y, name=None) -> torch.Tensor:
    return torch.special.gammainc(_t(x), _t(y))


def gammaincc(x, y, name=None) -> torch.Tensor:
    return torch.special.gammaincc(_t(x), _t(y))


def multigammaln(x, p: int, name=None) -> torch.Tensor:
    a = _t(x)
    i = torch.arange(1, p + 1, dtype=a.dtype, device=a.device)
    terms = torch.special.gammaln(a[..., None] + (1 - i) / 2.0)
    return terms.sum(-1) + p * (p - 1) / 4.0 * _pymath.log(_pymath.pi)


def polygamma(x, n: int, name=None) -> torch.Tensor:
    return torch.special.polygamma(int(n), _t(x))


def copysign(x, y, name=None) -> torch.Tensor:
    return torch.copysign(_t(x), _t(y))


def logaddexp(x, y, name=None) -> torch.Tensor:
    return torch.logaddexp(_t(x), _t(y))


def logaddexp2(x, y, name=None) -> torch.Tensor:
    return torch.logaddexp2(_t(x), _t(y))


def nextafter(x, y, name=None) -> torch.Tensor:
    return torch.nextafter(_t(x), _t(y))


def frexp(x, name=None):
    return torch.frexp(_t(x))


# -- scatter ------------------------------------------------------------------
def slice_scatter(x, value, axes, starts, ends, strides=None, name=None):
    """x with ``value`` written into the slice (a new tensor)."""
    out = _t(x).clone()
    idx = [slice(None)] * out.dim()
    for ax, s, e, st in zip(axes, starts, ends, strides or [1] * len(axes)):
        idx[int(ax)] = slice(int(s), int(e), int(st))
    out[tuple(idx)] = _t(value).to(out.dtype)
    return out


def index_fill(x, index, axis, value, name=None) -> torch.Tensor:
    t = _t(x)
    return t.index_fill(axis % t.dim(), _t(index).long().to(t.device),
                        value)


def index_fill_(x, index, axis, value, name=None) -> torch.Tensor:
    return _write_back(x, index_fill(x, index, axis, value))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None) -> torch.Tensor:
    """beta * input + alpha * (x @ y); the product takes ``matmul``'s
    autocast."""
    from .linalg import matmul
    return _t(input) * beta + matmul(x, y) * alpha


def addmm_(input, x, y, beta=1.0, alpha=1.0, name=None) -> torch.Tensor:
    return _write_back(input, addmm(input, x, y, beta, alpha))


def pdist(x, p: float = 2.0, name=None) -> torch.Tensor:
    """Condensed pairwise distances of the rows."""
    t = _t(x)
    iu, ju = np.triu_indices(t.shape[0], k=1)
    full = cdist(t, t, p=p)
    return full[torch.as_tensor(iu, device=t.device),
                torch.as_tensor(ju, device=t.device)]


def sgn(x, name=None) -> torch.Tensor:
    """x / |x| (0 at 0) for complex x; the sign for real x."""
    t = _t(x)
    if t.is_complex():
        mag = t.abs()
        return torch.where(mag == 0, torch.zeros_like(t),
                           t / torch.where(mag == 0, torch.ones_like(mag),
                                           mag))
    return torch.sign(t)


def unflatten(x, axis: int, shape, name=None) -> torch.Tensor:
    t = _t(x)
    axis = axis % t.dim()
    return t.reshape(list(t.shape[:axis]) + [int(s) for s in shape]
                     + list(t.shape[axis + 1:]))


def diagonal_scatter(x, y, offset: int = 0, axis1: int = 0, axis2: int = 1,
                     name=None) -> torch.Tensor:
    t = _t(x)
    return torch.diagonal_scatter(t, _t(y).to(t.dtype), offset, axis1,
                                  axis2)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def as_complex(x, name=None) -> torch.Tensor:
    t = _t(x)
    if t.shape[-1] != 2:
        raise ValueError(f"as_complex expects trailing dim 2, got "
                         f"{tuple(t.shape)}")
    return torch.complex(t[..., 0], t[..., 1])


def as_real(x, name=None) -> torch.Tensor:
    t = _t(x)
    return torch.stack([t.real, t.imag], dim=-1)


def shard_index(input, index_num: int, nshards: int, shard_id: int,
                ignore_value: int = -1, name=None) -> torch.Tensor:
    """Global ids relabelled to shard-local ids, others ``ignore_value``."""
    t = _t(input)
    per = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * per, (shard_id + 1) * per
    inside = (t >= lo) & (t < hi)
    return torch.where(inside, t - lo,
                       torch.full_like(t, ignore_value)).to(t.dtype)
