"""Shape and dtype inference (infermeta) for the op registry
(counterpart of ``paddle_tpu/ops/infermeta.py``, after Paddle's per-arity
infermeta layer, ``paddle/phi/infermeta/{unary,binary,ternary,
multiary}.cc``).

Every registered op names a rule that runs before the op's torch function,
so that a bad call dies with ``ShapeError: matmul: ...``, naming the op and
the offending shapes, instead of torch's message from deep inside the
kernel.  Rules are small pure-Python functions over :class:`Meta` (shape,
dtype) views; they validate inputs and, where the output is cheaply
computable, predict output shapes.  Rules receive the op's static attrs,
so one category rule covers every op of that arity.  Dtypes are torch
dtypes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

__all__ = ["Meta", "ShapeError", "INFER_RULES"]


import torch

from ..core.errors import InvalidArgumentError


class ShapeError(InvalidArgumentError):
    """Op-level shape/dtype error (reference: PADDLE_ENFORCE in infermeta)."""


class Meta:
    """Shape/dtype view of one tensor argument (reference phi::MetaTensor)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: Tuple[int, ...], dtype) -> None:
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return f"Meta({self.shape}, {self.dtype})"


def _fail(op: str, msg: str) -> None:
    raise ShapeError(f"{op}: {msg}")


def _shapes(metas: Sequence[Meta]) -> str:
    return ", ".join(str(m.shape) for m in metas)


def _broadcast(op: str, *shapes: Tuple[int, ...]) -> Tuple[int, ...]:
    """NumPy broadcast with an op-labelled error."""
    out: List[int] = []
    for shape in shapes:
        shape = list(shape)
        n = max(len(out), len(shape))
        a = [1] * (n - len(out)) + out
        b = [1] * (n - len(shape)) + shape
        res = []
        for da, db in zip(a, b):
            if da == db or db == 1:
                res.append(da)
            elif da == 1:
                res.append(db)
            else:
                _fail(op, f"operands cannot be broadcast together: "
                          f"shapes {tuple(shapes)}")
        out = res
    return tuple(out)


def _norm_axis(op: str, axis: int, ndim: int, extra: int = 0) -> int:
    lo, hi = -ndim - extra, ndim + extra
    if not (lo <= axis < hi):
        _fail(op, f"axis {axis} out of range for rank-{ndim} input")
    return axis + ndim + extra if axis < 0 else axis


# --------------------------------------------------------------------------
# category rules: rule(op_name, metas, attrs) -> list[(shape, dtype)] | None
# --------------------------------------------------------------------------

def unary(op, metas, attrs):
    (x,) = metas[:1]
    return [(x.shape, x.dtype)]


def unary_bool(op, metas, attrs):
    return [(metas[0].shape, torch.bool)]


def unary_real(op, metas, attrs):
    """complex -> matching real dtype (angle/real/imag/abs-on-complex)."""
    x = metas[0]
    dt = x.dtype
    if dt.is_complex:
        dt = torch.float32 if dt == torch.complex64 else torch.float64
    return [(x.shape, dt)]


def cast(op, metas, attrs):
    from ..core.dtype import to_torch_dtype
    dt = attrs.get("dtype")
    return [(metas[0].shape, to_torch_dtype(dt) if dt is not None
             else metas[0].dtype)]


def binary_broadcast(op, metas, attrs):
    x, y = metas[0], metas[1]
    shape = _broadcast(op, x.shape, y.shape)
    return [(shape, torch.promote_types(x.dtype, y.dtype))]


def binary_bool(op, metas, attrs):
    shape = _broadcast(op, metas[0].shape, metas[1].shape)
    return [(shape, torch.bool)]


def ternary_broadcast(op, metas, attrs):
    shape = _broadcast(op, *[m.shape for m in metas[:3]])
    return [(shape, torch.promote_types(metas[1].dtype, metas[2].dtype))]


def _reduce_shape(op, x: Meta, attrs) -> Tuple[int, ...]:
    axis = attrs.get("axis", attrs.get("dim"))
    keep = bool(attrs.get("keepdim", attrs.get("keepdims", False)))
    if axis is None:
        return (1,) * x.ndim if keep else ()
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    axes = tuple(_norm_axis(op, int(a), x.ndim) for a in axes)
    if len(set(axes)) != len(axes):
        _fail(op, f"duplicate reduction axes {axes}")
    if keep:
        return tuple(1 if d in axes else s for d, s in enumerate(x.shape))
    return tuple(s for d, s in enumerate(x.shape) if d not in axes)


def reduction(op, metas, attrs):
    x = metas[0]
    return [(_reduce_shape(op, x, attrs), x.dtype)]


def reduction_bool(op, metas, attrs):
    return [(_reduce_shape(op, metas[0], attrs), torch.bool)]


def reduction_index(op, metas, attrs):
    return [(_reduce_shape(op, metas[0], attrs), torch.int64)]


def matmul(op, metas, attrs):
    x, y = metas[0], metas[1]
    if x.ndim == 0 or y.ndim == 0:
        _fail(op, f"inputs must be at least 1-D, got {_shapes((x, y))}")
    xs, ys = list(x.shape), list(y.shape)
    if attrs.get("transpose_x") and len(xs) >= 2:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if attrs.get("transpose_y") and len(ys) >= 2:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    x1 = xs if len(xs) > 1 else [1] + xs          # vector promotions
    y1 = ys if len(ys) > 1 else ys + [1]
    if x1[-1] != y1[-2]:
        _fail(op, f"contraction mismatch: x {tuple(x.shape)} "
                  f"(K={x1[-1]}) vs y {tuple(y.shape)} (K={y1[-2]})"
                  + (" with transpose" if attrs.get("transpose_x")
                     or attrs.get("transpose_y") else ""))
    batch = _broadcast(op, tuple(x1[:-2]), tuple(y1[:-2]))
    out = list(batch) + [x1[-2], y1[-1]]
    if len(xs) == 1:
        out.pop(-2)
    if len(ys) == 1:
        out.pop(-1)
    return [(tuple(out), torch.promote_types(x.dtype, y.dtype))]


def linear(op, metas, attrs):
    x, w = metas[0], metas[1]
    if x.shape[-1] != w.shape[0]:
        _fail(op, f"input features {x.shape[-1]} != weight rows "
                  f"{w.shape[0]} (x {x.shape}, w {w.shape})")
    out = x.shape[:-1] + (w.shape[-1],)
    if len(metas) > 2 and metas[2] is not None:
        b = metas[2]
        if b.shape and b.shape[-1] != w.shape[-1]:
            _fail(op, f"bias {b.shape} does not match out features "
                      f"{w.shape[-1]}")
    return [(out, x.dtype)]


def embedding(op, metas, attrs):
    # registered arg order: (weight, ids) — nn/functional/common.py:144
    table, ids = metas[0], metas[1]
    if table.ndim != 2:
        _fail(op, f"weight must be 2-D, got {table.shape}")
    return [(ids.shape + (table.shape[1],), table.dtype)]


def concat(op, metas, attrs):
    axis = int(attrs.get("axis", 0))
    first = metas[0]
    axis = _norm_axis(op, axis, first.ndim)
    total = 0
    for m in metas:
        if m.ndim != first.ndim:
            _fail(op, f"rank mismatch: {_shapes(metas)}")
        for d in range(first.ndim):
            if d != axis and m.shape[d] != first.shape[d]:
                _fail(op, f"all dims except axis {axis} must match: "
                          f"{_shapes(metas)}")
        total += m.shape[axis]
    out = list(first.shape)
    out[axis] = total
    return [(tuple(out), first.dtype)]


def stack(op, metas, attrs):
    axis = int(attrs.get("axis", 0))
    first = metas[0]
    for m in metas:
        if m.shape != first.shape:
            _fail(op, f"all inputs must share a shape: {_shapes(metas)}")
    axis = _norm_axis(op, axis, first.ndim, extra=1)
    out = list(first.shape)
    out.insert(axis, len(metas))
    return [(tuple(out), first.dtype)]


def reshape(op, metas, attrs):
    x = metas[0]
    shape = attrs.get("shape")
    if shape is None:
        return None
    shape = list(shape)
    size = 1
    for s in x.shape:
        size *= int(s)
    neg = [i for i, s in enumerate(shape) if s == -1]
    if len(neg) > 1:
        _fail(op, f"only one -1 allowed in target shape {tuple(shape)}")
    known = 1
    for i, s in enumerate(shape):
        if s == 0:  # paddle semantics: copy input dim
            if i >= x.ndim:
                _fail(op, f"0 at position {i} exceeds input rank {x.ndim}")
            shape[i] = x.shape[i]
        if shape[i] != -1:
            known *= shape[i]
    if neg:
        if known == 0 or size % known != 0:
            _fail(op, f"cannot infer -1: {x.shape} -> {tuple(shape)}")
        shape[neg[0]] = size // known
    elif known != size:
        _fail(op, f"cannot reshape {x.shape} (size {size}) to "
                  f"{tuple(shape)} (size {known})")
    return [(tuple(shape), x.dtype)]


def transpose(op, metas, attrs):
    x = metas[0]
    perm = attrs.get("perm")
    if perm is None:
        return [(tuple(reversed(x.shape)), x.dtype)]
    perm = [_norm_axis(op, int(p), x.ndim) for p in perm]
    if sorted(perm) != list(range(x.ndim)):
        _fail(op, f"perm {tuple(perm)} is not a permutation of rank "
                  f"{x.ndim}")
    return [(tuple(x.shape[p] for p in perm), x.dtype)]


def squeeze(op, metas, attrs):
    x = metas[0]
    axis = attrs.get("axis")
    if axis is None:
        return [(tuple(s for s in x.shape if s != 1), x.dtype)]
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    # paddle semantics: axes with size != 1 are silently kept
    axes = {_norm_axis(op, int(a), x.ndim) for a in axes}
    return [(tuple(s for d, s in enumerate(x.shape)
                   if not (d in axes and s == 1)), x.dtype)]


def unsqueeze(op, metas, attrs):
    x = metas[0]
    axis = attrs.get("axis", 0)
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    out = list(x.shape)
    for a in sorted(int(a) for a in axes):
        a = _norm_axis(op, a, len(out), extra=1)
        out.insert(a, 1)
    return [(tuple(out), x.dtype)]


def square_matrix(op, metas, attrs):
    x = metas[0]
    if x.ndim < 2 or x.shape[-1] != x.shape[-2]:
        _fail(op, f"expects square matrices, got {x.shape}")
    return None  # per-op output shapes differ (det scalar, inv same, ...)


def solve(op, metas, attrs):
    a, b = metas[0], metas[1]
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        _fail(op, f"coefficient matrix must be square, got {a.shape}")
    if b.ndim >= 2 and b.shape[-2] != a.shape[-1]:
        _fail(op, f"dimension mismatch: A {a.shape} vs b {b.shape}")
    return None


def softmax_like(op, metas, attrs):
    x = metas[0]
    axis = int(attrs.get("axis", -1))
    _norm_axis(op, axis, x.ndim)
    return [(x.shape, x.dtype)]


def gather_like(op, metas, attrs):
    x = metas[0]
    if x.ndim == 0:
        _fail(op, "input must not be a scalar")
    axis = attrs.get("axis", attrs.get("dim", 0))
    if axis is not None:
        _norm_axis(op, int(axis), x.ndim)
    return None


def attention(op, metas, attrs):
    q, k, v = metas[0], metas[1], metas[2]
    if op in ("varlen_sdpa", "varlen_sdpa_dropout", "varlen_flash"):
        # packed layout: (total_tokens, heads, head_dim) + cu_seqlens
        if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
            _fail(op, f"packed q/k/v must be rank-3 [total, heads, dim], "
                      f"got {_shapes((q, k, v))}")
        if q.shape[-1] != k.shape[-1]:
            _fail(op, f"q head_dim {q.shape[-1]} != k head_dim "
                      f"{k.shape[-1]}")
        if k.shape[0] != v.shape[0]:
            _fail(op, f"k total {k.shape[0]} != v total {v.shape[0]}")
        return [(q.shape[:-1] + (v.shape[-1],), q.dtype)]
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        _fail(op, f"q/k/v must be rank-4 [batch, seq, heads, dim], got "
                  f"{_shapes((q, k, v))}")
    if q.shape[-1] != k.shape[-1]:
        _fail(op, f"q head_dim {q.shape[-1]} != k head_dim {k.shape[-1]}")
    if k.shape[1] != v.shape[1]:
        _fail(op, f"k seq {k.shape[1]} != v seq {v.shape[1]}")
    return [(q.shape[:-1] + (v.shape[-1],), q.dtype)]


def conv(op, metas, attrs):
    x, w = metas[0], metas[1]
    if x.ndim != w.ndim:
        _fail(op, f"input rank {x.ndim} != weight rank {w.ndim} "
                  f"(x {x.shape}, w {w.shape})")
    groups = int(attrs.get("groups", 1) or 1)
    if op.startswith("conv_transpose"):
        if x.shape[1] != w.shape[0]:
            _fail(op, f"channels {x.shape[1]} != weight in-channels "
                      f"{w.shape[0]} (w {w.shape})")
    elif x.shape[1] != w.shape[1] * groups:
        _fail(op, f"channels {x.shape[1]} != weight in-channels "
                  f"{w.shape[1]}*groups {groups} (w {w.shape})")
    return None  # spatial dims depend on stride/pad/dilation


def norm_layer(op, metas, attrs):
    x = metas[0]
    return [(x.shape, x.dtype)]


def opaque(op, metas, attrs):
    """No static rule (data-dependent or composite output shapes)."""
    return None


INFER_RULES: Dict[str, Any] = {
    "unary": unary,
    "unary_bool": unary_bool,
    "unary_real": unary_real,
    "cast": cast,
    "binary_broadcast": binary_broadcast,
    "binary_bool": binary_bool,
    "ternary_broadcast": ternary_broadcast,
    "reduction": reduction,
    "reduction_bool": reduction_bool,
    "reduction_index": reduction_index,
    "matmul": matmul,
    "linear": linear,
    "embedding": embedding,
    "concat": concat,
    "stack": stack,
    "reshape": reshape,
    "transpose": transpose,
    "squeeze": squeeze,
    "unsqueeze": unsqueeze,
    "square_matrix": square_matrix,
    "solve": solve,
    "softmax_like": softmax_like,
    "gather_like": gather_like,
    "attention": attention,
    "conv": conv,
    "norm_layer": norm_layer,
    "opaque": opaque,
}
