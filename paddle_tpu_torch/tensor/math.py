"""Math ops (counterpart of ``paddle_tpu/tensor/math.py``, Paddle's
``python/paddle/tensor/math.py``).

Each op is a torch function registered under the reference's name; the
public functions below keep Paddle's signatures.  Autograd is torch's.
"""

from __future__ import annotations

import functools
import itertools

import torch

from ..ops.op import apply, register_many, register_op
from ._helpers import as_tensor, axis_tuple, tdtype

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "float_power", "maximum", "minimum", "fmax", "fmin",
    "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
    "square", "abs", "sign", "floor", "ceil", "round", "trunc", "frac",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "atan2", "reciprocal", "neg", "clip",
    "sum", "nansum", "mean", "nanmean", "max", "min", "amax", "amin",
    "prod", "cumsum", "cumprod", "cummax", "cummin", "logsumexp",
    "logcumsumexp", "all", "any", "isnan", "isinf", "isfinite",
    "nan_to_num", "erf", "erfinv", "lgamma", "digamma", "sigmoid", "logit",
    "add_n", "scale", "stanh", "softplus", "multiplex", "diff",
    "inner", "outer", "deg2rad", "rad2deg", "gcd", "lcm", "heaviside",
    "trace", "kron", "lerp", "rot90", "count_nonzero", "increment",
    "angle", "conj", "real", "imag", "ldexp", "hypot", "combinations",
]


def _dims(x, axis):
    """A reduction's axes as a tuple over ``x`` (all of them for None)."""
    if axis is None:
        return tuple(range(x.dim()))
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def _keep_all(out, x, axis, keepdim):
    """torch reductions over every axis give 0-dim; keepdim keeps them."""
    if keepdim and axis is None:
        return out.reshape((1,) * x.dim())
    return out


# -- binary elementwise -------------------------------------------------------

register_many("binary_broadcast", {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.true_divide, "pow_op": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "floor_divide": torch.floor_divide, "remainder": torch.remainder,
    "fmax": torch.fmax, "fmin": torch.fmin, "atan2": torch.atan2,
    "heaviside": lambda x, y: torch.where(      # differentiable in y
        x < 0, torch.zeros_like(y), torch.where(x > 0, torch.ones_like(y),
                                                y)),
    "gcd": torch.gcd, "lcm": torch.lcm,
    "ldexp": torch.ldexp, "hypot": torch.hypot,
})
register_many("opaque", {"inner_op": torch.inner, "outer_op": torch.outer,
                         "kron": torch.kron})
register_op("lerp", lambda x, y, w: x + w * (y - x), "ternary_broadcast")


# -- unary elementwise -------------------------------------------------------

def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


register_many("unary", {
    "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "square": torch.square, "abs": torch.abs,
    "neg": torch.neg, "reciprocal": torch.reciprocal,
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "sin": torch.sin,
    "cos": torch.cos, "expm1": torch.expm1, "log2": torch.log2,
    "log10": torch.log10, "log1p": torch.log1p, "sign": torch.sign,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "trunc": torch.trunc, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "asinh": torch.asinh, "acosh": torch.acosh,
    "atanh": torch.atanh, "erf": torch.erf, "erfinv": torch.erfinv,
    "lgamma": torch.lgamma, "digamma": torch.digamma,
    "deg2rad": torch.deg2rad, "rad2deg": torch.rad2deg,
    "conj": torch.conj_physical,
    "logit": lambda x, eps: torch.logit(x, eps),
    "stanh": lambda x, scale_a, scale_b: scale_b * torch.tanh(scale_a * x),
    "softplus_math": lambda x, beta, threshold: torch.where(
        beta * x > threshold, x, torch.log1p(torch.exp(beta * x)) / beta),
    "nan_to_num": lambda x, nan, posinf, neginf: torch.nan_to_num(
        x, nan=nan, posinf=posinf, neginf=neginf),
    "clip_op": lambda x, lo, hi: torch.clamp(x, lo, hi),
    "scale_op": lambda x, scale, bias, bias_after_scale: (
        x * scale + bias if bias_after_scale else (x + bias) * scale),
})
register_many("unary_bool", {"isnan": torch.isnan, "isinf": torch.isinf,
                             "isfinite": torch.isfinite})
register_many("unary_real", {"angle": torch.angle, "real_op": torch.real,
                             "imag_op": _imag})


# -- reductions ---------------------------------------------------------------

def _sum(x, axis, keepdim, dtype):
    out = torch.sum(x, dim=_dims(x, axis), keepdim=keepdim,
                    dtype=tdtype(dtype))
    return _keep_all(out, x, axis, keepdim)


def _over(fn):
    """A reduction that takes one axis at a time, over several."""
    def run(x, axis, keepdim):
        if x.dim() == 0:
            return fn(x.reshape(1), 0, False).reshape(())
        out = x
        for a in sorted({d % x.dim() for d in _dims(x, axis)},
                        reverse=True):
            out = fn(out, a, keepdim)
        return _keep_all(out, x, axis, keepdim)
    return run


def _red(fn):
    def run(x, axis, keepdim):
        return _keep_all(fn(x, dim=_dims(x, axis), keepdim=keepdim), x,
                         axis, keepdim)
    return run


def _count_nonzero(x, axis, keepdim):
    dims = _dims(x, axis)
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        for d in sorted(a % x.dim() for a in dims):
            out = out.unsqueeze(d)
    return out


register_many("reduction", {
    "sum_op": _sum,
    "mean_op": _red(torch.mean),
    "max_op": _red(torch.amax),
    "min_op": _red(torch.amin),
    "prod_op": _over(lambda x, d, k: torch.prod(x, d, keepdim=k)),
    "nansum_op": _red(torch.nansum),
    "nanmean_op": _red(torch.nanmean),
    "logsumexp_op": _red(torch.logsumexp),
})
register_many("reduction_bool", {
    "all_op": _over(lambda x, d, k: torch.all(x, d, keepdim=k)),
    "any_op": _over(lambda x, d, k: torch.any(x, d, keepdim=k)),
})
register_op("count_nonzero_op", _count_nonzero, "reduction_index")
register_many("softmax_like", {
    "cumsum_op": lambda x, axis: torch.cumsum(x, axis),
    "cumprod_op": lambda x, axis: torch.cumprod(x, axis),
    # the reference's formula, log(cumsum(exp(x))), not torch's stable one
    "logcumsumexp_op": lambda x, axis: torch.log(torch.cumsum(torch.exp(x),
                                                              axis)),
})
register_many("gather_like", {
    "trace_op": lambda x, offset, axis1, axis2: torch.diagonal(
        x, offset, axis1, axis2).sum(-1),
    "diff_op": lambda x, n, axis: torch.diff(x, n, axis),
    "rot90_op": lambda x, k, axes: torch.rot90(x, k, list(axes)),
    "cummax_op": lambda x, axis: torch.cummax(x, axis).values,
    "cummin_op": lambda x, axis: torch.cummin(x, axis).values,
})
register_op("add_n_op", lambda *xs: functools.reduce(torch.add, xs))
register_op("multiplex_op", lambda index, *ins: torch.stack(ins, 0)[
    index[:, 0].long(), torch.arange(index.shape[0], device=index.device)])


# -- Python wrappers (Paddle signatures) ---------------------------------------

def _binary(op_name):
    def fn(x, y, name=None):
        return apply(op_name, x, y)
    fn.__name__ = op_name
    return fn


add = _binary("add")
subtract = _binary("subtract")
multiply = _binary("multiply")
divide = _binary("divide")
floor_divide = _binary("floor_divide")
remainder = _binary("remainder")
mod = remainder
maximum = _binary("maximum")
minimum = _binary("minimum")
fmax = _binary("fmax")
fmin = _binary("fmin")
atan2 = _binary("atan2")
heaviside = _binary("heaviside")
gcd = _binary("gcd")
lcm = _binary("lcm")
ldexp = _binary("ldexp")
hypot = _binary("hypot")
kron = _binary("kron")


def pow(x, y, name=None):
    return apply("pow_op", x, y)


float_power = pow


def _unary(op_name):
    def fn(x, name=None):
        return apply(op_name, x)
    fn.__name__ = op_name
    return fn


exp = _unary("exp")
expm1 = _unary("expm1")
log = _unary("log")
log2 = _unary("log2")
log10 = _unary("log10")
log1p = _unary("log1p")
sqrt = _unary("sqrt")
rsqrt = _unary("rsqrt")
square = _unary("square")
abs = _unary("abs")
sign = _unary("sign")
floor = _unary("floor")
ceil = _unary("ceil")
round = _unary("round")
trunc = _unary("trunc")
sin = _unary("sin")
cos = _unary("cos")
tan = _unary("tan")
asin = _unary("asin")
acos = _unary("acos")
atan = _unary("atan")
sinh = _unary("sinh")
cosh = _unary("cosh")
tanh = _unary("tanh")
asinh = _unary("asinh")
acosh = _unary("acosh")
atanh = _unary("atanh")
reciprocal = _unary("reciprocal")
neg = _unary("neg")
erf = _unary("erf")
erfinv = _unary("erfinv")
lgamma = _unary("lgamma")
digamma = _unary("digamma")
sigmoid = _unary("sigmoid")
isnan = _unary("isnan")
isinf = _unary("isinf")
isfinite = _unary("isfinite")
deg2rad = _unary("deg2rad")
rad2deg = _unary("rad2deg")
angle = _unary("angle")
conj = _unary("conj")
real = _unary("real_op")
imag = _unary("imag_op")


def frac(x, name=None):
    return subtract(x, apply("trunc", x))


def logit(x, eps=None, name=None):
    return apply("logit", x, eps=eps)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply("stanh", x, scale_a=float(scale_a), scale_b=float(scale_b))


def softplus(x, beta=1, threshold=20, name=None):
    return apply("softplus_math", x, beta=float(beta),
                 threshold=float(threshold))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply("nan_to_num", x, nan=float(nan),
                 posinf=None if posinf is None else float(posinf),
                 neginf=None if neginf is None else float(neginf))


def clip(x, min=None, max=None, name=None):
    lo = min if isinstance(min, torch.Tensor) or min is None else \
        torch.tensor(min, dtype=x.dtype, device=x.device)
    hi = max if isinstance(max, torch.Tensor) or max is None else \
        torch.tensor(max, dtype=x.dtype, device=x.device)
    return apply("clip_op", x, lo, hi)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    out = apply("scale_op", x, scale=float(scale), bias=float(bias),
                bias_after_scale=bool(bias_after_scale))
    if act is not None:
        out = getattr(torch.nn.functional, act)(out)
    return out


def increment(x, value=1.0, name=None):
    """In place: ``x += value``."""
    with torch.no_grad():
        x.add_(value)
    return x


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    return apply("sum_op", x, axis=axis_tuple(axis), keepdim=bool(keepdim),
                 dtype=tdtype(dtype))


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    out = apply("nansum_op", x, axis=axis_tuple(axis), keepdim=bool(keepdim))
    return out.to(tdtype(dtype)) if dtype is not None else out


def mean(x, axis=None, keepdim=False, name=None):
    return apply("mean_op", x, axis=axis_tuple(axis), keepdim=bool(keepdim))


def nanmean(x, axis=None, keepdim=False, name=None):
    return apply("nanmean_op", x, axis=axis_tuple(axis),
                 keepdim=bool(keepdim))


def max(x, axis=None, keepdim=False, name=None):
    return apply("max_op", x, axis=axis_tuple(axis), keepdim=bool(keepdim))


def min(x, axis=None, keepdim=False, name=None):
    return apply("min_op", x, axis=axis_tuple(axis), keepdim=bool(keepdim))


amax = max
amin = min


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    out = apply("prod_op", x, axis=axis_tuple(axis), keepdim=bool(keepdim))
    return out.to(tdtype(dtype)) if dtype is not None else out


def all(x, axis=None, keepdim=False, name=None):
    return apply("all_op", x, axis=axis_tuple(axis), keepdim=bool(keepdim))


def any(x, axis=None, keepdim=False, name=None):
    return apply("any_op", x, axis=axis_tuple(axis), keepdim=bool(keepdim))


def _flat_if_none(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, int(axis))


def cumsum(x, axis=None, dtype=None, name=None):
    x, axis = _flat_if_none(x, axis)
    out = apply("cumsum_op", x, axis=axis)
    return out.to(tdtype(dtype)) if dtype is not None else out


def cumprod(x, dim=None, dtype=None, name=None):
    out = apply("cumprod_op", x, axis=int(dim))
    return out.to(tdtype(dtype)) if dtype is not None else out


def _cum_arg_indices(x, values, axis, dtype):
    """The last position at or before each element holding the running
    extreme (the reference's index rule)."""
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device).reshape(
        [-1 if i == axis else 1 for i in range(x.dim())])
    pos = torch.where(x == values, idx, torch.full_like(idx, -1))
    return torch.cummax(pos, axis).values.to(tdtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    x, axis = _flat_if_none(x, axis)
    values = apply("cummax_op", x, axis=axis)
    return values, _cum_arg_indices(x.detach(), values.detach(), axis,
                                    dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    x, axis = _flat_if_none(x, axis)
    values = apply("cummin_op", x, axis=axis)
    return values, _cum_arg_indices(x.detach(), values.detach(), axis,
                                    dtype)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return apply("logsumexp_op", x, axis=axis_tuple(axis),
                 keepdim=bool(keepdim))


def logcumsumexp(x, axis=None, name=None):
    x, axis = _flat_if_none(x, axis)
    return apply("logcumsumexp_op", x, axis=axis)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return apply("count_nonzero_op", x, axis=axis_tuple(axis),
                 keepdim=bool(keepdim))


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs
    return apply("add_n_op", *inputs)


def multiplex(inputs, index, name=None):
    return apply("multiplex_op", index, *inputs)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply("trace_op", x, offset=int(offset), axis1=int(axis1),
                 axis2=int(axis2))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return apply("diff_op", x, n=int(n), axis=int(axis))


def inner(x, y, name=None):
    return apply("inner_op", x, y)


def outer(x, y, name=None):
    return apply("outer_op", x, y)


def lerp(x, y, weight, name=None):
    if not isinstance(weight, torch.Tensor):
        weight = torch.tensor(weight, dtype=x.dtype, device=x.device)
    return apply("lerp", x, y, weight)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply("rot90_op", x, k=int(k), axes=tuple(axes))


def combinations(x, r=2, with_replacement=False, name=None):
    n = x.shape[0]
    combos = (itertools.combinations_with_replacement(range(n), r)
              if with_replacement else itertools.combinations(range(n), r))
    idx = as_tensor(list(combos), device=x.device, dtype="int64")
    return x[idx]
