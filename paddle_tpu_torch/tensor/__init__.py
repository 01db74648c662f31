"""The op surface (counterpart of ``paddle_tpu/tensor/__init__.py``):
every domain module's functions, their module-level in-place variants
(``abs_``, ``cos_``, ...) and the reference's aliases.

Plain ``torch.Tensor`` is the tensor type, so nothing is patched onto it:
torch's own methods and operators serve (the reference patches its
functions onto its Tensor class instead)."""

from __future__ import annotations

import torch

from . import (attribute, creation, einsum_mod, extension,  # noqa: F401
               linalg, logic, manipulation, math, random, search, stat)
from .attribute import (einsum, imag, is_complex, is_floating_point,  # noqa: F401
                        is_integer, rank, real)
from .creation import *  # noqa: F401,F403
from .extension import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403

_SOURCES = [math, manipulation, linalg, logic, search, stat, creation,
            random, attribute, extension]

# module-level in-place variants (the reference exports abs_, cos_, ...):
# the out-of-place function, its result written back into x
_INPLACE_NAMES = [
    "abs", "acos", "acosh", "asin", "asinh", "atan", "atanh", "ceil",
    "cos", "cosh", "cumsum", "cumprod", "digamma", "divide", "equal",
    "erf", "erfinv", "exp", "expm1", "floor", "floor_divide", "gcd",
    "greater_equal", "greater_than", "hypot", "lcm", "ldexp",
    "less_equal", "less_than", "lgamma", "log", "log10", "log1p", "log2",
    "logical_and", "logical_not", "logical_or", "logical_xor", "logit",
    "masked_fill", "masked_scatter", "multiply", "nan_to_num", "neg",
    "pow", "reciprocal", "remainder", "round", "rsqrt", "sigmoid", "sin",
    "sinh", "sqrt", "square", "subtract", "tan", "tanh", "tril", "triu",
    "trunc", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "cast", "clip", "scale", "index_add", "index_put", "transpose", "frac",
    "add",
]


def _find_fn(name):
    for mod in _SOURCES:
        fn = getattr(mod, name, None)
        if callable(fn):
            return fn
    return None


def _write_back(x, out):
    """``x`` takes ``out``'s values (and shape and dtype, where they
    differ)."""
    out = out.detach().clone()      # it may share x's memory (t_)
    with torch.no_grad():
        if out.shape == x.shape and out.dtype == x.dtype:
            x.copy_(out)
        else:
            x.set_(out)
    return x


def _module_inplace(fn, name):
    def run(x, *args, **kwargs):
        return _write_back(x, fn(x, *args, **kwargs))
    run.__name__ = name
    run.__doc__ = f"In-place variant of ``{fn.__name__}``."
    return run


_g = globals()
for _base in _INPLACE_NAMES:
    _fn = _find_fn(_base)
    if _fn is not None and _base + "_" not in _g:
        _g[_base + "_"] = _module_inplace(_fn, _base + "_")

# aliases the reference exports under other names
mod = math.remainder
mod_ = _g["remainder_"]
floor_mod = mod
floor_mod_ = mod_
reverse = manipulation.flip


def t_(x, name=None):
    """In-place 2-D transpose."""
    return _write_back(x, linalg.t(x))


def where_(condition, x, y, name=None):
    """In-place where: the selection written into ``x``."""
    return _write_back(x, search.where(condition, x, y))


def tolist(x):
    return x.tolist()


def shape(input):
    """The runtime shape as an int64 tensor (paddle.shape)."""
    return torch.tensor(tuple(input.shape), dtype=torch.int64,
                        device=input.device)


__all__ = sorted(
    {n for m in _SOURCES for n in m.__all__}
    | {b + "_" for b in _INPLACE_NAMES if _find_fn(b) is not None}
    | {"mod", "mod_", "floor_mod", "floor_mod_", "reverse", "t_", "where_",
       "tolist", "shape"})
