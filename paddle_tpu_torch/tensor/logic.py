"""Comparison, logical and bitwise ops (counterpart of
``paddle_tpu/tensor/logic.py``, Paddle's ``python/paddle/tensor/logic.py``)."""

from __future__ import annotations

import torch

from ..ops.op import apply, register_many, register_op

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
    "bitwise_left_shift", "bitwise_right_shift",
    "is_empty", "allclose", "isclose", "equal_all", "is_tensor",
]

register_many("binary_bool", {
    "equal": torch.eq, "not_equal": torch.ne, "greater_than": torch.gt,
    "greater_equal": torch.ge, "less_than": torch.lt, "less_equal": torch.le,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
    "isclose_op": lambda x, y, rtol, atol, equal_nan: torch.isclose(
        x, y, rtol=rtol, atol=atol, equal_nan=equal_nan),
})
register_many("binary_broadcast", {
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "bitwise_left_shift": torch.bitwise_left_shift,
    "bitwise_right_shift": torch.bitwise_right_shift,
})
register_op("logical_not", torch.logical_not, "unary_bool")
register_op("bitwise_not", torch.bitwise_not, "unary")


def _binary(op_name):
    def fn(x, y, name=None):
        return apply(op_name, x, y)
    fn.__name__ = op_name
    return fn


equal = _binary("equal")
not_equal = _binary("not_equal")
greater_than = _binary("greater_than")
greater_equal = _binary("greater_equal")
less_than = _binary("less_than")
less_equal = _binary("less_equal")
logical_and = _binary("logical_and")
logical_or = _binary("logical_or")
logical_xor = _binary("logical_xor")
bitwise_and = _binary("bitwise_and")
bitwise_or = _binary("bitwise_or")
bitwise_xor = _binary("bitwise_xor")
bitwise_left_shift = _binary("bitwise_left_shift")
bitwise_right_shift = _binary("bitwise_right_shift")


def logical_not(x, out=None, name=None):
    return apply("logical_not", x)


def bitwise_not(x, out=None, name=None):
    return apply("bitwise_not", x)


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply("isclose_op", x, y, rtol=float(rtol), atol=float(atol),
                 equal_nan=bool(equal_nan))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return isclose(x, y, rtol, atol, equal_nan).all()


def equal_all(x, y, name=None):
    if tuple(x.shape) != tuple(y.shape):
        return torch.tensor(False, device=x.device)
    return equal(x, y).all()


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)
