"""Attribute ops and einsum (counterpart of
``paddle_tpu/tensor/attribute.py``, Paddle's
``python/paddle/tensor/{attribute,einsum}.py``)."""

from __future__ import annotations

import torch

from ..ops.op import apply, register_op

__all__ = ["shape", "rank", "is_complex", "is_integer", "is_floating_point",
           "imag", "real", "einsum"]

register_op("einsum_op", lambda *ops, equation: torch.einsum(equation, *ops))


def shape(input):
    return torch.tensor(tuple(input.shape), dtype=torch.int32,
                        device=input.device)


def rank(input):
    return torch.tensor(input.dim(), dtype=torch.int32, device=input.device)


def is_complex(x) -> bool:
    return x.is_complex()


def is_integer(x) -> bool:
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def is_floating_point(x) -> bool:
    return x.is_floating_point()


def real(x, name=None):
    return apply("real_op", x)


def imag(x, name=None):
    return apply("imag_op", x)


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply("einsum_op", *operands, equation=equation)
