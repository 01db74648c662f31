"""Op registry and eager dispatch (counterpart of
``paddle_tpu/ops/op.py``).

An op is a torch function over tensors (plus static attributes given as
keywords) registered under the reference's name, with the reference's
infermeta rule.  :func:`apply` checks the call's shapes with that rule
(``set_check_shapes``), then runs the function.  Autograd is torch's: the
reference's ``GradNode`` tape, hand-written VJP rules, jit cache, XLA
trace hooks and capture sink have no counterpart, since torch records the
backward of every function here as it runs.

The calling convention is the reference's: tensor-like inputs (float data,
integer index tensors, boolean masks, optional None) positional, every
static attribute a keyword.  The registry holds exactly the reference's
``paddle_tpu/tensor/*`` ops, under the same names, so that a test can walk
both registries side by side.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from ..flags import get_flags, on_flag_set
from .infermeta import INFER_RULES, Meta, ShapeError

__all__ = ["OpDef", "register_op", "get_op", "all_ops", "apply", "apply_op",
           "set_check_shapes"]

_REGISTRY: Dict[str, "OpDef"] = {}


class OpDef:
    """One operator: its torch function and its infermeta rule."""

    __slots__ = ("name", "fwd", "infer_meta", "infer_category")

    def __init__(self, name: str, fwd: Callable, infer: str = "opaque"
                 ) -> None:
        self.name = name
        self.fwd = fwd
        self.infer_meta = INFER_RULES[infer]
        self.infer_category = infer


def register_op(name: str, fwd: Callable, infer: str = "opaque") -> OpDef:
    """Register ``fwd`` as op ``name`` with infermeta rule ``infer`` (a key
    of ``infermeta.INFER_RULES``)."""
    if name in _REGISTRY:
        raise ValueError(f"op '{name}' already registered")
    op = OpDef(name, fwd, infer)
    _REGISTRY[name] = op
    return op


def get_op(name: str) -> OpDef:
    return _REGISTRY[name]


def all_ops() -> List[str]:
    return sorted(_REGISTRY)


# op-level shape checking before the op runs (the reference's infermeta
# before every kernel); set_check_shapes(False) skips it
_check_shapes = True


def set_check_shapes(on: bool) -> None:
    global _check_shapes
    _check_shapes = bool(on)


set_check_shapes(get_flags("check_shapes"))
on_flag_set("check_shapes", set_check_shapes)


# (op, attrs, input shapes and dtypes) that already passed their rule: the
# rules are pure, so a repeated signature skips them
_meta_ok_cache: Dict[Tuple, bool] = {}


def _run_infer_meta(op: OpDef, args, kwargs) -> None:
    try:
        sig = (op.name, tuple(sorted(kwargs.items())),
               tuple((tuple(a.shape), a.dtype)
                     if isinstance(a, torch.Tensor) else None for a in args))
        if sig in _meta_ok_cache:
            return
    except TypeError:
        sig = None  # unhashable attr: run the rule directly
    metas = [Meta(tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
             else None for a in args]
    if metas and metas[0] is not None:
        try:
            op.infer_meta(op.name, metas, kwargs)
        except ShapeError:
            raise
        except Exception:  # noqa: BLE001 — advisory check only
            # an argument structure the rule cannot judge: let the torch
            # function report what is truly wrong
            pass
        if sig is not None:
            if len(_meta_ok_cache) > 16384:
                _meta_ok_cache.clear()
            _meta_ok_cache[sig] = True


# the numerics monitor's probe (amp/debugging.py, FLAGS_check_numerics),
# called as NUMERICS_HOOK(op name, args, output) after each op; None when
# disarmed (one attribute check a call)
NUMERICS_HOOK = None


def apply_op(op: OpDef, *args, **kwargs) -> Any:
    """Run ``op`` on ``args`` (tensors, Python scalars or None) with its
    static attributes ``kwargs``; torch records the backward."""
    if _check_shapes:
        _run_infer_meta(op, args, kwargs)
    out = op.fwd(*args, **kwargs)
    hook = NUMERICS_HOOK
    if hook is not None:
        hook(op.name, args, out)
    return out


def apply(name: str, *args, **kwargs) -> Any:
    return apply_op(_REGISTRY[name], *args, **kwargs)


def register_many(infer: str, table: Dict[str, Callable]) -> None:
    """Register each ``name: fn`` of ``table`` with rule ``infer``."""
    for name, fn in table.items():
        register_op(name, fn, infer)
