"""jacobian, hessian, jvp and vjp (counterpart of
``paddle_tpu/autograd/functional.py``), over ``torch.func`` as the
reference's are over ``jax.jacrev``/``hessian``/``jvp``/``vjp``: the same
argument conventions and result structures (one input: a tensor; several:
a tuple a input; a function with several outputs: a tuple a output)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.func as tf

__all__ = ["jacobian", "hessian", "jvp", "vjp"]


def _as_inputs(xs):
    """(inputs as a tuple, whether one tensor was given)."""
    if isinstance(xs, torch.Tensor):
        return (xs,), True
    return tuple(torch.as_tensor(x) for x in xs), False


def _pure(func: Callable):
    """``func`` with list outputs made tuples (torch.func's pytrees)."""
    def call(*xs):
        out = func(*xs)
        return tuple(out) if isinstance(out, list) else out
    return call


def jacobian(func: Callable, xs, create_graph: bool = False):
    """J[i, j] = d func(xs)[i] / d xs[j] (reverse mode)."""
    args, single = _as_inputs(xs)
    if single:
        return tf.jacrev(_pure(func))(*args)
    return tf.jacrev(_pure(func), argnums=tuple(range(len(args))))(*args)


def hessian(func: Callable, xs, create_graph: bool = False):
    """H[i, j] = d^2 func(xs) / d xs[i] d xs[j] (a scalar-output func)."""
    args, single = _as_inputs(xs)
    if single:
        return tf.hessian(_pure(func))(*args)
    return tf.hessian(_pure(func), argnums=tuple(range(len(args))))(*args)


def jvp(func: Callable, xs, v=None) -> Tuple:
    """Forward mode: (func(xs), J @ v), v ones where not given."""
    args, single = _as_inputs(xs)
    if v is None:
        tangents = tuple(torch.ones_like(a) for a in args)
    else:
        tangents, _ = _as_inputs(v)
    return tf.jvp(_pure(func), args, tangents)


def vjp(func: Callable, xs, v=None) -> Tuple:
    """Reverse mode: (func(xs), v^T @ J), v ones where not given."""
    args, single = _as_inputs(xs)
    out, pullback = tf.vjp(_pure(func), *args)
    if v is None:
        v = tuple(torch.ones_like(o) for o in out) \
            if isinstance(out, tuple) else torch.ones_like(out)
    elif not isinstance(v, torch.Tensor):
        v = tuple(v)
    grads = pullback(v)
    return out, grads[0] if single else grads
