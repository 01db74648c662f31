"""PyLayer: a user-defined forward and backward (counterpart of
``paddle_tpu/autograd/py_layer.py``), as a ``torch.autograd.Function``.

Paddle's surface over torch's: ``PyLayerContext`` with
``save_for_backward`` / ``saved_tensor``, ``mark_non_differentiable`` and
``set_materialize_grads`` (True by default: a missing output gradient
reaches ``backward`` as zeros); ``forward(ctx, *args, **kwargs)`` runs
without grad; ``backward(ctx, *grads)`` returns one gradient a tensor
input (None for none); several outputs come back as a list, as in the
reference.  An output that is not a tensor passes through and gets no
gradient.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["PyLayer", "PyLayerContext"]


class PyLayerContext:
    def __init__(self) -> None:
        self._saved = ()
        self._fn_ctx = None
        self.materialize_grads = True
        self._non_differentiable = ()

    def save_for_backward(self, *tensors) -> None:
        self._saved = tensors

    @property
    def saved_tensor(self):
        # torch's context is set only while backward runs, so that the
        # two contexts hold no cycle that keeps the saved tensors alive
        ctx = self._fn_ctx
        if ctx is not None and ctx._via_torch:
            return ctx.saved_tensors
        return self._saved

    saved_tensors = saved_tensor

    def mark_non_differentiable(self, *tensors) -> None:
        self._non_differentiable = tensors

    def set_materialize_grads(self, value: bool) -> None:
        self.materialize_grads = bool(value)


def _function(cls) -> type:
    """The torch Function of a PyLayer subclass (made once)."""
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(fctx, kwargs: Dict, *args):
            ctx = PyLayerContext()
            fctx.pyctx = ctx
            fctx.tensor_args = [isinstance(a, torch.Tensor) for a in args]
            outs = cls.forward(ctx, *args, **kwargs)
            saved = ctx._saved
            # torch's saved-tensor machinery (version checks, hooks) where
            # everything saved is a tensor
            fctx._via_torch = all(s is None or isinstance(s, torch.Tensor)
                                  for s in saved)
            if fctx._via_torch:
                fctx.save_for_backward(*saved)
                # torch holds them now (and frees them after backward)
                ctx._saved = ()
            if ctx._non_differentiable:
                fctx.mark_non_differentiable(*ctx._non_differentiable)
            fctx.set_materialize_grads(ctx.materialize_grads)
            return outs

        @staticmethod
        def backward(fctx, *grads):
            ctx = fctx.pyctx
            ctx._fn_ctx = fctx
            try:
                result = cls.backward(ctx, *grads)
            finally:
                ctx._fn_ctx = None
            if not isinstance(result, (tuple, list)):
                result = (result,)
            result = iter(result)
            return (None,) + tuple(next(result, None) if is_t else None
                                   for is_t in fctx.tensor_args)

    _Fn.__name__ = f"{cls.__name__}Function"
    cls._torch_function = _Fn
    return _Fn


class PyLayer:
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        outs = _function(cls).apply(kwargs, *args)
        return list(outs) if isinstance(outs, tuple) else outs
