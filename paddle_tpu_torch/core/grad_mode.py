"""Gradient-mode switches (counterpart of ``paddle_tpu/core/grad_mode.py``):
``no_grad``, ``enable_grad``, ``set_grad_enabled``, ``is_grad_enabled``.

The reference keeps its own thread-local flag for its tape; the port's
autograd is torch's, so these switch torch's grad mode (thread-local too)
and keep Paddle's calling forms: ``with no_grad():``, ``@no_grad`` and
``@no_grad()``; ``set_grad_enabled(False)`` applies at once and restores on
``__exit__``."""

from __future__ import annotations

import functools

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


class _GradMode:
    """Context manager and decorator."""

    def __init__(self, enabled: bool) -> None:
        self._enabled = enabled
        self._prev: list = []

    def __enter__(self):
        self._prev.append(torch.is_grad_enabled())
        torch.set_grad_enabled(self._enabled)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev.pop())
        return False

    def __call__(self, fn=None):
        if fn is None:
            return self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _GradMode(self._enabled):
                return fn(*args, **kwargs)

        return wrapper


def no_grad(func=None):
    """Usable as ``with no_grad():``, ``@no_grad`` or ``@no_grad()``."""
    mode = _GradMode(False)
    return mode(func) if func is not None else mode


def enable_grad(func=None):
    mode = _GradMode(True)
    return mode(func) if func is not None else mode


class set_grad_enabled(_GradMode):
    def __init__(self, mode: bool) -> None:
        super().__init__(bool(mode))
        # applies immediately, as Paddle's and torch's do
        self._prev.append(torch.is_grad_enabled())
        torch.set_grad_enabled(bool(mode))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev.pop())
        return False
