"""``backward`` (counterpart of ``paddle_tpu/autograd/engine.py``).

The reference walks its own tape; here torch's engine runs the backward,
with the reference's argument semantics: one cotangent a tensor (None for
a one-element tensor, seeded with ones), ``retain_graph`` False by
default, gradients accumulated into ``.grad``.
"""

from __future__ import annotations

import torch

__all__ = ["backward"]


def _seed_for(t: torch.Tensor, g):
    if g is None:
        if t.numel() != 1:
            raise RuntimeError(
                "grad can be implicitly created only for scalar outputs; "
                f"got shape {tuple(t.shape)}")
        return torch.ones_like(t)
    return torch.as_tensor(g, dtype=t.dtype, device=t.device)


def backward(tensors, grad_tensors=None, retain_graph: bool = False) -> None:
    """Backpropagate from ``tensors`` into the leaves' ``.grad``."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif isinstance(grad_tensors, torch.Tensor) or \
            not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    if len(grad_tensors) != len(tensors):
        raise ValueError("grad_tensors must match tensors in length")
    seeds = [_seed_for(t, g) for t, g in zip(tensors, grad_tensors)]
    torch.autograd.backward(list(tensors), seeds,
                            retain_graph=bool(retain_graph))
