"""``grad`` (counterpart of ``paddle_tpu/autograd/backward_api.py``):
gradients of ``outputs`` with respect to ``inputs``, returned and not
accumulated into ``.grad``.  Paddle's defaults: ``retain_graph`` follows
``create_graph``; an input that gets no gradient raises unless
``allow_unused``."""

from __future__ import annotations

import torch

from .engine import _seed_for

__all__ = ["grad"]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    if isinstance(outputs, torch.Tensor):
        outputs = [outputs]
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif isinstance(grad_outputs, torch.Tensor):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = create_graph
    seeds = [_seed_for(t, g) for t, g in zip(outputs, grad_outputs)]
    results = torch.autograd.grad(
        list(outputs), list(inputs), seeds, retain_graph=bool(retain_graph),
        create_graph=bool(create_graph), allow_unused=True)
    if not allow_unused and any(g is None for g in results):
        raise RuntimeError(
            "one of the input tensors received no gradient; pass "
            "allow_unused=True to get None instead")
    return list(results)
