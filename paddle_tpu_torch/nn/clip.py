"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``:
ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm).

A clip takes and returns ``(param, grad)`` pairs, as ``Optimizer.step``
hands them over.  Norms are taken in f32 and the scale stays on the
device (no host sync).  A parameter with ``need_clip = False`` keeps its
gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


def _clipped(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


def _scale_of(norm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """min(clip_norm / max(norm, 1e-12), 1)."""
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max: float, min: Optional[float] = None) -> None:
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _dygraph_clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p, g)
                 else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm: float) -> None:
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                gf = g.float()
                scale = _scale_of(gf.square().sum().sqrt(), self.clip_norm)
                g = (gf * scale).to(g.dtype)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All clipped gradients scaled together so that their joint L2 norm
    is at most ``clip_norm``."""

    def __init__(self, clip_norm: float, group_name: str = "default_group",
                 auto_skip_clip: bool = False) -> None:
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _dygraph_clip(self, params_grads):
        sq = [g.float().square().sum() for p, g in params_grads
              if _clipped(p, g)]
        if not sq:
            return params_grads
        scale = _scale_of(torch.stack(sq).sum().sqrt(), self.clip_norm)
        return [(p, (g.float() * scale).to(g.dtype) if _clipped(p, g)
                 else g) for p, g in params_grads]
