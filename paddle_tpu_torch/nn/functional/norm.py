"""Normalisation (counterpart of ``paddle_tpu/nn/functional/norm.py``)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["rms_norm"]


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             epsilon: float = 1e-5) -> torch.Tensor:
    """RMS over the last axis, accumulated in at least f32.  The normalised
    value is cast back to the input dtype BEFORE the weight multiply, as
    the reference does (``norm.py`` ``_rms_fwd``)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    return y
