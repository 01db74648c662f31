"""RMSNorm layer (counterpart of ``paddle_tpu/nn/layer/norm.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import rms_norm

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(
            torch.ones(hidden_size, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.epsilon)
