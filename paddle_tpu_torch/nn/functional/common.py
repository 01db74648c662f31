"""Linear and embedding (counterpart of
``paddle_tpu/nn/functional/common.py``).

Weights keep Paddle's ``(in, out)`` layout: ``linear`` is ``x @ W + b``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["linear", "embedding"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.embedding(ids, weight)
