"""Linear and Embedding layers (counterpart of
``paddle_tpu/nn/layer/common.py``, and the single-device form of
``distributed/fleet/meta_parallel/mp_layers.py``).

Weights keep Paddle's ``(in, out)`` layout, so parameter names and shapes
carry across from the reference 1:1 with no transposes.  Weights start
XavierNormal, as the reference's parallel layers do (``mp_layers.py:113,
136,168``): std = sqrt(2 / (fan_in + fan_out)) with Paddle's fans of a 2-D
weight, ``(shape[0], shape[1])``.  They are drawn in f32 directly on the
target device from the caller's ``torch.Generator`` and then cast.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..functional import common as F

__all__ = ["Linear", "Embedding", "xavier_normal"]


def xavier_normal(shape: Sequence[int], dtype: torch.dtype,
                  device: torch.device,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    std = math.sqrt(2.0 / (shape[0] + shape[1]))
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    w.normal_(0.0, std, generator=generator)
    return w.to(dtype)


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None, generator: Optional[torch.Generator] = None
                 ) -> None:
        super().__init__()
        self.weight = nn.Parameter(xavier_normal(
            (in_features, out_features), dtype, device, generator))
        self.bias = None
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                                 device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.weight = nn.Parameter(xavier_normal(
            (num_embeddings, embedding_dim), dtype, device, generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)
