"""Tensor-parallel layers at one device (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``):
``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear`` and ``ParallelCrossEntropy``.

With one device (the reference's mp_degree 1) each is the plain layer:
weights are full, ``gather_output`` and ``input_is_parallel`` change
nothing, and the weights start XavierNormal, as the reference's do
(where ``nn.Linear`` and ``nn.Embedding`` start XavierUniform).  The
Llama builds on these, so its parameter names, shapes and initial
distributions are the reference's.  The sharding over a mesh comes with
ROADMAP item A7.  Each takes the port's keyword-only ``dtype``,
``device`` and ``generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ....nn import functional as F
from ....nn.initializer import XavierNormal
from ....nn.layer.layers import Layer

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, *, dtype=None,
                 device=None, generator: Optional[torch.Generator] = None
                 ) -> None:
        super().__init__(dtype=dtype)
        self.world_size = 1
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierNormal(), device=device,
            generator=generator)

    def forward(self, x):
        return F.embedding(x, self.weight)


class ColumnParallelLinear(Layer):
    """Weight (in, out); at one device ``gather_output`` has nothing to
    gather."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None, *,
                 dtype=None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(dtype=dtype)
        self.world_size = 1
        self.gather_output = gather_output
        self._out_features = out_features
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=XavierNormal(), **kw)
        self.bias = self.create_parameter(
            shape=[out_features], is_bias=True, **kw) if has_bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(Layer):
    """Weight (in, out); at one device the input is whole whether or not
    ``input_is_parallel``, and there is no partial sum to reduce."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None, *,
                 dtype=None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(dtype=dtype)
        self.world_size = 1
        self.input_is_parallel = input_is_parallel
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=XavierNormal(), **kw)
        self.bias = self.create_parameter(
            shape=[out_features], is_bias=True, **kw) if has_bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class ParallelCrossEntropy(Layer):
    """Softmax cross entropy over the (whole) vocabulary: per-position
    loss with the class axis kept, as the reference's."""

    def __init__(self, mp_group=None, name=None,
                 ignore_index: int = -100) -> None:
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.softmax_with_cross_entropy(input, label,
                                            ignore_index=self.ignore_index)
