"""Quantisation-aware Linear and its converted inference form
(counterpart of ``paddle_tpu/quantization/qat_layers.py``; the Conv2D
pair comes with the port's convolution layers).
"""

from __future__ import annotations

import torch

from ..nn import functional as F
from ..nn.layer.layers import Layer
from .functional import fake_quant_dequant
from .observers import BaseObserver

__all__ = ["QuantedLinear", "ConvertedLinear"]


class QuantedLinear(Layer):
    """A Linear whose input and weight pass their quanters first; the
    weight and bias are the source layer's parameters."""

    def __init__(self, source, q_config) -> None:
        super().__init__()
        self.weight = source.weight
        self.bias = source.bias
        self.activation_quanter = q_config.activation_quanter_for(source)
        self.weight_quanter = q_config.weight_quanter_for(source)

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        return F.linear(x, w, self.bias)


@torch.no_grad()
def _bake_weight(weight, wq) -> torch.Tensor:
    """The weight with a quanter's or observer's quantisation baked in:
    a fake quanter returns the quantised weight; an observer (identity
    forward) observes the weight, then its scales quantise it."""
    if isinstance(wq, BaseObserver):
        wq(weight)
        baked = fake_quant_dequant(weight, wq.scales(), wq.bit_length(),
                                   channel_axis=wq.quant_axis())
    else:
        baked = wq(weight)
    return baked.detach()


class ConvertedLinear(Layer):
    """The inference form after ``convert()``: the weight baked (a buffer,
    no gradient) and the activation scale frozen."""

    def __init__(self, quanted: QuantedLinear) -> None:
        super().__init__()
        aq = quanted.activation_quanter
        wq = quanted.weight_quanter
        if wq is not None:
            self.register_buffer("weight", _bake_weight(quanted.weight, wq))
        else:
            self.weight = quanted.weight
        self.bias = quanted.bias
        self._act_scale = aq.scales() if aq is not None else None
        self._act_bits = aq.bit_length() if aq is not None else 8

    def forward(self, x):
        if self._act_scale is not None:
            x = fake_quant_dequant(x, self._act_scale, self._act_bits)
        return F.linear(x, self.weight, self.bias)
