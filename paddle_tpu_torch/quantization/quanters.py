"""Fake quanters: QAT-time layers that fake-quantise with tracked scales
and the straight-through gradient (counterpart of
``paddle_tpu/quantization/quanters.py``).

Eagerly a forward reads its absmax back on the host (one sync) and keeps
its moving average as a Python float, as the reference does.  While a CUDA
stream is captured it takes the reference's tracer branch: the frozen
scale if there is one, else the absmax computed in the graph, and no
state changes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.layer.layers import Layer
from .functional import fake_quant_dequant
from .observers import capturing

__all__ = ["FakeQuanterWithAbsMaxObserver", "FakeQuanterChannelWiseAbsMax"]


class FakeQuanterWithAbsMaxObserver(Layer):
    """Moving-average abs-max fake quant (per tensor)."""

    def __init__(self, quant_bits: int = 8, moving_rate: float = 0.9,
                 name=None) -> None:
        super().__init__()
        self._quant_bits = quant_bits
        self._rate = moving_rate
        self._scale = None

    def bit_length(self) -> int:
        return self._quant_bits

    def quant_axis(self):
        return None

    def scales(self):
        return float(self._scale if self._scale is not None else 1e-7)

    def forward(self, x):
        if capturing(x):
            scale = self._scale if self._scale is not None else \
                x.detach().abs().amax()
            return fake_quant_dequant(x, scale, self._quant_bits)
        cur = float(x.detach().abs().max())  # eager: one host sync
        if self.training:
            self._scale = cur if self._scale is None else (
                self._rate * self._scale + (1.0 - self._rate) * cur)
        scale = self._scale if self._scale is not None else cur
        return fake_quant_dequant(x, scale, self._quant_bits)


class FakeQuanterChannelWiseAbsMax(Layer):
    """Per-channel weight fake quant along ``quant_axis``."""

    def __init__(self, quant_bits: int = 8, quant_axis: int = -1,
                 name=None) -> None:
        super().__init__()
        self._quant_bits = quant_bits
        self._quant_axis = quant_axis
        self._last_scales = None

    def bit_length(self) -> int:
        return self._quant_bits

    def quant_axis(self):
        return self._quant_axis

    def scales(self):
        if self._last_scales is None:
            return np.asarray([1e-7], np.float32)
        return self._last_scales

    def forward(self, x):
        axis = self._quant_axis % x.dim()
        dims = tuple(i for i in range(x.dim()) if i != axis)
        scales = x.detach().abs().amax(dim=dims)
        if not capturing(x):
            self._last_scales = scales.float().cpu().numpy()
        return fake_quant_dequant(x, scales, self._quant_bits,
                                  channel_axis=axis)
