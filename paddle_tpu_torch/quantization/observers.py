"""Observers: watch activations or weights during calibration and produce
quantisation scales (counterpart of
``paddle_tpu/quantization/observers.py``).

An observer's forward returns its input.  Eagerly it records a statistic
read back on the host (one sync a forward); while a CUDA stream is
captured it records nothing, as the reference records nothing under a
trace: calibration runs eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.layer.layers import Layer

__all__ = ["BaseObserver", "AbsmaxObserver",
           "AbsMaxChannelWiseWeightObserver", "EMAObserver"]


def capturing(x: torch.Tensor) -> bool:
    """Whether x's stream is being captured into a CUDA graph (never for a
    CPU tensor)."""
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


class BaseObserver(Layer):
    """Calibration-time layer: passes x through while recording stats."""

    def __init__(self, quant_bits: int = 8) -> None:
        super().__init__()
        self._quant_bits = quant_bits

    def bit_length(self) -> int:
        return self._quant_bits

    def scales(self):
        raise NotImplementedError

    def quant_axis(self):
        return None

    def calibration_entry(self) -> dict:
        """This observer's stats as one ``paddle_tpu.numerics.
        calibration/1`` param entry (``quantize.calibration.
        from_observers``)."""
        from ..quantize import calibration as _calib
        return _calib.from_observers({"x": self})["params"]["x"]

    def load_calibration_entry(self, entry: dict) -> None:
        """Seed this observer from a calibration/1 entry (its absmax
        becomes the running max), so an offline dump drives convert()."""
        from ..quantize import calibration as _calib
        _calib.seed_observer(self, entry)

    def forward(self, x):
        if not capturing(x):
            with torch.no_grad():
                self._observe(x)
        return x


class AbsmaxObserver(BaseObserver):
    """Running max(|x|)."""

    def __init__(self, quant_bits: int = 8) -> None:
        super().__init__(quant_bits)
        self._max = 1e-7

    def _observe(self, x) -> None:
        self._max = max(self._max, float(x.abs().max()))

    def scales(self):
        return float(self._max)


class EMAObserver(BaseObserver):
    """Exponential moving average of abs-max (the reference's
    moving_average_abs_max observer)."""

    def __init__(self, quant_bits: int = 8, moving_rate: float = 0.9) -> None:
        super().__init__(quant_bits)
        self._rate = moving_rate
        self._state = None

    def _observe(self, x) -> None:
        cur = float(x.abs().max())
        self._state = cur if self._state is None else (
            self._rate * self._state + (1.0 - self._rate) * cur)

    def scales(self):
        return float(self._state if self._state is not None else 1e-7)


class AbsMaxChannelWiseWeightObserver(BaseObserver):
    """Per-channel |w| max along ``quant_axis`` (a host array)."""

    def __init__(self, quant_bits: int = 8, quant_axis: int = -1) -> None:
        super().__init__(quant_bits)
        self._quant_axis = quant_axis
        self._max = None

    def quant_axis(self):
        return self._quant_axis

    def _observe(self, x) -> None:
        axis = self._quant_axis % x.dim()
        dims = tuple(i for i in range(x.dim()) if i != axis)
        cur = x.abs().amax(dim=dims).float().cpu().numpy()
        self._max = cur if self._max is None else np.maximum(self._max, cur)

    def scales(self):
        return np.maximum(self._max, 1e-9)
