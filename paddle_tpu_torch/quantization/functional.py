"""Fake quant-dequant with the straight-through-estimator gradient
(counterpart of ``paddle_tpu/quantization/functional.py``).

The reference's op is one XLA fusion with a hand-written VJP, not a Pallas
kernel, so plain torch ops compute it here: ``round(x / s * qmax)``
clipped to ``[-qmax, qmax]``, times ``s / qmax``, with the gradient passed
through inside ``|x| <= s`` and zero outside.  A scale given as a number
stays a host float (float32-rounded, as the reference's array is): no
copy to the device.  Registered as the registry op ``fake_quant_dequant``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.op import apply, register_op

__all__ = ["fake_quant_dequant"]

_MIN_SCALE = float(np.float32(1e-9))


def _scale(x: torch.Tensor, scale, channel_axis):
    """The clamped scale: a float for a scalar number, else a float32
    tensor on x's device, shaped to broadcast along ``channel_axis``."""
    if not isinstance(scale, torch.Tensor) and np.ndim(scale) == 0:
        return max(float(np.float32(scale)), _MIN_SCALE)
    s = torch.as_tensor(np.asarray(scale, np.float32)
                        if not isinstance(scale, torch.Tensor) else scale,
                        dtype=torch.float32, device=x.device)
    if channel_axis is not None:
        shape = [1] * x.dim()
        shape[channel_axis] = -1
        s = s.reshape(shape)
    return s.clamp_min(_MIN_SCALE)


class _FakeQuantDequant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, qmax: float):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if isinstance(s, torch.Tensor):
            ctx.save_for_backward(xf, s)
        else:
            ctx.save_for_backward(xf)
            ctx.s = s
        q = torch.clamp(torch.round(xf / s * qmax), -qmax, qmax)
        return q * s / qmax

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        s = saved[1] if len(saved) > 1 else ctx.s
        inside = (saved[0].abs() <= s).to(grad.dtype)
        return grad * inside, None, None


def _fqd_op(x, scale, *, bit_length: int = 8, channel_axis=None):
    qmax = float(2 ** (bit_length - 1) - 1)
    return _FakeQuantDequant.apply(x, _scale(x, scale, channel_axis), qmax)


register_op("fake_quant_dequant", _fqd_op, "unary")


def fake_quant_dequant(x, scale, bit_length: int = 8,
                       channel_axis=None) -> torch.Tensor:
    """Simulated quantisation: ``round(x / s * qmax)`` clipped, then
    dequantised; ``scale`` a number, an array or a tensor (one a channel
    along ``channel_axis``)."""
    return apply("fake_quant_dequant", x, scale, bit_length=int(bit_length),
                 channel_axis=channel_axis)
