"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``):
each a ``Layer`` over its functional, with the reference's defaults."""

from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "SiLU", "Silu", "Softmax2D", "Swish",
           "Sigmoid", "Tanh", "Softmax", "LogSoftmax", "LeakyReLU", "ELU",
           "SELU", "CELU", "Hardswish", "Hardsigmoid", "Hardtanh", "PReLU",
           "Mish", "Softplus", "Softshrink", "Hardshrink", "Tanhshrink",
           "Softsign", "ThresholdedReLU", "LogSigmoid", "GLU", "Maxout",
           "RReLU"]


def _simple(name, fn):
    def __init__(self, name=None):
        Layer.__init__(self)

    def forward(self, x):
        return fn(x)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


ReLU = _simple("ReLU", F.relu)
ReLU6 = _simple("ReLU6", F.relu6)
SiLU = _simple("SiLU", F.silu)
Silu = SiLU
Swish = _simple("Swish", F.swish)
Sigmoid = _simple("Sigmoid", F.sigmoid)
Tanh = _simple("Tanh", F.tanh)
Mish = _simple("Mish", F.mish)
Softsign = _simple("Softsign", F.softsign)
Tanhshrink = _simple("Tanhshrink", F.tanhshrink)
LogSigmoid = _simple("LogSigmoid", F.log_sigmoid)
Hardswish = _simple("Hardswish", F.hardswish)
Hardsigmoid = _simple("Hardsigmoid", F.hardsigmoid)


class GELU(Layer):
    def __init__(self, approximate=False, name=None) -> None:
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None) -> None:
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None) -> None:
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)


class Softmax2D(Layer):
    """Softmax over the channel axis of (C, H, W) or (N, C, H, W)."""

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError(f"Softmax2D expects 3-D/4-D input, got rank "
                             f"{x.dim()}")
        return F.softmax(x, axis=-3)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None) -> None:
        super().__init__()
        self._negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None) -> None:
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None) -> None:
        super().__init__()
        self._scale, self._alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self._scale, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None) -> None:
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None) -> None:
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, dtype=None, device=None,
                 generator=None) -> None:
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_parameters], attr=weight_attr, dtype=dtype,
            default_initializer=Constant(init), device=device,
            generator=generator)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Softplus(Layer):
    def __init__(self, beta=1, threshold=20, name=None) -> None:
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None) -> None:
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None) -> None:
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None) -> None:
        super().__init__()
        self._threshold, self._value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold, self._value)


class GLU(Layer):
    def __init__(self, axis=-1, name=None) -> None:
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.glu(x, self._axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None) -> None:
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None) -> None:
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)
