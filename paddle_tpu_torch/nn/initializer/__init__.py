"""Initializers (counterpart of ``paddle_tpu/nn/initializer/__init__.py``).

Each initializer makes a tensor of a shape and dtype (:meth:`make`, the
reference's ``init_array``) or fills a parameter in place (``__call__``).
Random draws come from an explicit ``torch.Generator`` (by default the
global one of the target device, ``core/random_state.generator``), in
float32 on the target device (float64 stays float64), then cast: never
compare the draws with JAX's, only their bounds and moments.
``ParamAttr`` carries an initializer into ``Layer.create_parameter``, as
the reference's param_attr plumbing does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...core import random_state
from ...core.dtype import to_torch_dtype

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "Bilinear", "ParamAttr", "calculate_gain",
    "set_global_initializer",
]


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape),
                       dtype=_compute_dtype(dtype), device=device)


def _gen(device, generator):
    return generator if generator is not None else \
        random_state.generator(device)


class Initializer:
    def make(self, shape, dtype=torch.float32, device="cpu",
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A new tensor of ``shape`` and ``dtype`` on ``device``."""
        raise NotImplementedError

    def __call__(self, param, block=None):
        with torch.no_grad():
            param.copy_(self.make(param.shape, param.dtype, param.device))
        return param


class Constant(Initializer):
    def __init__(self, value: float = 0.0) -> None:
        self.value = float(value)

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        return torch.full(tuple(int(s) for s in shape), self.value,
                          dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0, name=None) -> None:
        self.mean = float(mean)
        self.std = float(std)

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        w = _empty(shape, dtype, device)
        return w.normal_(self.mean, self.std,
                         generator=_gen(device, generator)).to(dtype)


class TruncatedNormal(Initializer):
    """``mean + std * z`` with ``z`` a standard normal truncated to
    ``[a, b]`` (the bounds are in units of the standard normal, as in the
    reference)."""

    def __init__(self, mean: float = 0.0, std: float = 1.0, a: float = -2.0,
                 b: float = 2.0, name=None) -> None:
        self.mean, self.std, self.a, self.b = map(float, (mean, std, a, b))

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        # inverse-CDF sampling: u uniform on [Phi(a), Phi(b)]
        lo = 0.5 * (1.0 + math.erf(self.a / math.sqrt(2.0)))
        hi = 0.5 * (1.0 + math.erf(self.b / math.sqrt(2.0)))
        u = _empty(shape, dtype, device).uniform_(
            2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=_gen(device, generator))
        z = torch.erfinv(u) * math.sqrt(2.0)
        z = z.clamp_(self.a, self.b)
        return (self.mean + self.std * z).to(dtype)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, name=None) -> None:
        self.low, self.high = float(low), float(high)

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        w = _empty(shape, dtype, device)
        return w.uniform_(self.low, self.high,
                          generator=_gen(device, generator)).to(dtype)


def _fans(shape):
    """(fan_in, fan_out) by the reference's rule: a 2-D weight is Paddle's
    ``(in, out)``; a conv weight ``(out, in, *kernel)`` counts its
    receptive field."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None) -> None:
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, float(gain)

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std).make(shape, dtype, device, generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None) -> None:
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, float(gain)

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit).make(shape, dtype, device, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None) -> None:
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        fi = self._fan_in if self._fan_in is not None else _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi)).make(shape, dtype, device,
                                                      generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None) -> None:
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        fi = self._fan_in if self._fan_in is not None else _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit).make(shape, dtype, device, generator)


class Assign(Initializer):
    def __init__(self, value, name=None) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        self.value = np.asarray(value)

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        return torch.as_tensor(self.value).to(device=device, dtype=dtype) \
            .reshape(tuple(int(s) for s in shape))


class Orthogonal(Initializer):
    def __init__(self, gain: float = 1.0, name=None) -> None:
        self.gain = float(gain)

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        shape = tuple(int(s) for s in shape)
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = torch.empty(max(rows, cols), min(rows, cols),
                           dtype=torch.float32, device=device)
        flat.normal_(0.0, 1.0, generator=_gen(device, generator))
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Dirac(Initializer):
    def __init__(self, groups: int = 1, name=None) -> None:
        self.groups = groups

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        shape = tuple(int(s) for s in shape)
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        per = oc // self.groups
        for g in range(self.groups):
            for i in range(min(per, ic)):
                out[(g * per + i, i) + centers] = 1.0
        return torch.from_numpy(out).to(device=device, dtype=dtype)


class Bilinear(Initializer):
    """Bilinear upsampling kernel for conv-transpose weights (a 4-D
    weight)."""

    def make(self, shape, dtype=torch.float32, device="cpu", generator=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        w = np.zeros(shape, np.float32)
        for i in range(int(np.prod(shape[2:]))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            w[:, :, y, x] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(w).to(device=device, dtype=dtype)


def calculate_gain(nonlinearity: str, param=None) -> float:
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d",
                        "conv_transpose1d", "conv_transpose2d",
                        "conv_transpose3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    raise ValueError(f"unknown nonlinearity {nonlinearity}")


class ParamAttr:
    """Paddle's ``ParamAttr``: what ``create_parameter`` puts on the
    parameter it makes (``name``, ``trainable``, ``learning_rate`` in
    ``optimize_attr``, ``regularizer``, ``need_clip``)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True) -> None:
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


_global_weight_init: Optional[Initializer] = None
_global_bias_init: Optional[Initializer] = None


def set_global_initializer(weight_init, bias_init=None) -> None:
    """Stores the pair, as the reference does; like the reference's,
    ``create_parameter`` does not read it."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def resolve_param_attr(attr) -> Optional[ParamAttr]:
    if attr is None or attr is True:
        return ParamAttr()
    if attr is False:
        return None
    if isinstance(attr, ParamAttr):
        return attr
    if isinstance(attr, str):
        return ParamAttr(name=attr)
    if isinstance(attr, Initializer):
        return ParamAttr(initializer=attr)
    raise TypeError(f"cannot interpret param attr {attr!r}")


def apply_initializer(init, shape, dtype, device, generator=None
                      ) -> torch.Tensor:
    """``init`` (an :class:`Initializer` or a callable ``(shape, dtype)``)
    as a tensor of ``shape`` and ``dtype`` on ``device``."""
    dtype = to_torch_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    if isinstance(init, Initializer):
        return init.make(shape, dtype, device, generator)
    if callable(init):
        out = init(shape, dtype)
        return torch.as_tensor(out).to(device=device, dtype=dtype)
    raise TypeError(f"bad initializer {init!r}")
