"""Activations (counterpart of ``paddle_tpu/nn/functional/activation.py``).

Each registry op (``relu``, ``gelu_op``, ``softmax_op``, ...) is a torch
function under the reference's name and attributes; the public functions
keep Paddle's signatures and constants (``hardsigmoid``'s slope
0.1666667, ``selu``'s scale and alpha).  Autograd is torch's.  The
reference computes all of these with XLA, so none is a hand-written
kernel here either.  ``gumbel_softmax`` and ``rrelu`` draw from the
generator of the input's device (``core/random_state``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core import random_state
from ...ops.op import apply, register_many, register_op

__all__ = ["elu_", "hardtanh_", "leaky_relu_", "relu_", "softmax_", "tanh_",
           "thresholded_relu_",
           "relu", "relu6", "gelu", "silu", "swish", "sigmoid", "tanh",
           "softmax", "log_softmax", "leaky_relu", "elu", "selu", "celu",
           "hardswish", "hardsigmoid", "hardtanh", "prelu", "mish",
           "softplus", "softshrink", "hardshrink", "tanhshrink", "softsign",
           "thresholded_relu", "log_sigmoid", "glu", "gumbel_softmax",
           "maxout", "rrelu"]


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


register_many("unary", {
    "relu": torch.relu,
    "gelu_op": lambda x, approximate: TF.gelu(
        x, approximate="tanh" if approximate else "none"),
    "silu": TF.silu,
    "leaky_relu_op": lambda x, negative_slope: torch.where(
        x >= 0, x, negative_slope * x),
    "elu_op": lambda x, alpha: torch.where(x > 0, x, alpha * torch.expm1(x)),
    "selu_op": lambda x, scale, alpha: scale * torch.where(
        x > 0, x, alpha * torch.expm1(x)),
    "celu_op": lambda x, alpha: torch.where(
        x > 0, x, alpha * torch.expm1(x / alpha)),
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "hardswish": lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
    "hardsigmoid_op": lambda x, slope, offset: torch.clamp(
        slope * x + offset, 0.0, 1.0),
    "hardtanh_op": lambda x, mn, mx: torch.clamp(x, mn, mx),
    "mish": lambda x: x * torch.tanh(_softplus(x)),
    "softsign": lambda x: x / (1 + x.abs()),
    "log_sigmoid": lambda x: -_softplus(-x),
    "tanhshrink": lambda x: x - torch.tanh(x),
    "softshrink_op": lambda x, threshold: torch.where(
        x > threshold, x - threshold, torch.where(
            x < -threshold, x + threshold, torch.zeros_like(x))),
    "hardshrink_op": lambda x, threshold: torch.where(
        x.abs() > threshold, x, torch.zeros_like(x)),
    "thresholded_relu_op": lambda x, threshold, value: torch.where(
        x > threshold, x, torch.full_like(x, value)),
})
register_op("prelu_op", lambda x, weight: torch.where(x >= 0, x, weight * x),
            "norm_layer")
register_many("softmax_like", {
    "softmax_op": lambda x, axis: torch.softmax(x, axis),
    "log_softmax_op": lambda x, axis: torch.log_softmax(x, axis),
})


def relu(x, name=None):
    return apply("relu", x)


def relu6(x, name=None):
    return apply("relu6", x)


def gelu(x, approximate=False, name=None):
    return apply("gelu_op", x, approximate=bool(approximate))


def silu(x, name=None):
    return apply("silu", x)


swish = silu


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        from ...core.dtype import to_torch_dtype
        x = x.to(to_torch_dtype(dtype))
    return apply("softmax_op", x, axis=int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        from ...core.dtype import to_torch_dtype
        x = x.to(to_torch_dtype(dtype))
    return apply("log_softmax_op", x, axis=int(axis))


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply("leaky_relu_op", x, negative_slope=float(negative_slope))


def elu(x, alpha=1.0, name=None):
    return apply("elu_op", x, alpha=float(alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply("selu_op", x, scale=float(scale), alpha=float(alpha))


def celu(x, alpha=1.0, name=None):
    return apply("celu_op", x, alpha=float(alpha))


def hardswish(x, name=None):
    return apply("hardswish", x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply("hardsigmoid_op", x, slope=float(slope),
                 offset=float(offset))


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply("hardtanh_op", x, mn=float(min), mx=float(max))


def prelu(x, weight, data_format="NCHW", name=None):
    """``weight`` of one element, or one a channel (axis 1 for "NC..."
    layouts, the last axis otherwise)."""
    w = weight
    if w.numel() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format.startswith("NC") else x.dim() - 1] = \
            w.numel()
        w = w.reshape(shape)
    return apply("prelu_op", x, w)


def mish(x, name=None):
    return apply("mish", x)


def softplus(x, beta=1, threshold=20, name=None):
    from ...tensor.math import softplus as _softplus_math
    return _softplus_math(x, beta, threshold)


def softshrink(x, threshold=0.5, name=None):
    return apply("softshrink_op", x, threshold=float(threshold))


def hardshrink(x, threshold=0.5, name=None):
    return apply("hardshrink_op", x, threshold=float(threshold))


def tanhshrink(x, name=None):
    return apply("tanhshrink", x)


def softsign(x, name=None):
    return apply("softsign", x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply("thresholded_relu_op", x, threshold=float(threshold),
                 value=float(value))


def log_sigmoid(x, name=None):
    return apply("log_sigmoid", x)


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with Gumbel noise ``g`` drawn from
    the generator of ``x``'s device; ``hard`` gives the one-hot of the
    argmax with the soft gradient."""
    gen = random_state.generator(x.device)
    u = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    u.uniform_(generator=gen).clamp_(min=torch.finfo(torch.float32).tiny)
    g = (-torch.log(-torch.log(u))).to(x.dtype)
    y = softmax((x + g) / temperature, axis=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        return y + (y_hard - y.detach())
    return y


def maxout(x, groups, axis=1, name=None):
    shape = list(x.shape)
    axis = axis % x.dim()
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return x.reshape(shape).amax(dim=axis + 1)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """Training: a negative slope a element drawn uniformly in [lower,
    upper) from the generator of ``x``'s device; else leaky_relu at their
    mean."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2)
    gen = random_state.generator(x.device)
    a = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    a.uniform_(lower, upper, generator=gen)
    return apply("prelu_op", x, a.to(x.dtype))


def _act_inplace(fn, name):
    """The in-place form of ``fn``: ``x`` takes ``fn(x)``'s values and its
    gradient, as the reference's ``swap_inplace_``."""
    def run(x, *args, **kwargs):
        return x.copy_(fn(x.clone(), *args, **kwargs))
    run.__name__ = name
    return run


elu_ = _act_inplace(elu, "elu_")
hardtanh_ = _act_inplace(hardtanh, "hardtanh_")
leaky_relu_ = _act_inplace(leaky_relu, "leaky_relu_")
relu_ = _act_inplace(relu, "relu_")
softmax_ = _act_inplace(softmax, "softmax_")
tanh_ = _act_inplace(tanh, "tanh_")
thresholded_relu_ = _act_inplace(thresholded_relu, "thresholded_relu_")
