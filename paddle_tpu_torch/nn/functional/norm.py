"""Normalisation (counterpart of ``paddle_tpu/nn/functional/norm.py``):
layer_norm, rms_norm, batch_norm, instance_norm, group_norm,
local_response_norm, with the reference's registry ops
(``layer_norm_op``, ``rms_norm_op``, ``batch_norm_train``,
``batch_norm_infer``, ``instance_norm_op``, ``group_norm_op``).

Paddle's running statistics use ``momentum`` the other way round from
torch: ``running = momentum * running + (1 - momentum) * batch`` with
momentum 0.9, and the variance the update takes is the batch's biased
variance (the one that normalises the batch), as the reference's
``_bn_train_fwd`` returns it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ops.op import apply, register_op

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm", "rms_norm"]


def _ln_op(x, w, b, begin_axis, epsilon):
    dims = tuple(range(begin_axis, x.dim()))
    mu = x.mean(dim=dims, keepdim=True)
    var = (x - mu).square().mean(dim=dims, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + epsilon)
    if w is not None:
        y = y * w
    if b is not None:
        y = y + b
    return y


register_op("layer_norm_op", _ln_op, "norm_layer")


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    begin = x.dim() - len(tuple(normalized_shape))
    return apply("layer_norm_op", x, weight, bias, begin_axis=int(begin),
                 epsilon=float(epsilon))


def _rms_op(x, w, epsilon):
    """RMS over the last axis, accumulated in at least f32.  The
    normalised value is cast back to the input dtype BEFORE the weight
    multiply, as the reference does (``_rms_fwd``)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if w is not None:
        y = y * w
    return y


register_op("rms_norm_op", _rms_op, "norm_layer")


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             epsilon: float = 1e-6, name=None) -> torch.Tensor:
    return apply("rms_norm_op", x, weight, epsilon=float(epsilon))


def _channel_shape(x, ch_axis):
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]
    return shape


def _bn_train_op(x, w, b, axes_key, epsilon):
    """(y, batch mean, batch biased variance); the statistics carry no
    gradient of their own, as in the reference's VJP."""
    axes = tuple(axes_key)
    ch_axis = [i for i in range(x.dim()) if i not in axes][0]
    shape = _channel_shape(x, ch_axis)
    mu = x.mean(dim=axes)
    var = x.var(dim=axes, correction=0)
    y = (x - mu.reshape(shape)) * torch.rsqrt(var.reshape(shape) + epsilon)
    if w is not None:
        y = y * w.reshape(shape)
    if b is not None:
        y = y + b.reshape(shape)
    return y, mu.detach(), var.detach()


def _bn_infer_op(x, mean, var, w, b, ch_axis, epsilon):
    shape = _channel_shape(x, ch_axis)
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + epsilon)
    if w is not None:
        y = y * w.reshape(shape)
    if b is not None:
        y = y + b.reshape(shape)
    return y


register_op("batch_norm_train", _bn_train_op, "norm_layer")
register_op("batch_norm_infer", _bn_infer_op, "norm_layer")


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Training (unless ``use_global_stats``): normalise by the batch's
    statistics and update the running ones in place; otherwise normalise
    by the running ones."""
    nchw = not data_format.endswith("C") or data_format == "NC"
    ch_axis = 1 if nchw else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch_axis)
    if use_global_stats is None:
        use_global_stats = not training
    if training and not use_global_stats:
        y, mu, var = apply("batch_norm_train", x, weight, bias,
                           axes_key=axes, epsilon=float(epsilon))
        if running_mean is not None:
            m = float(momentum)
            with torch.no_grad():
                running_mean.mul_(m).add_((1 - m) * mu.to(running_mean.dtype))
                running_var.mul_(m).add_((1 - m) * var.to(running_var.dtype))
        return y
    return apply("batch_norm_infer", x, running_mean, running_var, weight,
                 bias, ch_axis=ch_axis, epsilon=float(epsilon))


def _in_op(x, w, b, epsilon):
    dims = tuple(range(2, x.dim()))
    mu = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + epsilon)
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    if w is not None:
        y = y * w.reshape(shape)
    if b is not None:
        y = y + b.reshape(shape)
    return y


register_op("instance_norm_op", _in_op, "norm_layer")


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Each sample's each channel normalised by its own statistics (the
    running statistics are not read or updated, as in the reference)."""
    return apply("instance_norm_op", x, weight, bias, epsilon=float(eps))


def _gn_op(x, w, b, groups, epsilon, nchw):
    if not nchw:
        x = torch.movedim(x, -1, 1)
    n, c = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    xg = x.reshape((n, groups, c // groups) + spatial)
    dims = tuple(range(2, xg.dim()))
    mu = xg.mean(dim=dims, keepdim=True)
    var = xg.var(dim=dims, keepdim=True, correction=0)
    y = ((xg - mu) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    shape = (1, c) + (1,) * len(spatial)
    if w is not None:
        y = y * w.reshape(shape)
    if b is not None:
        y = y + b.reshape(shape)
    if not nchw:
        y = torch.movedim(y, 1, -1)
    return y


register_op("group_norm_op", _gn_op, "norm_layer")


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    return apply("group_norm_op", x, weight, bias, groups=int(num_groups),
                 epsilon=float(epsilon), nchw=data_format.startswith("NC"))


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * sum of squares over ``size`` neighbouring
    channels) ** beta (alpha is not divided by size, as in the
    reference)."""
    nchw = data_format.startswith("NC")
    if not nchw:
        x = torch.movedim(x, -1, 1)
    half = size // 2
    sq = torch.nn.functional.pad(
        x.square().movedim(1, -1), (half, size - half - 1)).movedim(-1, 1)
    div = sum(sq.narrow(1, i, x.shape[1]) for i in range(size))
    out = x / torch.pow(k + alpha * div, beta)
    return torch.movedim(out, 1, -1) if not nchw else out
