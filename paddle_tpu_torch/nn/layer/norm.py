"""Norm layers (counterpart of ``paddle_tpu/nn/layer/norm.py``).

The batch norms keep the reference's buffer names, ``_mean`` and
``_variance``, so state dicts carry across, and Paddle's momentum
(``running = 0.9 * running + 0.1 * batch``).  ``SyncBatchNorm`` is
``BatchNorm`` at one device (its cross-device statistics come with the
distributed slice).  Layers with parameters take the port's keyword-only
``dtype``, ``device`` and ``generator``, as ``Linear`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm", "RMSNorm",
           "SpectralNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, dtype=None,
                 device=None, generator=None) -> None:
        super().__init__(dtype=dtype)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            shape=[num_features], attr=weight_attr,
            default_initializer=Constant(1.0), **kw)
        self.bias = self.create_parameter(
            shape=[num_features], attr=bias_attr, is_bias=True,
            default_initializer=Constant(0.0), **kw)
        dev = self.weight.device if self.weight is not None else None
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=self._dtype, device=dev))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=self._dtype, device=dev))

    def forward(self, input):
        return F.batch_norm(input, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """Paddle's legacy ``nn.BatchNorm`` (NCHW by default, optional ``act``
    after it)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False, *,
                 device=None, generator=None) -> None:
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None,
                         dtype=dtype, device=device, generator=generator)
        self._act = act

    def forward(self, input):
        out = super().forward(input)
        return getattr(F, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, **kw) -> None:
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, **kw)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, **kw) -> None:
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, **kw)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm with local statistics (one device)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it replaced by a
        ``SyncBatchNorm`` sharing its parameters and statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      False, False, layer._data_format,
                      device=layer._mean.device)
            out.weight, out.bias = layer.weight, layer.bias
            out._mean, out._variance = layer._mean, layer._variance
        for name, sub in list(layer.named_children()):
            converted = cls.convert_sync_batchnorm(sub)
            if converted is not sub:
                layer.add_sublayer(name, converted)
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=None, device=None,
                 generator=None) -> None:
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            shape=self._normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0), **kw)
        self.bias = self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True, **kw)

    def forward(self, input):
        return F.layer_norm(input, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    """RMSNorm over the last axis (the Llama family's norm)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 dtype=None, name=None, *, device=None) -> None:
        super().__init__(dtype=dtype)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=[hidden_size], attr=weight_attr,
            default_initializer=Constant(1.0), device=device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, dtype=None, device=None,
                 generator=None) -> None:
        super().__init__(dtype=dtype)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            shape=[num_channels], attr=weight_attr,
            default_initializer=Constant(1.0), **kw)
        self.bias = self.create_parameter(shape=[num_channels],
                                          attr=bias_attr, is_bias=True, **kw)

    def forward(self, input):
        return F.group_norm(input, self._num_groups, self._epsilon,
                            self.weight, self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, dtype=None, device=None,
                 generator=None) -> None:
        super().__init__(dtype=dtype)
        self._epsilon = epsilon
        kw = dict(device=device, generator=generator)
        if weight_attr is False:
            self.scale = None
            self.bias = None
        else:
            self.scale = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=Constant(1.0), **kw)
            self.bias = self.create_parameter(
                shape=[num_features], attr=bias_attr, is_bias=True, **kw)

    def forward(self, input):
        return F.instance_norm(input, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None) -> None:
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, input):
        return F.local_response_norm(input, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``weight / sigma_max(weight)`` by power iteration, the weight given
    to each call; u and v are buffers (numpy's generator seeded 0 starts
    them, as in the reference) refreshed in training."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", axis=None, epsilon=None, *,
                 device=None) -> None:
        super().__init__(dtype=dtype)
        from ...core.place import resolve_device
        self._dim = int(axis if axis is not None else dim)
        self._power_iters = int(power_iters)
        self._eps = float(epsilon if epsilon is not None else eps)
        shape = tuple(int(s) for s in weight_shape)
        h = shape[self._dim]
        w = int(np.prod(shape)) // h
        rng = np.random.RandomState(0)
        dev = resolve_device(device)
        self.register_buffer("weight_u", torch.from_numpy(
            rng.randn(h).astype("float32")).to(dev))
        self.register_buffer("weight_v", torch.from_numpy(
            rng.randn(w).astype("float32")).to(dev))

    def forward(self, x):
        from ..utils import _spectral_normalize
        out, u, v = _spectral_normalize(x, self._dim, self._power_iters,
                                        self._eps, self.weight_u,
                                        self.weight_v, update=self.training)
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return out
