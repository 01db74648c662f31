"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``).

``Linear`` and ``Embedding`` are the reference's: weights start
XavierUniform through ``Layer.create_parameter`` (Paddle's fans of a 2-D
weight, ``(shape[0], shape[1])``), a bias at 0, and they take
``weight_attr``/``bias_attr``/``name``; ``Embedding`` zeroes the row of
``padding_idx``, which gets no gradient.  Weights keep Paddle's
``(in, out)`` layout, so names and shapes carry across from the reference
with no transposes.  Layers with parameters also take the port's
keyword-only ``dtype``, ``device`` (None: the current device, the card
unless set) and ``generator`` (None: that device's global generator).
The parallel layers the Llama builds (XavierNormal) are in
``distributed/fleet/meta_parallel/mp_layers.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import functional as F
from ..initializer import XavierUniform
from .layers import Layer

__all__ = ["Linear", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
           "Embedding", "Flatten", "Identity", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "Pad1D", "Pad2D",
           "Pad3D", "ZeroPad2D", "CosineSimilarity", "PairwiseDistance",
           "Unflatten", "Bilinear", "Unfold", "Fold", "PixelShuffle",
           "PixelUnshuffle", "ChannelShuffle", "LinearCompat"]


class Linear(Layer):
    """y = x W + b, weight (in_features, out_features).  ``bias=False``
    is the same as ``bias_attr=False``."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None, *, bias: bool = True, dtype=None,
                 device=None, generator: Optional[torch.Generator] = None
                 ) -> None:
        super().__init__(dtype=dtype)
        self._in_features = in_features
        self._out_features = out_features
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform(), **kw)
        self.bias = self.create_parameter(
            shape=[out_features], attr=bias_attr if bias else False,
            is_bias=True, **kw)

    def forward(self, input):
        return F.linear(input, self.weight, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


LinearCompat = Linear


class Embedding(Layer):
    """Weight (num_embeddings, embedding_dim); a negative ``padding_idx``
    counts from the end."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, *, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(dtype=dtype)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (None if padding_idx is None else
                             padding_idx if padding_idx >= 0
                             else num_embeddings + padding_idx)
        self._sparse = sparse
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierUniform(), device=device,
            generator=generator)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self) -> str:
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None) -> None:
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, input):
        return F.dropout(input, self.p, axis=self.axis,
                         training=self.training, mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None) -> None:
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, input):
        return F.dropout2d(input, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None) -> None:
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, input):
        return F.dropout3d(input, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None) -> None:
        super().__init__()
        self.p = p

    def forward(self, input):
        return F.alpha_dropout(input, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1) -> None:
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, input):
        return torch.flatten(input, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    """Split axis ``axis`` into ``shape``."""

    def __init__(self, axis: int, shape, name=None) -> None:
        super().__init__()
        self.axis, self.shape = axis, [int(s) for s in shape]

    def forward(self, x):
        axis = self.axis % x.dim()
        return x.reshape(list(x.shape[:axis]) + self.shape +
                         list(x.shape[axis + 1:]))


class Identity(Layer):
    def __init__(self, *args, **kwargs) -> None:
        super().__init__()

    def forward(self, input):
        return input


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None) -> None:
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None) -> None:
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None) -> None:
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class _PadNd(Layer):
    def __init__(self, padding, mode, value, data_format) -> None:
        super().__init__()
        self.padding, self.mode = padding, mode
        self.value, self.data_format = value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None) -> None:
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None) -> None:
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None) -> None:
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadNd):
    def __init__(self, padding, data_format="NCHW", name=None) -> None:
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8) -> None:
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    """The p-norm of ``|x - y| + epsilon`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None) -> None:
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        ad = (x - y).abs() + self.epsilon
        if self.p == float("inf"):
            return ad.amax(dim=-1, keepdim=self.keepdim)
        return (ad ** self.p).sum(dim=-1, keepdim=self.keepdim) ** \
            (1.0 / self.p)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, dtype=None,
                 device=None, generator=None) -> None:
        super().__init__(dtype=dtype)
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            shape=[out_features, in1_features, in2_features],
            attr=weight_attr, default_initializer=XavierUniform(), **kw)
        self.bias = self.create_parameter(
            shape=[1, out_features], attr=bias_attr, is_bias=True, **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None) -> None:
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, input):
        return F.unfold(input, self.kernel_sizes, self.strides,
                        self.paddings, self.dilations)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None) -> None:
        super().__init__()
        self.output_sizes, self.kernel_sizes = output_sizes, kernel_sizes
        self.strides, self.paddings = strides, paddings
        self.dilations = dilations

    def forward(self, input):
        return F.fold(input, self.output_sizes, self.kernel_sizes,
                      self.strides, self.paddings, self.dilations)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None) -> None:
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW",
                 name=None) -> None:
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None) -> None:
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)
