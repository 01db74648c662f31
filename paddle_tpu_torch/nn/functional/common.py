"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``): linear, the dropout family,
embedding, one_hot, pad, normalize, cosine_similarity, interpolate,
unfold/fold, pixel shuffles and the rest of the reference's file.

Weights keep Paddle's ``(in, out)`` layout: ``linear`` is ``x @ W + b``.

Dropout computes the reference's function.  Its default mask draws 8
random bits an element and keeps those at or above ``round(p * 256)``,
so the drop rate is ``p`` quantised to 1/256 and the kept values are
scaled by ``1 / (1 - thresh / 256)`` (``fast_keep_mask``); with
``FLAGS_exact_dropout_mask`` (or a threshold of 0 or 256) the mask is an
exact Bernoulli(1 - p).  The bits come from the generator of the input's
device (``core/random_state``), never from JAX's stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ...amp import maybe_autocast_arrays
from ...core import random_state
from ...core.dtype import get_default_dtype, to_torch_dtype
from ...ops.op import apply, register_op

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "feature_alpha_dropout", "gather_tree", "embedding", "one_hot", "pad",
    "cosine_similarity", "normalize", "interpolate", "upsample", "unfold",
    "fold", "bilinear", "label_smooth", "sequence_mask", "pixel_shuffle",
    "pixel_unshuffle", "channel_shuffle", "class_center_sample", "zeropad2d",
]


def _linear(x, weight, bias=None):
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


register_op("linear_op", _linear, "linear")


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, name=None) -> torch.Tensor:
    x, weight, bias = maybe_autocast_arrays(x, weight, bias, op="linear")
    return apply("linear_op", x, weight, bias)


# -- dropout --------------------------------------------------------------

def _exact_mask_flag() -> bool:
    from ...flags import get_flags
    return bool(get_flags("exact_dropout_mask"))


def _bernoulli_keep(generator, keep_p: float, shape, device):
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return u < keep_p


def fast_keep_mask(generator, p, shape, device, exact=None):
    """(keep mask, realised keep probability): 8 bits an element against
    the threshold ``round(p * 256)``, or an exact Bernoulli(1 - p) where
    ``exact`` (default ``FLAGS_exact_dropout_mask``) or the threshold is 0
    or 256.  Callers scale the kept values by 1 / the returned
    probability."""
    if exact is None:
        exact = _exact_mask_flag()
    thresh = int(round(float(p) * 256.0))
    if exact or thresh <= 0 or thresh >= 256:
        return _bernoulli_keep(generator, 1.0 - p, shape, device), 1.0 - p
    bits = torch.randint(0, 256, tuple(shape), generator=generator,
                         device=device, dtype=torch.uint8)
    return bits >= thresh, 1.0 - thresh / 256.0


def _dropout_op(x, generator, p, upscale, exact=False):
    if upscale:
        keep, keep_p = fast_keep_mask(generator, p, x.shape, x.device,
                                      exact=exact)
        scale = torch.tensor(keep_p, dtype=x.dtype)
        return torch.where(keep, x / scale, torch.zeros_like(x))
    # downscale_in_infer scales by the exact 1 - p at inference, so the
    # training mask is exact too
    keep = _bernoulli_keep(generator, 1.0 - p, x.shape, x.device)
    return torch.where(keep, x, torch.zeros_like(x))


register_op("dropout_op", _dropout_op, "norm_layer")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    gen = random_state.generator(x.device)
    if axis is not None:
        # one mask shared along the axes not listed, exact Bernoulli
        axes = [axis] if isinstance(axis, int) else list(axis)
        mask_shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
        keep = _bernoulli_keep(gen, 1.0 - p, mask_shape, x.device)
        scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
        return x * (keep.to(x.dtype) * scale)
    return apply("dropout_op", x, gen, p=float(p),
                 upscale=(mode == "upscale_in_train"),
                 exact=_exact_mask_flag())


def _channel_dropout(x, p, channel_axis):
    mask_shape = [x.shape[i] if i in (0, channel_axis) else 1
                  for i in range(x.dim())]
    keep = _bernoulli_keep(random_state.generator(x.device), 1.0 - p,
                           mask_shape, x.device)
    return x * (keep.to(x.dtype) / (1.0 - p))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    if not training or p == 0.0:
        return x
    return _channel_dropout(x, p, 1 if data_format == "NCHW" else 3)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    if not training or p == 0.0:
        return x
    return _channel_dropout(x, p, 1 if data_format == "NCDHW" else 4)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def _alpha_dropout_op(x, generator, p, featurewise=False):
    """SELU-preserving dropout; ``featurewise`` drops whole channels (a
    mask over (N, C))."""
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    mask_shape = tuple(x.shape[:2]) + (1,) * (x.dim() - 2) if featurewise \
        else tuple(x.shape)
    keep = _bernoulli_keep(generator, 1.0 - p, mask_shape, x.device)
    a = ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    out = torch.where(keep, x, torch.full_like(x, alpha_p))
    return (a * out + b).to(x.dtype)


register_op("alpha_dropout_op", _alpha_dropout_op, "norm_layer")


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    return apply("alpha_dropout_op", x, random_state.generator(x.device),
                 p=float(p))


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    return apply("alpha_dropout_op", x, random_state.generator(x.device),
                 p=float(p), featurewise=True)


# -- embedding and one_hot -----------------------------------------------

def _embedding_op(weight, ids, padding_idx):
    # the row of padding_idx gets no gradient; a negative padding_idx
    # matches no id, as in the reference
    pad = padding_idx if padding_idx is not None and padding_idx >= 0 \
        else None
    return TF.embedding(ids, weight, padding_idx=pad)


register_op("embedding_op", _embedding_op, "embedding")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    return apply("embedding_op", weight, x,
                 padding_idx=None if padding_idx is None else int(padding_idx))


def one_hot(x, num_classes, name=None):
    """In the default floating dtype; an id outside [0, num_classes) gives
    a row of zeros."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.unsqueeze(-1) == classes).to(get_default_dtype())


# -- padding, norms, similarity ------------------------------------------

def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    from ...tensor.manipulation import pad as _pad
    return _pad(x, pad, mode=mode, value=value, data_format=data_format)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(n1 * n2, min=eps)


register_op("normalize_op", lambda x, p, axis, epsilon: x / torch.clamp(
    torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True),
    min=epsilon), "norm_layer")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return apply("normalize_op", x, p=float(p), axis=int(axis),
                 epsilon=float(epsilon))


# -- resizing --------------------------------------------------------------

def _triangle(d):
    return torch.clamp(1 - d.abs(), min=0)


def _keys_cubic(d):
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, torch.zeros_like(d), out)


def _weight_mat(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """(n_in, n_out) interpolation weights with half-pixel centres, the
    kernel widened when downsampling (antialiasing), as
    ``jax.image.resize`` builds them."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv_scale \
        - 0.5
    d = (sample[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]
         ).abs() / kernel_scale
    w = kernel(d)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _resize(x, out_spatial, spatial_axes, method: str):
    for ax, n in zip(spatial_axes, out_spatial):
        m = x.shape[ax]
        if m == n:
            continue
        if method == "nearest":
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * m / n).long().to(x.device)
            x = x.index_select(ax, idx)
            continue
        kernel = _keys_cubic if method == "cubic" else _triangle
        w = _weight_mat(m, n, kernel, x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, ax, -1) @ w, -1, ax)
    return x


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resampling as the reference computes it (``jax.image.resize``):
    half-pixel centres, antialiased when shrinking; "bilinear",
    "linear", "trilinear" and "area" are the triangle kernel, "bicubic"
    Keys' cubic (a = -0.5)."""
    nchw = data_format in ("NCHW", "NCW", "NCDHW")
    nd = x.dim() - 2
    axes = list(range(2, x.dim())) if nchw else list(range(1, x.dim() - 1))
    spatial = [x.shape[a] for a in axes]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        out_spatial = [int(s) for s in size]
    else:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * nd
        out_spatial = [int(s * f) for s, f in zip(spatial, scale_factor)]
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "trilinear": "linear", "bicubic": "cubic",
              "area": "linear"}[mode]
    return _resize(x, out_spatial, axes, method)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: (N, C, H, W) → (N, C*kh*kw, L); ``paddings`` is one int,
    (ph, pw), or (top, bottom, left, right)."""
    if isinstance(paddings, (list, tuple)) and len(paddings) == 4:
        x = TF.pad(x, (paddings[2], paddings[3], paddings[0], paddings[1]))
    else:
        ph, pw = _pair(paddings)
        x = TF.pad(x, (pw, pw, ph, ph))
    return TF.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                     padding=0, stride=_pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of ``unfold``: overlapping blocks sum."""
    return TF.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                   dilation=_pair(dilations), padding=_pair(paddings)[:2],
                   stride=_pair(strides))


def bilinear(x1, x2, weight, bias=None, name=None):
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    if maxlen is None:
        maxlen = int(x.max())
    elif isinstance(maxlen, torch.Tensor):
        maxlen = int(maxlen.item())
    mask = torch.arange(maxlen, device=x.device) < x.unsqueeze(-1)
    return mask.to(to_torch_dtype(dtype))


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = int(upscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, c // (r * r), r, r, h, w).permute(
            0, 1, 4, 2, 5, 3).reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, r, r, c // (r * r)).permute(
        0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = int(downscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, c, h // r, r, w // r, r).permute(
            0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    return x.reshape(n, h // r, r, w // r, r, c).permute(
        0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    g = int(groups)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(
            n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(n, h, w, c)


def class_center_sample(label, num_classes, num_samples, group=None):
    """Single-process form: the label's classes, topped up to
    ``num_samples`` with other classes drawn by numpy's generator seeded 0
    (as the reference); returns (remapped labels, sampled classes)."""
    arr = label.detach().cpu().numpy()
    pos = np.unique(arr)
    if len(pos) >= num_samples:
        sampled = pos[:num_samples]
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        extra = np.random.default_rng(0).choice(
            rest, num_samples - len(pos), replace=False)
        sampled = np.concatenate([pos, extra])
    sampled.sort()
    remap = {c: i for i, c in enumerate(sampled)}
    remapped = np.vectorize(lambda v: remap.get(v, -1))(arr)
    return (torch.as_tensor(remapped, dtype=torch.int64, device=label.device),
            torch.as_tensor(sampled, dtype=torch.int64, device=label.device))


def gather_tree(ids, parents):
    """Beam-search backtrack: ``ids`` and ``parents`` (T, B, beam); each
    beam's tokens re-chained along its parent pointers from the last step
    back."""
    t_len, b, w = ids.shape
    beam = torch.arange(w, device=ids.device).expand(b, w).to(parents.dtype)
    out = []
    for t in range(t_len - 1, -1, -1):
        idx = beam.long()
        out.append(torch.gather(ids[t], 1, idx))
        beam = torch.gather(parents[t], 1, idx)
    return torch.stack(out[::-1])
