"""Symmetric integer codec for weight-only inference and the int8 KV pool
(counterpart of ``paddle_tpu/quantize/core.py``, the parts serving uses).

Scheme (symmetric, no zero point): ``scale = max|x| / maxq`` per block
(``maxq`` 127 for int8, 7 for int4), ``q = clip(round(x / scale), -maxq,
maxq)``; an all-zero block gets scale ``1 / maxq`` so it dequantizes
exactly.  The torch functions run on whatever device their input lives
on and give byte-identical codes and scales to the reference's numpy and
jnp versions: the division is IEEE f32 and ``torch.round`` rounds half to
even, as ``np.rint`` and ``jnp.round`` do.

* :func:`quantize_weight` / :func:`dequantize_weight` — a ``(in, out)``
  Linear weight cut into groups of ``group`` rows along the contraction
  (in) dim, one f32 scale per (group, out column); int4 codes are packed
  two to a byte along the in dim.
* :func:`quantize_kv_rows` — one f32 scale per head_dim vector, the
  granularity of the int8 paged KV pool.

The blockwise wire codec of the collectives and of KV migration
(``quant_rows``, ``quantize_blockwise``, ``wire_*``, ``np_quantize_rows``)
comes with those slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["maxq", "np_pack_int4", "pack_int4", "unpack_int4",
           "quantize_weight", "dequantize_weight", "quantize_kv_rows",
           "np_quantize_kv_rows"]


def maxq(bits: int) -> int:
    """Largest magnitude code: 127 for int8, 7 for int4."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return (1 << (bits - 1)) - 1


def _range_scales(amax: torch.Tensor, mq: int) -> torch.Tensor:
    # divide by a tensor, not a Python number: on CUDA, PyTorch turns
    # division by a scalar into a multiplication by its rounded reciprocal,
    # which misses the correctly rounded quotient by an ulp on some rows
    return torch.where(amax > 0, amax, torch.ones_like(amax)) / \
        torch.full_like(amax, float(mq))


# ------------------------------------------------------- int4 packing
# Two 4-bit two's-complement codes per byte, adjacent pairs along the LAST
# axis: byte i holds code 2i in the low nibble, 2i+1 in the high one.

def np_pack_int4(q: np.ndarray) -> np.ndarray:
    """Pack int8 codes in [-8, 7] to nibbles along the last axis (whose
    length must be even); returns int8 of half the last-axis length."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 pack needs an even last axis, "
                         f"got {q.shape}")
    u = q.astype(np.uint8) & 0xF
    lo = u[..., 0::2]
    hi = u[..., 1::2]
    return (lo | (hi << 4)).astype(np.uint8).view(np.int8)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """torch twin of :func:`np_pack_int4`."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 pack needs an even last axis, "
                         f"got {tuple(q.shape)}")
    u = q.to(torch.int16) & 0xF
    v = u[..., 0::2] | (u[..., 1::2] << 4)           # 0..255
    return torch.where(v >= 128, v - 256, v).to(torch.int8)


def unpack_int4(packed: torch.Tensor, axis_len: int) -> torch.Tensor:
    """Unpack nibbles (last axis) back to int8 codes of ``axis_len``; the
    sign extension is ``(v ^ 8) - 8`` on int32, as the reference's."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    out = torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1])
    return out[..., :axis_len].to(torch.int8)


# ------------------------------------------------ weight quantization

def quantize_weight(w, bits: int = 8, group: Optional[int] = None,
                    clip: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Quantize a (in, out) weight to ``(q, scales, group)`` on its own
    device.

    ``q``: int8 ``(kp, out)`` codes for int8, nibble-packed int8
    ``(kp/2, out)`` for int4, where ``kp`` is ``in`` zero-padded up to a
    group multiple (plus one more group of zero rows for int4 when that
    is odd, which only an odd ``group`` makes possible).  ``scales``: f32
    ``(kp/group, out)``.  ``group`` clamps to ``[1, in]``; None or 0 means
    one group over the whole in dim.  ``clip`` (a calibration percentile)
    saturates outliers before the per-group absmax."""
    w = torch.as_tensor(w)
    if w.dim() != 2:
        raise ValueError(f"quantize_weight needs a 2-D (in, out) "
                         f"weight, got shape {tuple(w.shape)}")
    w = w.detach().to(torch.float32)
    k, n = w.shape
    mq = maxq(bits)
    group = int(group or 0) or k
    group = max(1, min(group, k))
    kp = -(-k // group) * group
    if bits == 4 and kp % 2:
        kp += group
    if kp != k:
        w = torch.cat([w, w.new_zeros(kp - k, n)], dim=0)
    if clip is not None and clip > 0:
        w = w.clamp(-float(clip), float(clip))
    g = kp // group
    blocks = w.reshape(g, group, n)
    scales = _range_scales(blocks.abs().amax(dim=1, keepdim=True), mq)
    q = torch.clamp(torch.round(blocks / scales), -mq, mq).to(torch.int8)
    q = q.reshape(kp, n)
    scales = scales.reshape(g, n)
    if bits == 4:
        q = pack_int4(q.t()).t().contiguous()       # pack along the in dim
    return q, scales, group


def dequantize_weight(q: torch.Tensor, scales: torch.Tensor, bits: int,
                      group: int, in_features: int) -> torch.Tensor:
    """Inverse of :func:`quantize_weight` → f32 ``(in, out)``: each code
    times its group's scale (the plain version of the quant_matmul
    kernels' in-register dequantization)."""
    if bits == 4:
        q = unpack_int4(q.t(), scales.shape[0] * group).t()
    kp = q.shape[0]
    sf = torch.repeat_interleave(scales.to(torch.float32), group,
                                 dim=0)[:kp]
    return (q.to(torch.float32) * sf)[:in_features]


# ----------------------------------------------- KV-row quantization

def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize KV rows ``(..., D)`` to int8 codes with one f32 scale per
    head_dim vector ``(..., 1)``: the int8 paged pool's write path."""
    xf = x.to(torch.float32)
    scales = _range_scales(xf.abs().amax(dim=-1, keepdim=True), 127)
    q = torch.clamp(torch.round(xf / scales), -127, 127).to(torch.int8)
    return q, scales


def np_quantize_kv_rows(x: np.ndarray):
    """Numpy twin of :func:`quantize_kv_rows` (the host path)."""
    xf = np.asarray(x, np.float32)
    amax = np.max(np.abs(xf), axis=-1, keepdims=True)
    scales = (np.where(amax > 0, amax, 1.0) / 127.0).astype(np.float32)
    q = np.clip(np.rint(xf / scales), -127, 127).astype(np.int8)
    return q, scales
