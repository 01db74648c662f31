"""Weight-only quantized inference layers and the model entry point
(counterpart of ``paddle_tpu/quantize/layers.py``, single-device form).

:func:`quantize_for_inference` walks a built model and swaps every
``Linear`` (``nn.Linear``, and the single-device ``ColumnParallelLinear``
and ``RowParallelLinear`` the Llama builds) for a :class:`QuantizedLinear`
holding int8 or nibble-packed int4 codes plus per-(group, out-column) f32
scales, and every ``Embedding`` (``nn.Embedding``,
``VocabParallelEmbedding``) for an int8 :class:`QuantizedEmbedding` with
one scale per row.  Quantization
runs on the weight's own device, one layer at a time, and the original
weight is dropped as its layer swaps, so a model on the card never holds
two full copies.  The packed codes keep the name ``weight`` and the scales
are ``weight_scale``, as in the reference, so ``named_parameters()`` lines
up with a quantized reference model's.

Scale selection reads ``paddle_tpu.numerics.calibration/1`` dumps
(``calibration=`` path or payload): ``absmax`` ranges each group on its
own max; ``percentile[:p]`` clips each weight at the dump's percentile
first.

The sharded quantized twins come with the tensor-parallel slice (A7).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..distributed.fleet.meta_parallel.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from ..flags import get_flags
from ..nn.layer.common import Embedding, Linear
from ..ops.op import register_op
from ..ops.cuda.quant_matmul import (quant_matmul, quant_matmul_ref,
                                     use_quant_kernel)
from . import calibration as _calib
from . import core as _core

__all__ = ["QuantizedLinear", "QuantizedEmbedding", "quant_embedding_lookup",
           "quantize_for_inference"]


def quant_embedding_lookup(ids: torch.Tensor, q: torch.Tensor,
                           scales: torch.Tensor) -> torch.Tensor:
    """Gather int8 rows and their per-row scales, dequantize after the
    gather: f32 ``ids.shape + (dim,)``."""
    idx = ids.long()
    return q[idx].to(torch.float32) * scales[idx]


register_op("quant_embedding_lookup", quant_embedding_lookup)

# what quantize_for_inference swaps: the plain layers and their
# single-device parallel twins (the Llama builds the latter)
_LINEARS = (Linear, ColumnParallelLinear, RowParallelLinear)
_EMBEDDINGS = (Embedding, VocabParallelEmbedding)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class QuantizedLinear(nn.Module):
    """Quantized twin of ``Linear``: ``y = x W_deq + b``.  ``kernel``
    (decided at construction) selects the CUDA kernel's wrapper
    ``quant_matmul`` or the plain ``quant_matmul_ref``."""

    def __init__(self, src: Linear, bits: int, group: Optional[int],
                 clip: Optional[float], kernel: bool) -> None:
        super().__init__()
        w = src.weight.detach()
        q, s, group = _core.quantize_weight(w, bits=bits, group=group,
                                            clip=clip)
        self._bits = int(bits)
        self._group = int(group)
        self._in_features = int(w.shape[0])
        self._out_features = int(w.shape[1])
        self.kernel = bool(kernel)
        self.weight = _frozen(q)
        self.weight_scale = _frozen(s)
        self.bias = src.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = quant_matmul if self.kernel else quant_matmul_ref
        out = fn(x, self.weight, self.weight_scale, bits=self._bits,
                 group=self._group)
        if self.bias is not None:
            out = out + self.bias
        return out

    def extra_repr(self) -> str:
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}, bits={self._bits}, "
                f"group={self._group}, kernel={self.kernel}")


class QuantizedEmbedding(nn.Module):
    """Quantized twin of ``Embedding``: int8 rows, one f32 scale per row.

    The lookup dequantizes to f32 (as the reference's) and the layer
    returns the original weight's dtype, so a bf16 model's activations
    stay bf16."""

    def __init__(self, src: Embedding, clip: Optional[float]) -> None:
        super().__init__()
        self._dtype = src.weight.dtype
        w = src.weight.detach().to(torch.float32)
        if clip is not None and clip > 0:
            w = w.clamp(-float(clip), float(clip))
        q, s = _core.quantize_kv_rows(w)     # the same per-row int8 codec
        self._bits = 8
        self.weight = _frozen(q)
        self.weight_scale = _frozen(s)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return quant_embedding_lookup(ids, self.weight,
                                      self.weight_scale).to(self._dtype)


# ------------------------------------------------------- entry point

def _snr_db(orig: torch.Tensor, back: torch.Tensor) -> float:
    err = (back.to(torch.float32) - orig.to(torch.float32)).to(torch.float64)
    sig = float(orig.to(torch.float64).square().sum())
    noise = float(err.square().sum())
    if noise == 0:
        return float("inf")
    return 10.0 * math.log10(max(sig, 1e-30) / noise)


def _nbytes(*ts: torch.Tensor) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def quantize_for_inference(model: nn.Module, calibration=None, bits: int = 8,
                           group: Optional[int] = None,
                           scale_method: str = "absmax",
                           quantize_embeddings: bool = True,
                           skip: Sequence[str] = (),
                           kernel: Optional[bool] = None) -> Dict:
    """Swap a model's Linear/Embedding weights for quantized ones, in
    place.  Returns the report: per-layer ``snr_db``, ``bytes_before``
    (the f32 weight, as the reference counts it) and ``bytes_after``,
    ``snr_db_min`` / ``snr_db_median``, ``bytes_saved`` and ``skipped``.

    ``calibration``: a ``paddle_tpu.numerics.calibration/1`` dump (path or
    payload), needed for ``scale_method='percentile[:p]'``.  ``bits``: 8 or
    4 for the Linears (embeddings stay int8).  ``group``: in-dim rows per
    scale (default ``FLAGS_weight_quant_group``).  ``skip``: substrings of
    layer paths to leave alone.  ``kernel``: force the CUDA kernel on or
    off; default ``FLAGS_weight_quant_kernel`` for the model's device,
    decided here, at construction."""
    payload = _calib.load(calibration)
    method, pct = _calib.parse_scale_method(scale_method)
    if payload is None and method == "percentile":
        raise ValueError(
            "scale_method='percentile' needs a calibration dump — there is "
            "no distribution to take a percentile of otherwise")
    _core.maxq(bits)
    entries = (payload or {}).get("params", {})
    group = int(group or get_flags("weight_quant_group"))
    if kernel is None:
        kernel = use_quant_kernel(next(iter(model.parameters())).device)
    tied = bool(getattr(getattr(model, "config", None),
                        "tie_word_embeddings", False))
    report: Dict = {"bits": int(bits), "group": group,
                    "scale_method": str(scale_method), "layers": {},
                    "skipped": []}

    def _clip(path: str) -> Optional[float]:
        return _calib.clip_for(entries.get(f"{path}.weight"), method, pct)

    # only modules with children are walked as parents, so no list here
    # keeps a swapped-out layer (and its full-precision weight) alive
    parents = [(n, m) for n, m in model.named_modules() if m._modules]
    for parent_name, parent in parents:
        for child_name, child in list(parent.named_children()):
            path = f"{parent_name}.{child_name}" if parent_name \
                else child_name
            if isinstance(child, (QuantizedLinear, QuantizedEmbedding)):
                continue
            if any(s and s in path for s in skip):
                if isinstance(child, _LINEARS + _EMBEDDINGS):
                    report["skipped"].append(
                        {"layer": path, "reason": "skip= pattern"})
                continue
            if isinstance(child, _LINEARS):
                w = child.weight.detach().to(torch.float32)
                qlayer = QuantizedLinear(child, bits, group, _clip(path),
                                         kernel)
                back = _core.dequantize_weight(
                    qlayer.weight, qlayer.weight_scale, qlayer._bits,
                    qlayer._group, w.shape[0])
            elif isinstance(child, _EMBEDDINGS):
                if not quantize_embeddings:
                    continue
                if tied:
                    # the tied lm_head reads embed_tokens.weight.t() as a
                    # matmul operand: it stays exact (and visible)
                    report["skipped"].append(
                        {"layer": path,
                         "reason": "tie_word_embeddings reuses this "
                                   "weight as the lm_head matrix"})
                    continue
                w = child.weight.detach().to(torch.float32)
                qlayer = QuantizedEmbedding(child, _clip(path))
                back = quant_embedding_lookup(
                    torch.arange(w.shape[0], device=w.device), qlayer.weight,
                    qlayer.weight_scale)
            else:
                continue
            setattr(parent, child_name, qlayer)
            report["layers"][path] = {
                "kind": type(qlayer).__name__, "bits": int(qlayer._bits),
                "snr_db": _snr_db(w, back),
                "bytes_before": _nbytes(w),
                "bytes_after": _nbytes(qlayer.weight, qlayer.weight_scale),
            }
            del w, back

    snrs = sorted(v["snr_db"] for v in report["layers"].values())
    report["snr_db_min"] = snrs[0] if snrs else float("inf")
    report["snr_db_median"] = (snrs[len(snrs) // 2] if snrs
                               else float("inf"))
    report["bytes_saved"] = int(sum(
        v["bytes_before"] - v["bytes_after"]
        for v in report["layers"].values()))
    return report
