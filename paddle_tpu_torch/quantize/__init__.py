"""Weight-only quantized inference (counterpart of ``paddle_tpu/quantize``,
the parts serving uses).

* :mod:`core` — the codec: int8/int4 group-wise weight quantization,
  int4 nibble packing, per-row KV quantization (torch, on the device;
  byte-identical to the reference's numpy and jnp versions).
* :mod:`calibration` — ``paddle_tpu.numerics.calibration/1`` loading and
  scale-method parsing.
* :mod:`layers` — ``QuantizedLinear`` / ``QuantizedEmbedding`` and
  :func:`quantize_for_inference`.

The int8 paged KV pool is ``FLAGS_serving_kv_quant`` (serving/); the
matmul kernel is ``ops/cuda/quant_matmul``.
"""

from . import calibration, core, layers  # noqa: F401
from .core import (dequantize_weight, maxq, np_pack_int4,  # noqa: F401
                   np_quantize_kv_rows, pack_int4, quantize_kv_rows,
                   quantize_weight, unpack_int4)
from .layers import (QuantizedEmbedding, QuantizedLinear,  # noqa: F401
                     quant_embedding_lookup, quantize_for_inference)

__all__ = [
    "core", "calibration", "layers",
    "maxq", "np_pack_int4", "pack_int4", "unpack_int4", "quantize_weight",
    "dequantize_weight", "quantize_kv_rows", "np_quantize_kv_rows",
    "QuantizedLinear", "QuantizedEmbedding", "quant_embedding_lookup",
    "quantize_for_inference",
]
