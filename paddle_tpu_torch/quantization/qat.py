"""QAT: swap quantizable sublayers for their quantised versions, and
convert them to the inference form (counterpart of
``paddle_tpu/quantization/qat.py``)."""

from __future__ import annotations

from ..nn.layer.layers import Layer
from .config import QuantConfig
from .qat_layers import ConvertedLinear, QuantedLinear

__all__ = ["QAT"]


def _replace_sublayers(model: Layer, replace_fn) -> None:
    for name, child in list(model.named_children()):
        new = replace_fn(child)
        if new is not None:
            setattr(model, name, new)
        else:
            _replace_sublayers(child, replace_fn)


def _require_inplace(inplace: bool, what: str) -> None:
    # the reference swaps layers in place only; so does the port
    if not inplace:
        raise ValueError(f"call {what}(model, inplace=True)")


class QAT:
    """The reference's ``QAT``."""

    def __init__(self, config: QuantConfig) -> None:
        self._config = config

    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        _require_inplace(inplace, "quantize")
        mapping = self._config.qat_layer_mappings

        def replace(layer):
            if self._config.need_quantize(layer):
                return mapping[type(layer)](layer, self._config)
            return None

        _replace_sublayers(model, replace)
        return model

    def convert(self, model: Layer, inplace: bool = False) -> Layer:
        _require_inplace(inplace, "convert")

        def replace(layer):
            if isinstance(layer, QuantedLinear):
                return ConvertedLinear(layer)
            return None

        _replace_sublayers(model, replace)
        return model
