"""QuantConfig: which activation and weight quanters each layer gets
(counterpart of ``paddle_tpu/quantization/config.py``).

A layer's own config wins over its type's, which wins over the global
one.  The default QAT mapping is ``{Linear: QuantedLinear}``; ``Conv2D``
joins it with the port's convolution layers.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Type

from ..nn.layer.layers import Layer

__all__ = ["QuantConfig"]


class _LayerConfig:
    def __init__(self, activation=None, weight=None) -> None:
        self.activation = activation
        self.weight = weight


def _instantiate(factory):
    """A quanter/observer spec may be a class, a factory with _instance(),
    a zero-arg callable, or an instance prototype (deep-copied per site)."""
    if factory is None:
        return None
    if isinstance(factory, type):
        return factory()
    if hasattr(factory, "_instance"):
        return factory._instance()
    if isinstance(factory, Layer):
        return copy.deepcopy(factory)
    if callable(factory):
        return factory()
    return copy.deepcopy(factory)


class QuantConfig:
    """The reference's ``QuantConfig``."""

    def __init__(self, activation=None, weight=None) -> None:
        self._global = _LayerConfig(activation, weight)
        self._layer_configs: Dict[int, _LayerConfig] = {}
        self._type_configs: Dict[Type, _LayerConfig] = {}
        self._qat_layer_mapping: Dict[Type, Type] = {}

    # ------------------------------------------------------------- fills
    def add_layer_config(self, layer, activation=None, weight=None) -> None:
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for one in layers:
            self._layer_configs[id(one)] = _LayerConfig(activation, weight)

    def add_type_config(self, layer_type, activation=None,
                        weight=None) -> None:
        types = layer_type if isinstance(layer_type, (list, tuple)) \
            else [layer_type]
        for t in types:
            self._type_configs[t] = _LayerConfig(activation, weight)

    def add_qat_layer_mapping(self, source: Type, target: Type) -> None:
        self._qat_layer_mapping[source] = target

    @property
    def qat_layer_mappings(self) -> Dict[Type, Type]:
        mapping = dict(self._default_qat_layer_mapping())
        mapping.update(self._qat_layer_mapping)
        return mapping

    @staticmethod
    def _default_qat_layer_mapping():
        from ..nn.layer.common import Linear
        from .qat_layers import QuantedLinear
        return {Linear: QuantedLinear}

    # ------------------------------------------------------------ queries
    def _get_config_by_layer(self, layer) -> Optional[_LayerConfig]:
        cfg = self._layer_configs.get(id(layer))
        if cfg is not None:
            return cfg
        cfg = self._type_configs.get(type(layer))
        if cfg is not None:
            return cfg
        if self._global.activation is not None or \
                self._global.weight is not None:
            return self._global
        return None

    def activation_quanter_for(self, layer):
        cfg = self._get_config_by_layer(layer)
        return _instantiate(cfg.activation) if cfg else None

    def weight_quanter_for(self, layer):
        cfg = self._get_config_by_layer(layer)
        return _instantiate(cfg.weight) if cfg else None

    def need_quantize(self, layer) -> bool:
        return (type(layer) in self.qat_layer_mappings
                and self._get_config_by_layer(layer) is not None)
