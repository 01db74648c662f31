"""PTQ: the QAT layer swap with observers for quanters, calibration by
running sample batches in eval mode, then ``convert()`` bakes their scales
(counterpart of ``paddle_tpu/quantization/ptq.py``).

:meth:`PTQ.dump_calibration` / :meth:`PTQ.load_calibration` speak
``paddle_tpu.numerics.calibration/1``, the format
``quantize.quantize_for_inference`` reads, so a dump of either package
loads in both.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Union

from ..nn.layer.layers import Layer
from .config import QuantConfig
from .observers import BaseObserver
from .qat import QAT

__all__ = ["PTQ"]


def _atomic_json(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, default=repr)
    os.replace(tmp, path)


class PTQ:
    """The reference's ``PTQ``: the configured quanters are observers
    (identity forward, stat recording)."""

    def __init__(self, config: QuantConfig) -> None:
        self._config = config
        self._qat = QAT(config)

    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        model = self._qat.quantize(model, inplace=inplace)
        model.eval()
        return model

    def convert(self, model: Layer, inplace: bool = False) -> Layer:
        return self._qat.convert(model, inplace=inplace)

    @staticmethod
    def _observers(model: Layer) -> Dict[str, BaseObserver]:
        return {name: layer for name, layer in model.named_sublayers()
                if isinstance(layer, BaseObserver)}

    def dump_calibration(self, model: Layer,
                         path: Optional[str] = None) -> Dict[str, Any]:
        """Every observer's stats as one calibration/1 payload (entries
        keyed by the observer's sublayer path); written as JSON where
        ``path`` is given."""
        from ..quantize import calibration as _calib
        payload = _calib.from_observers(self._observers(model),
                                        type(model).__name__)
        if path is not None:
            _atomic_json(path, payload)
        return payload

    def load_calibration(self, model: Layer,
                         calibration: Union[str, Dict[str, Any]]) -> int:
        """Seed the model's observers from a calibration/1 dump (path or
        payload): each observer whose sublayer path has an entry takes its
        absmax.  Returns the observers seeded."""
        from ..quantize import calibration as _calib
        payload = _calib.load(calibration) or {"params": {}}
        entries = payload.get("params", {})
        n = 0
        for name, obs in self._observers(model).items():
            entry = entries.get(name)
            if entry is not None:
                _calib.seed_observer(obs, entry)
                n += 1
        return n
