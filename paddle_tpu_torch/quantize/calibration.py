"""Calibration input for weight quantization (counterpart of
``paddle_tpu/quantize/calibration.py``).

``paddle_tpu.numerics.calibration/1`` is the one calibration format: a
JSON payload ``{"schema": ..., "params": {param_name: entry}}`` whose
entries carry ``absmax`` and abs-value ``percentiles``.  The schema string
is a copy of ``paddle_tpu/telemetry/numerics.py`` ``CALIBRATION_SCHEMA``,
so dumps written by either package load in both.

* :func:`load` accepts a path, a loaded payload or a bare
  ``{param_name: entry}`` mapping and returns the payload form;
* :func:`parse_scale_method` reads ``"absmax"`` / ``"percentile[:p]"``;
* :func:`clip_for` turns one param's entry into the optional clip value
  :func:`core.quantize_weight` consumes.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Union

__all__ = ["CALIBRATION_SCHEMA", "load", "load_calibration", "clip_for",
           "parse_scale_method"]

CALIBRATION_SCHEMA = "paddle_tpu.numerics.calibration/1"


def load_calibration(path: str) -> Dict[str, Any]:
    """Read a calibration dump; raises ValueError on another schema."""
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    if payload.get("schema") != CALIBRATION_SCHEMA:
        raise ValueError(
            f"{path}: calibration schema {payload.get('schema')!r} does "
            f"not match {CALIBRATION_SCHEMA!r}")
    return payload


def load(calibration: Union[str, Dict[str, Any], None]
         ) -> Optional[Dict[str, Any]]:
    """Normalize any accepted calibration input to the payload dict
    (``{"schema": ..., "params": {...}}``) or None."""
    if calibration is None:
        return None
    if isinstance(calibration, str):
        return load_calibration(calibration)
    if not isinstance(calibration, dict):
        raise TypeError(f"calibration must be a path or a dict, got "
                        f"{type(calibration).__name__}")
    if "params" in calibration:
        schema = calibration.get("schema")
        if schema is not None and schema != CALIBRATION_SCHEMA:
            raise ValueError(
                f"calibration schema {schema!r} does not match "
                f"{CALIBRATION_SCHEMA!r}")
        return calibration
    return {"schema": CALIBRATION_SCHEMA, "params": dict(calibration)}


def parse_scale_method(method: str):
    """``"absmax"`` → (``"absmax"``, None); ``"percentile"`` /
    ``"percentile:99.9"`` → (``"percentile"``, 99.9)."""
    m = str(method).strip().lower()
    if m == "absmax":
        return "absmax", None
    if m.startswith("percentile"):
        _, _, p = m.partition(":")
        return "percentile", float(p) if p else 99.9
    raise ValueError(f"unknown scale method {method!r} (use 'absmax' or "
                     f"'percentile[:<p>]')")


def clip_for(entry: Optional[Dict[str, Any]], method: str,
             pct: Optional[float]) -> Optional[float]:
    """The outlier clip value for one param (None = no clipping).

    ``absmax`` never clips.  ``percentile`` clips at the dump's value for
    that percentile; a missing entry or percentile means no clipping
    rather than a guessed range."""
    if method == "absmax" or entry is None or pct is None:
        return None
    pcts = entry.get("percentiles") or {}
    val = pcts.get(str(pct))
    if val is None:
        # tolerate float-formatting drift ("99.9" vs "99.90")
        for k, v in pcts.items():
            try:
                if abs(float(k) - pct) < 1e-9:
                    val = v
                    break
            except (TypeError, ValueError):
                continue
    if val is None or float(val) <= 0:
        return None
    return float(val)
