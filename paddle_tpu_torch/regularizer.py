"""Regularizers (counterpart of ``paddle_tpu/regularizer.py``: L1Decay,
L2Decay), folded into the gradients by the non-decoupled optimizers."""

from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]


class WeightDecayRegularizer:
    def __init__(self, coeff: float = 0.0) -> None:
        self._coeff = float(coeff)

    @property
    def coeff(self) -> float:
        return self._coeff

    def apply_tensor(self, param: torch.Tensor, grad: torch.Tensor
                     ) -> torch.Tensor:
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def apply_tensor(self, param, grad):
        return grad + self._coeff * param.to(grad.dtype)


class L1Decay(WeightDecayRegularizer):
    def apply_tensor(self, param, grad):
        return grad + self._coeff * torch.sign(param).to(grad.dtype)
