"""Cross entropy (counterpart of ``paddle_tpu/nn/functional/loss.py``
``cross_entropy`` and its ``softmax_ce`` op).

Autograd differentiates the plain formula; the reference's hand-written
VJP (softmax - one_hot) is the same gradient.
"""

from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def _squeeze_label(label: torch.Tensor, ndim: int, axis: int):
    if label.dim() == ndim and label.shape[axis] == 1:
        return label.squeeze(axis)
    return label


def _softmax_ce(logits, label, axis: int, soft_label: bool,
                ignore_index: int, label_smoothing: float):
    """Per-position loss with ``axis`` kept (size 1), as the reference's
    ``_sce_fwd``."""
    logp = logits - torch.logsumexp(logits, dim=axis, keepdim=True)
    if soft_label:
        tgt = label.to(logp.dtype)
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + \
                label_smoothing / logits.shape[axis]
        return -(tgt * logp).sum(dim=axis, keepdim=True)
    lab = _squeeze_label(label, logits.dim(), axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    picked = torch.take_along_dim(logp, safe.unsqueeze(axis), dim=axis)
    if label_smoothing > 0:
        smooth = logp.mean(dim=axis, keepdim=True)
        loss = -((1 - label_smoothing) * picked + label_smoothing * smooth)
    else:
        loss = -picked
    return torch.where(valid.unsqueeze(axis), loss, torch.zeros_like(loss))


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None) -> torch.Tensor:
    """Softmax cross entropy over ``axis`` with Paddle's semantics: the
    hard-label ``mean`` averages over the positions whose label is not
    ``ignore_index``.  ``weight`` and ``use_softmax=False`` are not ported
    and raise."""
    if weight is not None:
        raise NotImplementedError("cross_entropy: class weights are not "
                                  "ported yet")
    if not use_softmax:
        raise NotImplementedError("cross_entropy: use_softmax=False (input "
                                  "already probabilities) is not ported yet")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                         f"{reduction!r}")
    axis = axis % input.dim()
    loss = _softmax_ce(input, label, axis, bool(soft_label),
                       int(ignore_index), float(label_smoothing))
    loss = loss.squeeze(axis)
    if reduction == "mean":
        if soft_label:
            return loss.mean()
        lab = _squeeze_label(label, input.dim(), axis)
        denom = (lab != ignore_index).to(loss.dtype).sum()
        return loss.sum() / torch.clamp(denom, min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
