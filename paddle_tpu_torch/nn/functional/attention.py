"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

Layouts follow the reference: q/k/v are ``(batch, seq, num_heads,
head_dim)``; k/v may have fewer heads (grouped-query attention).

Dispatch: attention with no mask and no dropout always takes
``flash_sdpa``, a ``torch.autograd.Function`` over the flash kernels
(``ops/cuda/flash_attention.py``): on CUDA tensors the CUDA kernels, on
CPU tensors their plain versions, through the same Function.  The
reference's ``_should_use_pallas`` gate (TPU only, seq >= 1024, the
512/256/128 tile rule) is TPU tuning and is not ported: on the card it
would quietly send training below seq 1024 to the plain path.  Masks and
dropout take ``sdpa``, the plain math path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...ops.cuda.flash_attention import (flash_attention_bwd,
                                         flash_attention_fwd)

__all__ = ["scaled_dot_product_attention", "flash_sdpa", "sdpa"]


def _sdpa_probs(q, k, mask, scale: float, is_causal: bool):
    """(B, S, H, D) q/k → (B, H, Sq, Sk) probabilities in q's dtype: scores
    in q's dtype, then f32 softmax (the reference's ``_sdpa_probs``)."""
    h, hkv = q.shape[2], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=q.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~causal, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.to(logits.dtype)
    return torch.softmax(logits, dim=-1).to(q.dtype)


def sdpa(query, key, value, attn_mask=None, scale: Optional[float] = None,
         is_causal: bool = False, dropout_p: float = 0.0) -> torch.Tensor:
    """Plain attention, (B, S, H, D) in and out, differentiated by autograd:
    the reference's ``sdpa`` and ``sdpa_dropout`` ops.  Dropout drops
    probabilities with ``torch.rand`` (torch's generator, not the
    reference's: compare the two only with dropout off) and rescales by
    1 / (1 - p)."""
    scale = 1.0 / math.sqrt(query.shape[-1]) if scale is None else scale
    probs = _sdpa_probs(query, key, attn_mask, scale, is_causal)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, device=probs.device) >= dropout_p
        probs = torch.where(keep, probs, torch.zeros_like(probs)) / \
            (1.0 - dropout_p)
    h, hkv = query.shape[2], value.shape[2]
    if hkv != h:
        value = value.repeat_interleave(h // hkv, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", probs, value)


def _flash_sdpa_fwd(q, k, v, *, scale: float, is_causal: bool):
    """(B, S, H, D) in; the kernel works on (B, H, S, D) views of the same
    memory.  Returns (out (B, S, H, D), lse (B, H, S) f32)."""
    out, lse = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), bool(is_causal), scale)
    return out.transpose(1, 2), lse


def _flash_sdpa_vjp(do, q, k, v, out, lse, *, scale: float,
                    is_causal: bool):
    """dq, dk, dv (B, S, H, D) from the saved out and lse.  With grouped
    query heads the dk/dv kernel sums each group itself, so dk/dv come back
    with the kv heads' shape (the reference repeats K/V and sums
    afterwards)."""
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    dq, dk, dv = flash_attention_bwd(t(q), t(k), t(v), t(out), lse, t(do),
                                     bool(is_causal), scale)
    return t(dq), t(dk), t(dv)


class _FlashSDPA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, is_causal):
        out, lse = _flash_sdpa_fwd(q, k, v, scale=scale, is_causal=is_causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.is_causal = scale, is_causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_sdpa_vjp(do, q, k, v, out, lse, scale=ctx.scale,
                                     is_causal=ctx.is_causal)
        return dq, dk, dv, None, None


def flash_sdpa(query, key, value, scale: float, is_causal: bool = False):
    """Flash attention with the flash kernels as forward and backward.
    (B, S, H, D) in; returns (out (B, S, H, D), lse (B, H, S) f32), lse
    not differentiable."""
    return _FlashSDPA.apply(query, key, value, float(scale), bool(is_causal))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True) -> torch.Tensor:
    """q/k/v: (batch, seq, heads, head_dim).  No mask and no dropout:
    ``flash_sdpa`` at every sequence length, on every device; otherwise the
    plain ``sdpa``."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    if dropout_p > 0.0 and training:
        return sdpa(query, key, value, attn_mask, scale, is_causal,
                    dropout_p=float(dropout_p))
    if attn_mask is None:
        return flash_sdpa(query, key, value, scale, is_causal)[0]
    return sdpa(query, key, value, attn_mask, scale, is_causal)
