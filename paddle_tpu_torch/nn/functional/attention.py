"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/attention.py``).

Layouts follow the reference: q/k/v are ``(batch, seq, num_heads,
head_dim)``; k/v may have fewer heads (grouped-query attention).

Dispatch: attention with no mask and no dropout takes ``flash_sdpa``, a
``torch.autograd.Function`` over the flash kernels
(``ops/cuda/flash_attention.py``: on CUDA tensors the CUDA kernels, on CPU
tensors their plain versions, through the same Function), wherever the
kernels take the call (``flash_refusal``): head_dim a multiple of 16 in
16..256, Sq == Sk when causal, float32/float16/bfloat16.  A head_dim up to
256 that is not a multiple of 16 is zero-padded to the next one
(``padded_head_dim``) and still takes the kernels.  The plain ``sdpa`` (its
causal mask bottom-right aligned, ``tril(diagonal=Sk - Sq)``, as the
reference's) takes every call with a mask or training dropout, and what
the reference's own gate (``fallback_reason``) and dtypes send to its plain
path: causal with Sq != Sk, head_dim above 256, dtypes other than the
three.  This is the port's ``_should_use_pallas`` minus the reference's
TPU tuning (TPU only, seq >= 1024, the 512/256/128 tile rule), which on
the card would quietly send training below seq 1024 to the plain path.

Packed sequences (``flash_attn_unpadded``, ``(total_tokens, heads,
head_dim)`` with ``cu_seqlens``) take ``_FlashVarlen``, the same kind of
Function over the varlen kernels, at every length on every device (the
reference's ``t < 1024`` gate and platform check are not ported either),
behind the same gate; training dropout and cross-attention packing
(``cu_seqlens_q`` not equal to ``cu_seqlens_k``) take ``_varlen_core``,
the plain dense math, as the gate's refusals do.

No route is silent: each call adds one to ``ROUTE_COUNTS`` under
``"sdpa_flash"``, ``"varlen_flash"``, ``"<sdpa|varlen>_flash_padded"`` or
``"<sdpa|varlen>_plain:<reason>"``, the reason one of ``dropout``,
``mask``, ``packing``, ``head_dim``, ``causal_rect`` (causal with Sq !=
Sk) and ``dtype``; ``reset_route_counts()`` clears it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...ops.cuda.flash_attention import (flash_attention_bwd,
                                         flash_attention_fwd, flash_refusal,
                                         padded_head_dim, segment_ids,
                                         varlen_flash_bwd, varlen_flash_fwd)
from ...ops.op import register_op

__all__ = ["scaled_dot_product_attention", "flash_sdpa", "sdpa",
           "flash_attention", "flash_attn_unpadded", "sdp_kernel",
           "ROUTE_COUNTS", "reset_route_counts"]

# One count per call: "<path>[:<reason>]", e.g. "sdpa_flash" or
# "sdpa_plain:head_dim".  Where LAUNCH_COUNTS says which kernels ran, this
# says which route a call took and why.
ROUTE_COUNTS = {}


def reset_route_counts() -> None:
    ROUTE_COUNTS.clear()


def _route(name: str) -> None:
    ROUTE_COUNTS[name] = ROUTE_COUNTS.get(name, 0) + 1


def _flash_gate(kind: str, query, key, causal: bool) -> Optional[int]:
    """Count the route of a call with no mask and no dropout (``kind`` is
    ``sdpa`` or ``varlen``; query/key (B, S, H, D) or packed (T, H, D)) and
    return the head_dim at which it takes the flash kernels, or None for
    the plain path."""
    d = query.shape[-1]
    dp = padded_head_dim(d)
    # the kernels' limit is the reference kernel's (256): above it, the
    # plain path, as the reference routes it
    reason = flash_refusal(query.shape[-3], key.shape[-3], dp, query.dtype,
                           causal)
    if reason is not None:
        _route(f"{kind}_plain:{reason}")
        return None
    _route(f"{kind}_flash" if dp == d else f"{kind}_flash_padded")
    return dp


def _pad(x, dp: int):
    d = x.shape[-1]
    return x if dp == d else torch.nn.functional.pad(x, (0, dp - d))


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
    return _apply_v(probs, value)


def _apply_v(probs, value):
    h, hkv = probs.shape[1], value.shape[2]
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
                                 training: bool = True,
                                 name=None) -> torch.Tensor:
    """q/k/v: (batch, seq, heads, head_dim).  No mask and no dropout:
    ``flash_sdpa`` at every sequence length, on every device, where the
    kernels take the call, head_dim zero-padded to a multiple of 16
    (``_flash_gate``); otherwise the plain ``sdpa``.  The route is counted
    in ``ROUTE_COUNTS``."""
    d = query.shape[-1]
    scale = 1.0 / math.sqrt(d)
    if dropout_p > 0.0 and training:
        _route("sdpa_plain:dropout")
        return sdpa(query, key, value, attn_mask, scale, is_causal,
                    dropout_p=float(dropout_p))
    if attn_mask is not None:
        _route("sdpa_plain:mask")
        return sdpa(query, key, value, attn_mask, scale, is_causal)
    dp = _flash_gate("sdpa", query, key, is_causal)
    if dp is None:
        return sdpa(query, key, value, None, scale, is_causal)
    out = flash_sdpa(_pad(query, dp), _pad(key, dp), _pad(value, dp), scale,
                     is_causal)[0]
    return out if dp == d else out[..., :d]


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """Compat shim of Paddle's ``flash_attention`` (the reference's):
    (batch, seq, heads, head_dim) in; returns (out, None), the softmax is
    never returned."""
    return scaled_dot_product_attention(query, key, value, None, dropout,
                                        causal, training), None


def _varlen_core(q, k, v, cu_q, cu_k, scale: float, causal: bool,
                 dropout_p: float = 0.0, generator=None) -> torch.Tensor:
    """Plain dense attention over packed tokens (the reference's
    ``varlen_sdpa`` and ``varlen_sdpa_dropout`` ops): q (Tq, H, D), k/v
    (Tk, Hkv, D).  A query sees the keys of its own segment (segment ids
    from ``cu_q`` and ``cu_k``), at or before its own position inside the
    segment when causal; logits in the input type, then an f32 softmax;
    rows with no visible key give 0.  With ``dropout_p`` the probabilities
    are dropped with ``torch.rand`` (from ``generator``, torch's default
    when None: compare with the reference statistically, never draw for
    draw) and rescaled by 1 / (1 - p).  Differentiated by autograd."""
    h, hkv = q.shape[1], k.shape[1]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    cu_q = cu_q.reshape(-1).to(torch.int32)
    cu_k = cu_k.reshape(-1).to(device=cu_q.device, dtype=torch.int32)
    seg_q, seg_k = segment_ids(cu_q, q.shape[0]), segment_ids(cu_k,
                                                              k.shape[0])
    # a stretch before cu[0] has id -1 and its start is cu[-1], as the
    # reference's negative index gives
    loc_q = torch.arange(q.shape[0], device=q.device) - cu_q[seg_q]
    loc_k = torch.arange(k.shape[0], device=q.device) - cu_k[seg_k]
    logits = torch.einsum("qhd,khd->hqk", q, k).float() * scale
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        mask = mask & (loc_q[:, None] >= loc_k[None, :])
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs,
                        torch.zeros_like(probs))
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, device=probs.device,
                          generator=generator) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    return torch.einsum("hqk,khd->qhd", probs.to(q.dtype), v)


class _FlashVarlen(torch.autograd.Function):
    """The varlen kernels as forward and backward over (T, H, D) tensors:
    the kernels read (H, T, D) views of the same memory.  Saves out and
    lse; lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, cu, scale, causal):
        t = lambda x: x.transpose(0, 1)  # noqa: E731
        out, lse = varlen_flash_fwd(t(q), t(k), t(v), cu, causal, scale)
        out = t(out)
        ctx.save_for_backward(q, k, v, cu, out, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, cu, out, lse = ctx.saved_tensors
        t = lambda x: x.transpose(0, 1)  # noqa: E731
        dq, dk, dv = varlen_flash_bwd(t(q), t(k), t(v), cu, t(out), lse,
                                      t(do), ctx.causal, ctx.scale)
        return t(dq), t(dk), t(dv), None, None, None


def _same_packing(query, key, cu_q, cu_k) -> bool:
    """Do q and k/v share one packing?  Identity first (the common call
    passes one tensor twice), so that only a call with two cu tensors pays
    ``torch.equal``'s host sync."""
    if query.shape[0] != key.shape[0]:
        return False
    if cu_q is cu_k:
        return True
    return (cu_q.shape == cu_k.shape and cu_q.device == cu_k.device
            and torch.equal(cu_q.to(torch.int32), cu_k.to(torch.int32)))


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Attention over ``cu_seqlens``-packed tokens (Paddle's
    ``flash_attn_unpadded``): query (Tq, H, D), key/value (Tk, Hkv, D),
    ``cu_seqlens_*`` (batch + 1,) int32 prefix sums.  Returns (out like
    query, None).  ``max_seqlen_*`` are not needed.

    Training dropout, q and k/v packed differently, and what the flash
    gate refuses (``_flash_gate``) take the plain dense ``_varlen_core``;
    otherwise ``_FlashVarlen`` (the varlen kernels on the card, their plain
    versions on the CPU), head_dim zero-padded to a multiple of 16.  The
    route is counted in ``ROUTE_COUNTS``."""
    if dropout and training:
        _route("varlen_plain:dropout")
        return _varlen_core(query, key, value, cu_seqlens_q, cu_seqlens_k,
                            float(scale), bool(causal), float(dropout)), None
    if not _same_packing(query, key, cu_seqlens_q, cu_seqlens_k):
        _route("varlen_plain:packing")
        dp = None
    else:
        dp = _flash_gate("varlen", query, key, bool(causal))
    if dp is None:
        return _varlen_core(query, key, value, cu_seqlens_q, cu_seqlens_k,
                            float(scale), bool(causal)), None
    d = query.shape[-1]
    out, _ = _FlashVarlen.apply(_pad(query, dp), _pad(key, dp),
                                _pad(value, dp), cu_seqlens_q, float(scale),
                                bool(causal))
    return (out if dp == d else out[..., :d]), None


class sdp_kernel:
    """Context-manager compat shim (``paddle.nn.functional.sdp_kernel``):
    selects nothing."""

    def __init__(self, enable_flash=True, enable_math=True,
                 enable_mem_efficient=True) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# -- the reference's registry ops over these functionals --------------------
# On CUDA tensors flash_sdpa and varlen_flash launch the flash kernels
# (flash_fwd, varlen_fwd; their backward flash_dq/flash_dkv, varlen_dq/
# varlen_dkv), as the model's attention does.  lse comes back with the
# reference's trailing axis of 1.

def _flash_sdpa_op(q, k, v, *, scale, is_causal):
    out, lse = flash_sdpa(q, k, v, scale, is_causal)
    return out, lse.unsqueeze(-1)


def _sdpa_dropout_op(q, k, v, mask, generator, *, p, scale, is_causal):
    """``sdpa`` with the probabilities dropped by the reference's mask
    (``fast_keep_mask``: p quantised to 1/256 unless exact) drawn from
    ``generator``."""
    from .common import fast_keep_mask
    probs = _sdpa_probs(q, k, mask, scale, is_causal)
    keep, keep_p = fast_keep_mask(generator, p, probs.shape, probs.device)
    probs = torch.where(keep, probs, torch.zeros_like(probs)) / \
        torch.tensor(keep_p, dtype=probs.dtype)
    return _apply_v(probs, v)


def _varlen_flash_op(q, k, v, cu, *, scale, causal):
    out, lse = _FlashVarlen.apply(q, k, v, cu, float(scale), bool(causal))
    return out, lse.unsqueeze(-1)


register_op("flash_sdpa", _flash_sdpa_op, "attention")
register_op("sdpa", lambda q, k, v, mask, *, scale, is_causal: sdpa(
    q, k, v, mask, scale, is_causal), "attention")
register_op("sdpa_dropout", _sdpa_dropout_op, "attention")
register_op("varlen_flash", _varlen_flash_op, "attention")
register_op("varlen_sdpa", lambda q, k, v, cu_q, cu_k, *, scale, causal:
            _varlen_core(q, k, v, cu_q, cu_k, scale, causal), "attention")
register_op("varlen_sdpa_dropout",
            lambda q, k, v, cu_q, cu_k, generator, *, scale, causal, p:
            _varlen_core(q, k, v, cu_q, cu_k, scale, causal, p, generator),
            "attention")
