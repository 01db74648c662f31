"""Paged-attention ops: KV-page writes and copies, and attention gathered
through block tables (counterpart of ``paddle_tpu/serving/attention.py``).

* ``paged_kv_update`` — write one step's new K/V rows into the pools at
  flat ``(page, offset)`` slots, in place.  Padding rows target page 0, the
  reserved sink.
* ``paged_kv_update_quant`` — the same into an int8 pool
  (``FLAGS_serving_kv_quant``): each new (Hkv, D) row becomes int8 codes
  plus one f32 scale per head_dim vector, written into the code pools and
  the (pages, page, Hkv, 1) scale pools at the same slots.
* ``paged_kv_copy`` — whole-page (src → dst) copies inside a pair of pools
  (codes or scales), the device half of the prefix cache's copy-on-write.
  Every source page is gathered before any destination is written, so
  chained copies read the pre-step content.  Padding pairs are (0, 0):
  page 0 onto itself.
* ``paged_attention_torch`` — queries attend over K/V gathered through the
  block tables (int8 codes dequantized to q's dtype right after the
  gather), masked to ``kv_pos <= q_pos`` and ``kv_pos < seq_len``.
  Prefill chunks always take this path.

``PagedCacheView`` is the per-layer handle the Llama forward receives.  Its
decode dispatch: with the kernel selected and one query token per sequence,
attention goes to ``ops/cuda/attention.ragged_paged_attention_decode``
(with the scale pools, for an int8 pool), which launches the CUDA kernel
for CUDA tensors (its plain version serves CPU tensors).

The pools are updated in place: that stands in for the reference's donated
jit buffers.
"""

from __future__ import annotations

import torch

from ..flags import get_flags
from ..ops.op import register_op
from ..ops.cuda.attention import ragged_paged_attention_decode
from ..quantize.core import quantize_kv_rows

__all__ = ["PagedCacheView", "paged_attention_torch", "paged_kv_update",
           "paged_kv_update_quant", "paged_kv_copy", "use_rpa_kernel"]

_BIG_NEG = -1e30


def paged_kv_update(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    slot_pages: torch.Tensor,
                    slot_offsets: torch.Tensor) -> None:
    """k_new/v_new: (B, S, Hkv, D) → flat (B*S) rows written at
    (slot_pages[i], slot_offsets[i])."""
    hkv, d = k_new.shape[-2], k_new.shape[-1]
    idx = (slot_pages.long(), slot_offsets.long())
    k_pages.index_put_(idx, k_new.reshape(-1, hkv, d).to(k_pages.dtype))
    v_pages.index_put_(idx, v_new.reshape(-1, hkv, d).to(v_pages.dtype))


def paged_kv_update_quant(k_pages: torch.Tensor, v_pages: torch.Tensor,
                          k_scales: torch.Tensor, v_scales: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          slot_pages: torch.Tensor,
                          slot_offsets: torch.Tensor) -> None:
    """Quantize-on-write into the int8 pool: k_new/v_new (B, S, Hkv, D) →
    int8 codes into the code pools and one f32 scale per (row, head) into
    the scale pools, at (slot_pages[i], slot_offsets[i])."""
    hkv, d = k_new.shape[-2], k_new.shape[-1]
    # K and V in one pass: the scales are per row, so stacking changes no
    # byte, and a decode step makes this call once a layer
    q, s = quantize_kv_rows(torch.stack([k_new.reshape(-1, hkv, d),
                                         v_new.reshape(-1, hkv, d)]))
    idx = (slot_pages.long(), slot_offsets.long())
    k_pages.index_put_(idx, q[0])
    v_pages.index_put_(idx, q[1])
    k_scales.index_put_(idx, s[0])
    v_scales.index_put_(idx, s[1])


def paged_kv_copy(k_pages: torch.Tensor, v_pages: torch.Tensor,
                  src_pages: torch.Tensor, dst_pages: torch.Tensor) -> None:
    s = src_pages.long()
    d = dst_pages.long()
    for pool in (k_pages, v_pages):
        gathered = pool[s]          # a copy: every source read first
        pool.index_put_((d,), gathered)


def paged_attention_torch(q, k_pages, v_pages, block_tables, seq_lens,
                          q_pos, scale: float, k_scales=None,
                          v_scales=None) -> torch.Tensor:
    """Gather each sequence's pages and run a masked softmax (the port of
    ``paged_attention_xla``).  q: (B, S, H, D); returns (B, S, H, D).  A
    row with no valid key outputs 0.  With ``k_scales``/``v_scales`` the
    pools hold int8 codes, dequantized after the gather (in f32, then
    rounded to q's dtype, as the reference does)."""
    b, s, h, d = q.shape
    page = k_pages.shape[1]
    hkv = k_pages.shape[2]
    bt = block_tables.long()
    t = bt.shape[1] * page
    k = k_pages[bt].reshape(b, t, hkv, d)
    v = v_pages[bt].reshape(b, t, hkv, d)
    if k_scales is not None:
        k = (k.float() * k_scales[bt].reshape(b, t, hkv, 1)).to(q.dtype)
        v = (v.float() * v_scales[bt].reshape(b, t, hkv, 1)).to(q.dtype)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    kv_pos = torch.arange(t, device=q.device)
    mask = ((kv_pos[None, None, :] < seq_lens.long()[:, None, None])
            & (kv_pos[None, None, :] <= q_pos.long()[:, :, None]))
    mask = mask[:, None]                                  # (B, 1, S, T)
    logits = torch.where(mask, logits, torch.full_like(logits, _BIG_NEG))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs,
                        torch.zeros_like(probs))
    return torch.einsum("bhst,bthd->bshd", probs.to(q.dtype), v)


def use_rpa_kernel(device: torch.device) -> bool:
    """Dispatch gate for the decode kernel: FLAGS_serving_use_rpa_kernel
    'auto' = the kernel on a CUDA device; 'on'/'off' force."""
    mode = str(get_flags("serving_use_rpa_kernel")).strip().lower()
    if mode in ("on", "1", "true"):
        return True
    if mode in ("off", "0", "false"):
        return False
    return torch.device(device).type == "cuda"


class PagedCacheView:
    """One layer's cache handle inside a serving step: the layer's pools
    (and, for an int8 pool, its scale pools) plus the step's shared
    table/slot tensors."""

    def __init__(self, k_pages, v_pages, block_tables, seq_lens, slot_pages,
                 slot_offsets, q_pos, scale: float, kernel: bool,
                 k_scales=None, v_scales=None) -> None:
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.k_scales = k_scales
        self.v_scales = v_scales
        self._bt = block_tables
        self._sl = seq_lens
        self._sp = slot_pages
        self._so = slot_offsets
        self._qp = q_pos
        self._scale = float(scale)
        self._kernel = bool(kernel)

    def update(self, k: torch.Tensor, v: torch.Tensor) -> None:
        if self.k_scales is not None:
            paged_kv_update_quant(self.k_pages, self.v_pages, self.k_scales,
                                  self.v_scales, k, v, self._sp, self._so)
        else:
            paged_kv_update(self.k_pages, self.v_pages, k, v, self._sp,
                            self._so)

    def attend(self, q: torch.Tensor) -> torch.Tensor:
        if self._kernel and q.shape[1] == 1:
            out = ragged_paged_attention_decode(
                q[:, 0], self.k_pages, self.v_pages, self._bt, self._sl,
                scale=self._scale, k_scales=self.k_scales,
                v_scales=self.v_scales)
            return out[:, None]
        return paged_attention_torch(q, self.k_pages, self.v_pages, self._bt,
                                     self._sl, self._qp, self._scale,
                                     self.k_scales, self.v_scales)


# -- the reference's registry ops ---------------------------------------------
# The paged-KV writes update the pools in place and return them (the
# reference returns new pools with the same values); on CUDA tensors the
# decode ops with kernel=True launch rpa_decode / rpa_decode_quant, as the
# engine's decode step does.

def _paged_kv_update_op(k_pages, v_pages, k_new, v_new, slot_pages,
                        slot_offsets):
    paged_kv_update(k_pages, v_pages, k_new, v_new, slot_pages,
                    slot_offsets)
    return k_pages, v_pages


def _paged_kv_update_quant_op(k_pages, v_pages, k_scales, v_scales, k_new,
                              v_new, slot_pages, slot_offsets):
    paged_kv_update_quant(k_pages, v_pages, k_scales, v_scales, k_new,
                          v_new, slot_pages, slot_offsets)
    return k_pages, v_pages, k_scales, v_scales


def _paged_kv_copy_op(k_pages, v_pages, src_pages, dst_pages):
    paged_kv_copy(k_pages, v_pages, src_pages, dst_pages)
    return k_pages, v_pages


def _paged_attention_op(q, k_pages, v_pages, block_tables, seq_lens, q_pos,
                        *, scale, kernel, k_scales=None, v_scales=None):
    return PagedCacheView(k_pages, v_pages, block_tables, seq_lens, None,
                          None, q_pos, scale, kernel, k_scales,
                          v_scales).attend(q)


register_op("paged_kv_update", _paged_kv_update_op)
register_op("paged_kv_update_quant", _paged_kv_update_quant_op)
register_op("paged_kv_copy", _paged_kv_copy_op)
register_op("paged_attention", _paged_attention_op)
register_op("paged_attention_quant",
            lambda q, k_pages, v_pages, k_scales, v_scales, block_tables,
            seq_lens, q_pos, *, scale, kernel: _paged_attention_op(
                q, k_pages, v_pages, block_tables, seq_lens, q_pos,
                scale=scale, kernel=kernel, k_scales=k_scales,
                v_scales=v_scales))
