"""Ragged paged attention decode: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/attention.py``
``ragged_paged_attention_decode`` (TPU kernels ``_rpa_decode_kernel`` and,
over int8 pools with f32 scale pools, ``_rpa_decode_kernel_quant``); the
kernel is ``csrc/rpa_decode.cu`` (entry points ``rpa_decode`` and
``rpa_decode_quant``).

``ragged_paged_attention_decode`` checks its arguments, then computes the
plain version for CPU tensors and launches the kernel for CUDA tensors —
there is no other route, and no fallback from a failed build or launch.
``LAUNCH_COUNTS`` counts kernel launches (plain-version calls do not
count), so a run can show that its decode steps went through the kernel.

The kernel splits each sequence into splits of a fixed number of pages
(``rpa_decode_split_pages()`` of the library), a thread block each; the
number of splits comes from the block table's width, so the wrapper never
reads ``seq_lens`` on the host.  Sequences longer than one split merge
their partial softmaxes in a workspace that the wrapper keeps per (device,
stream) (``_workspace``): its counters are zeroed once and every launch
leaves them at 0.  A call made while its stream is captured into a CUDA
graph gets a workspace of its own, allocated (and zeroed) in the capture,
so that no graph's private memory enters the cache.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["ragged_paged_attention_decode",
           "ragged_paged_attention_decode_ref", "LAUNCH_COUNTS",
           "reset_launch_counts", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256
_BIG_NEG = -1e30   # finite, as the TPU kernel: masked scores, never -inf
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# a Hopper block may opt in to 227 KB of shared memory
_MAX_SMEM_BYTES = 232448

LAUNCH_COUNTS = {"rpa_decode": 0, "rpa_decode_quant": 0}

# (device index, stream) -> (partial outputs f32, partial max and sum f32,
# counters int32): the split merge's workspace, grown when a larger shape
# comes; the counters are zeroed when allocated and each launch leaves
# them at 0, so two streams never share them
_WORKSPACE = {}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _check_args(q, k_pages, v_pages, block_tables, seq_lens,
                k_scales=None, v_scales=None) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, D), got shape {tuple(q.shape)}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k_pages/v_pages must both be (num_pages, page, Hkv, D), got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    b, h, d = q.shape
    hkv = k_pages.shape[2]
    if k_pages.shape[3] != d:
        raise ValueError(f"head_dim mismatch: q has {d}, pools have "
                         f"{k_pages.shape[3]}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} is not supported")
    if h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads "
                         f"({hkv})")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}; expected float32, "
                        f"float16 or bfloat16")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if k_scales is None:
        if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
            raise TypeError(f"q and the pools must share one dtype, got "
                            f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    else:
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise TypeError(f"with scales the pools hold int8 codes, got "
                            f"{k_pages.dtype}/{v_pages.dtype}")
        want = (*k_pages.shape[:3], 1)
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if tuple(t.shape) != want or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 {want} (one scale "
                                 f"per token and kv head), got {t.dtype} "
                                 f"{tuple(t.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be (B={b}, P), got "
                         f"{tuple(block_tables.shape)}")
    if seq_lens.shape != (b,):
        raise ValueError(f"seq_lens must be (B={b},), got "
                         f"{tuple(seq_lens.shape)}")
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
    devices = {t.device for t in (q, k_pages, v_pages, block_tables,
                                  seq_lens, k_scales, v_scales)
               if t is not None}
    if len(devices) != 1:
        raise ValueError(f"all arguments must be on one device, got "
                         f"{sorted(str(x) for x in devices)}")


def _scale(q, scale) -> float:
    """The softmax scale of the decode, dense and ragged kernels.  The
    reference's wrappers read ``scale or 1 / sqrt(d)``, so a falsy scale
    (None or 0) means the default there, and here."""
    return float(scale) if scale else 1.0 / math.sqrt(q.shape[-1])


def ragged_paged_attention_decode_ref(q, k_pages, v_pages, block_tables,
                                      seq_lens, scale: Optional[float] = None,
                                      k_scales=None, v_scales=None):
    """Plain PyTorch version of the decode kernel: gather every table page
    (int8 codes times their scales, in f32, after the gather), f32 scores,
    positions >= len masked with -1e30 and p forced to 0, and len == 0 rows
    giving exact zeros.  q: (B, H, D); returns (B, H, D) in q's dtype."""
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    scale = _scale(q, scale)
    bt = block_tables.long()
    t = bt.shape[1] * page
    k = k_pages[bt].reshape(b, t, hkv, d).float()
    v = v_pages[bt].reshape(b, t, hkv, d).float()
    if k_scales is not None:
        k = k * k_scales[bt].reshape(b, t, hkv, 1)
        v = v * v_scales[bt].reshape(b, t, hkv, 1)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), k) * scale
    valid = (torch.arange(t, device=q.device)[None, :]
             < seq_lens.long()[:, None])[:, None, :]          # (B, 1, T)
    s = torch.where(valid, s, torch.full_like(s, _BIG_NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bht,bthd->bhd", p, v) / torch.where(
        l > 0, l, torch.ones_like(l))
    return out.to(q.dtype)


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("rpa_decode")
        tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.rpa_decode.argtypes = [ctypes.c_void_p] * 9 + tail
        lib.rpa_decode.restype = ctypes.c_int
        lib.rpa_decode_quant.argtypes = [ctypes.c_void_p] * 11 + tail
        lib.rpa_decode_quant.restype = ctypes.c_int
        lib.rpa_decode_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.rpa_decode_smem_bytes.restype = ctypes.c_size_t
        lib.rpa_decode_split_pages.argtypes = []
        lib.rpa_decode_split_pages.restype = ctypes.c_int
        lib.split_pages = lib.rpa_decode_split_pages()
        lib.rpa_decode_error_string.argtypes = [ctypes.c_int]
        lib.rpa_decode_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _workspace(device, stream: int, partials: int, d: int,
               counters: int):
    """The split merge's workspace for (device, stream), grown to hold
    ``partials`` partial rows of ``d`` and ``counters`` counters; not
    cached while the stream is captured."""
    if torch.cuda.is_current_stream_capturing():
        return (torch.empty(partials * d, dtype=torch.float32, device=device),
                torch.empty(partials * 2, dtype=torch.float32, device=device),
                torch.zeros(counters, dtype=torch.int32, device=device))
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    want = (partials * d, partials * 2, counters)
    if ws is None or any(t.numel() < n for t, n in zip(ws, want)):
        have = (0, 0, 0) if ws is None else tuple(t.numel() for t in ws)
        n_acc, n_ml, n_cnt = (max(a, b) for a, b in zip(want, have))
        ws = (torch.empty(n_acc, dtype=torch.float32, device=device),
              torch.empty(n_ml, dtype=torch.float32, device=device),
              torch.zeros(n_cnt, dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
    return ws


def _launch(q, k_pages, v_pages, block_tables, seq_lens, scale: float,
            k_scales=None, v_scales=None):
    pools = [k_pages, v_pages] + ([] if k_scales is None
                                  else [k_scales, v_scales])
    if not all(t.is_contiguous() for t in pools):
        raise ValueError("k_pages/v_pages (and their scales) must be "
                         "contiguous")
    lib = _lib()
    b, h, d = q.shape
    num_pages, page, hkv, _ = k_pages.shape
    groups = h // hkv
    smem = lib.rpa_decode_smem_bytes(groups, d, k_pages.element_size())
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{groups} query heads per kv head at head_dim "
                         f"{d} need {smem} bytes of shared memory per block "
                         f"(> {_MAX_SMEM_BYTES})")
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    max_pages = bt.shape[1]
    splits = max(1, -(-max_pages // lib.split_pages))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ws = (None, None, None)
        if splits > 1:
            ws = tuple(t.data_ptr() for t in _workspace(
                q.device, stream, b * h * splits, d,
                b * hkv * -(-groups // 8)))
        dims = (out.data_ptr(), *ws, b, h, hkv, d, page, num_pages,
                max_pages, scale, _DTYPE_CODES[q.dtype], stream)
        if k_scales is None:
            name = "rpa_decode"
            rc = lib.rpa_decode(q.data_ptr(), k_pages.data_ptr(),
                                v_pages.data_ptr(), bt.data_ptr(),
                                sl.data_ptr(), *dims)
        else:
            name = "rpa_decode_quant"
            rc = lib.rpa_decode_quant(q.data_ptr(), k_pages.data_ptr(),
                                      v_pages.data_ptr(), k_scales.data_ptr(),
                                      v_scales.data_ptr(), bt.data_ptr(),
                                      sl.data_ptr(), *dims)
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: error {rc} "
            f"({lib.rpa_decode_error_string(rc).decode()})")
    LAUNCH_COUNTS[name] += 1
    return out


def ragged_paged_attention_decode(q, k_pages, v_pages, block_tables,
                                  seq_lens, scale: Optional[float] = None,
                                  k_scales=None, v_scales=None):
    """Paged attention for one query token per sequence.

    ``q``: (B, H, D).  ``k_pages``/``v_pages``: (num_pages, page, Hkv, D),
    H % Hkv == 0, D <= 256, one dtype shared with q (float32, float16 or
    bfloat16) — or, with ``k_scales``/``v_scales`` (float32 (num_pages,
    page, Hkv, 1), one scale per token and kv head), int8 codes.
    ``block_tables``: (B, P) page ids, padded with page 0.
    ``seq_lens``: (B,) valid tokens per sequence INCLUDING the current one;
    0 marks an inert slot, which outputs zeros.  ``scale``: None or 0
    means 1 / sqrt(D), as in the reference.  Returns (B, H, D) in q's
    dtype.  CPU tensors get the plain version; CUDA tensors the kernel."""
    _check_args(q, k_pages, v_pages, block_tables, seq_lens, k_scales,
                v_scales)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_decode_ref(q, k_pages, v_pages,
                                                 block_tables, seq_lens,
                                                 scale, k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, scale,
                   k_scales, v_scales)
