"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/attention.py``; the kernels are
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, one kernel of each kind
templated on its mask (``csrc/flash_common.cuh``):

- dense: ``_flash_fwd`` (TPU kernel ``_fwd_kernel``) and ``_flash_bwd``
  (``_dq_kernel``, ``_dkv_kernel``), layout ``(B, H, S, D)``;
- the backward's pre-pass ``flash_bwd_delta``: delta = rowsum(dO * O), f32,
  which both TPU backward kernels recompute inside every tile; the
  backward launches it once and hands it to its dq and dk/dv kernels
  (``delta=``), which then read no O;
- packed sequences (varlen): ``_varlen_flash_fwd`` (``_varlen_fwd_kernel``)
  and ``_varlen_flash_bwd`` (``_varlen_dq_kernel``,
  ``_varlen_dkv_kernel``), layout ``(H, T, D)`` with ``cu_seqlens``;
- ragged lengths: ``flash_attention_ragged_bhsd`` (``_ragged_fwd_kernel``),
  forward only.

k and v may have fewer heads (``H % Hkv == 0``, query head h reads kv head
``h // (H // Hkv)``; not the ragged kernel, which takes k/v with q's heads
as its TPU kernel does), and the backward returns dk/dv with the kv heads'
shape, summed over each group.  ``lse`` is float32 ``(B, H, S)`` (varlen:
``(H, T)``).  Each wrapper checks its arguments, then computes the plain
version for CPU tensors and launches its kernel for CUDA tensors: there is
no other route, and no fallback from a failed build or launch.
``LAUNCH_COUNTS`` counts kernel launches only.  The TPU kernels' shape
rules (T or S a multiple of 128, the 512/256/128 tile choice, the 128-lane
lse) are not the kernels' limits here: any length is taken.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .attention import _DTYPE_CODES, LAUNCH_COUNTS, _scale

__all__ = ["flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_bwd", "flash_attention_fwd_ref",
           "flash_attention_dq_ref", "flash_attention_dkv_ref",
           "flash_attention_bwd_ref", "varlen_flash_fwd", "varlen_flash_dq",
           "varlen_flash_dkv", "varlen_flash_bwd", "varlen_flash_fwd_ref",
           "varlen_flash_dq_ref", "varlen_flash_dkv_ref",
           "varlen_flash_bwd_ref", "flash_attention_ragged_bhsd",
           "flash_attention_ragged_bhsd_ref", "flash_bwd_delta",
           "flash_bwd_delta_ref", "flash_refusal", "padded_head_dim",
           "MAX_HEAD_DIM"]

# the kernels take D in 16-element steps (one mma.sync or wgmma k-step, and
# two n-tiles of 8 for each ldmatrix.x4), up to the reference kernels' 256
MAX_HEAD_DIM = 256
_HEAD_DIM_STEP = 16
_BIG_NEG = -1e30   # finite, as the kernels: masked scores, never -inf
_MAX_SMEM_BYTES = 232448

LAUNCH_COUNTS.update({"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                      "flash_bwd_delta": 0, "varlen_fwd": 0, "varlen_dq": 0,
                      "varlen_dkv": 0, "ragged_fwd": 0})


def flash_refusal(seq_q: int, seq_k: int, head_dim: int, dtype,
                  causal: bool = False) -> Optional[str]:
    """Why the flash kernels cannot take a call, or None: the port's
    counterpart of the reference's ``fallback_reason``.  In this order:
    ``"causal_rect"`` (causal with Sq != Sk: the kernels' mask is the
    square lower triangle), ``"dtype"`` (not float32, float16 or bfloat16)
    and ``"head_dim"`` (not a multiple of 16 in 16..256).  The wrappers
    raise on the reason; the attention functionals route on it."""
    if causal and seq_q != seq_k:
        return "causal_rect"
    if dtype not in _DTYPE_CODES:
        return "dtype"
    if (head_dim % _HEAD_DIM_STEP
            or not _HEAD_DIM_STEP <= head_dim <= MAX_HEAD_DIM):
        return "head_dim"
    return None


def padded_head_dim(head_dim: int) -> int:
    """The head_dim at which the flash kernels take ``head_dim`` once q, k
    and v are zero-padded: the next multiple of 16 (zero columns add
    nothing to q.k and give output columns that are cut off)."""
    return -(-head_dim // _HEAD_DIM_STEP) * _HEAD_DIM_STEP


def _check(q, k, v, causal, *, out=None, lse=None, do=None,
           delta=None) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"q must be (B, H, Sq, D) and k/v both (B, Hkv, Sk, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head_dim")
    if h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads "
                         f"({hkv})")
    if sq < 1 or sk < 1:
        raise ValueError(f"sequence lengths must be >= 1, got Sq={sq}, "
                         f"Sk={sk}")
    reason = flash_refusal(sq, sk, d, q.dtype, causal)
    if reason == "head_dim":
        raise ValueError(
            f"head_dim {d} is not supported: the flash kernels take a "
            f"multiple of {_HEAD_DIM_STEP} up to {MAX_HEAD_DIM}")
    if reason == "causal_rect":
        raise ValueError(f"causal attention needs Sq == Sk (the mask is "
                         f"the square lower triangle), got Sq={sq}, "
                         f"Sk={sk}")
    if reason == "dtype":
        raise TypeError(f"unsupported dtype {q.dtype}; expected float32, "
                        f"float16 or bfloat16")
    tensors = [q, k, v]
    for name, t in (("out", out), ("do", do)):
        if t is not None:
            if t.shape != q.shape:
                raise ValueError(f"{name} must have q's shape "
                                 f"{tuple(q.shape)}, got {tuple(t.shape)}")
            tensors.append(t)
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"q, k, v (and out, do) must share one dtype, got "
                        f"{[str(t.dtype) for t in tensors]}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None:
            if t.shape != (b, h, sq) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 (B, H, Sq) = "
                                 f"{(b, h, sq)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            tensors.append(t)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all arguments must be on one device, got "
                         f"{sorted(str(x) for x in devices)}")


def _varlen_scale(q, scale) -> float:
    """The varlen kernels' softmax scale.  The reference passes the
    functional's scale through as it is, so only None means 1 / sqrt(d)."""
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _expand_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    hkv = x.shape[1]
    return x if hkv == heads else x.repeat_interleave(heads // hkv, dim=1)


def _visible(sq: int, sk: int, causal: bool, device) -> torch.Tensor:
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    return mask.tril() if causal else mask


def _fwd_ref(q, k, v, vis, scale):
    """The forward kernels' arithmetic over (B, H, Sq, D) with a boolean
    mask ``vis`` that broadcasts to (B, H, Sq, Sk): f32 scores, masked
    scores -1e30 with probability 0, f32 softmax, probabilities rounded to
    the input type for the PV product; rows with no visible key give out 0
    and lse -1e30.  Returns (out in q's dtype, lse f32 (B, H, Sq))."""
    h = q.shape[1]
    kf = _expand_kv(k, h).float()
    vf = _expand_kv(v, h).float()
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    s = torch.where(vis, s, torch.full_like(s, _BIG_NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(q.dtype).float(), vf)
    out = torch.where(l > 0, out / torch.where(l > 0, l, torch.ones_like(l)),
                      torch.zeros_like(out))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, _BIG_NEG))
    return out.to(q.dtype), lse[..., 0]


def flash_attention_fwd_ref(q, k, v, causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: f32 scores, masked
    scores -1e30 with probability 0, f32 softmax, probabilities rounded to
    the input type for the PV product.  Returns (out in q's dtype, lse
    f32 (B, H, Sq))."""
    vis = _visible(q.shape[2], k.shape[2], causal, q.device)
    return _fwd_ref(q, k, v, vis, _scale(q, scale))


def flash_bwd_delta_ref(out, do) -> torch.Tensor:
    """Plain PyTorch version of the backward's pre-pass: delta =
    rowsum(dO * O) in f32, ``out.shape[:-1]``."""
    return (do.float() * out.float()).sum(dim=-1)


def _bwd_terms(q, k, v, out, lse, do, vis, scale, delta=None):
    """What both backward kernels recompute from the saved lse and the
    pre-pass's delta (from ``out`` if not given), in f32 over the repeated
    kv heads: p = exp(s - lse) (0 where ``vis`` is False), dS = p (dO V^T -
    delta) scale; p and dS rounded to the input type, as the kernels use
    them as operands."""
    h = q.shape[1]
    dt = q.dtype
    qf, dof = q.float(), do.float()
    kf = _expand_kv(k, h).float()
    vf = _expand_kv(v, h).float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    if delta is None:
        delta = flash_bwd_delta_ref(out, do)
    delta = delta[..., None]
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dt).float()
    return qf, kf, dof, p.to(dt).float(), ds


def _group_sum(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, H, S, D) per query head -> (B, Hkv, S, D) summed over groups."""
    b, h, s, d = x.shape
    if kv_heads == h:
        return x
    return x.reshape(b, kv_heads, h // kv_heads, s, d).sum(dim=2)


def _dq_ref(q, k, v, out, lse, do, vis, scale, delta=None):
    qf, kf, dof, p, ds = _bwd_terms(q, k, v, out, lse, do, vis, scale, delta)
    return torch.matmul(ds, kf).to(q.dtype)


def _dkv_ref(q, k, v, out, lse, do, vis, scale, delta=None):
    qf, kf, dof, p, ds = _bwd_terms(q, k, v, out, lse, do, vis, scale, delta)
    hkv = k.shape[1]
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), qf), hkv)
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), dof), hkv)
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_dq_ref(q, k, v, out, lse, do, causal: bool = False,
                           scale: Optional[float] = None,
                           delta: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel: dq = dS K (delta from
    ``out`` unless given)."""
    vis = _visible(q.shape[2], k.shape[2], causal, q.device)
    return _dq_ref(q, k, v, out, lse, do, vis, _scale(q, scale), delta)


def flash_attention_dkv_ref(q, k, v, out, lse, do, causal: bool = False,
                            scale: Optional[float] = None,
                            delta: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel: dk = dS^T Q, dv = P^T dO,
    summed over each kv group in f32 (delta from ``out`` unless given)."""
    vis = _visible(q.shape[2], k.shape[2], causal, q.device)
    return _dkv_ref(q, k, v, out, lse, do, vis, _scale(q, scale), delta)


def flash_attention_bwd_ref(q, k, v, out, lse, do, causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of the backward, from the saved ``out`` and
    ``lse`` as the TPU kernels do (not autograd of the forward).  Returns
    (dq, dk, dv) in q's dtype, dk/dv summed over each kv group."""
    dq = flash_attention_dq_ref(q, k, v, out, lse, do, causal, scale)
    return (dq, *flash_attention_dkv_ref(q, k, v, out, lse, do, causal,
                                         scale))


# -- packed sequences (varlen): plain versions ------------------------------

def segment_ids(cu_seqlens: torch.Tensor, t: int) -> torch.Tensor:
    """Segment of each of the T packed tokens: ``searchsorted(cu, pos,
    right) - 1``, as the reference computes it.  Tokens before ``cu[0]``
    get -1 and tokens at or past ``cu[-1]`` get ``len(cu) - 1``: each such
    stretch is a segment of its own (the reference's dense core)."""
    cu = cu_seqlens.to(torch.int32)
    pos = torch.arange(t, dtype=torch.int32, device=cu.device)
    return torch.searchsorted(cu, pos, right=True) - 1


def _segment_visible(cu, t: int, causal: bool) -> torch.Tensor:
    """(T, T) mask: same segment, and key <= query when causal."""
    seg = segment_ids(cu, t)
    vis = seg[:, None] == seg[None, :]
    return vis & _visible(t, t, True, vis.device) if causal else vis


def varlen_flash_fwd_ref(q, k, v, cu_seqlens, causal: bool = False,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the varlen forward kernel over packed
    (H, T, D) q and (Hkv, T, D) k/v: each token attends to the tokens of
    its own ``cu_seqlens`` segment (at or before it when causal).  Returns
    (out like q, lse f32 (H, T))."""
    vis = _segment_visible(cu_seqlens, q.shape[1], causal)
    out, lse = _fwd_ref(q[None], k[None], v[None], vis,
                        _varlen_scale(q, scale))
    return out[0], lse[0]


def _batch1(x):
    return None if x is None else x[None]


def varlen_flash_dq_ref(q, k, v, cu_seqlens, out, lse, do,
                        causal: bool = False, scale: Optional[float] = None,
                        delta: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of the varlen dq kernel."""
    vis = _segment_visible(cu_seqlens, q.shape[1], causal)
    return _dq_ref(q[None], k[None], v[None], out[None], lse[None],
                   do[None], vis, _varlen_scale(q, scale),
                   _batch1(delta))[0]


def varlen_flash_dkv_ref(q, k, v, cu_seqlens, out, lse, do,
                         causal: bool = False,
                         scale: Optional[float] = None,
                         delta: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the varlen dk/dv kernel (dk/dv summed over
    each kv group)."""
    vis = _segment_visible(cu_seqlens, q.shape[1], causal)
    dk, dv = _dkv_ref(q[None], k[None], v[None], out[None], lse[None],
                      do[None], vis, _varlen_scale(q, scale),
                      _batch1(delta))
    return dk[0], dv[0]


def varlen_flash_bwd_ref(q, k, v, cu_seqlens, out, lse, do,
                         causal: bool = False,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Plain PyTorch version of the varlen backward, from the saved ``out``
    and ``lse``: (dq, dk, dv)."""
    dq = varlen_flash_dq_ref(q, k, v, cu_seqlens, out, lse, do, causal,
                             scale)
    return (dq, *varlen_flash_dkv_ref(q, k, v, cu_seqlens, out, lse, do,
                                      causal, scale))


# -- ragged lengths: plain version ------------------------------------------

def flash_attention_ragged_bhsd_ref(q, k, v, kv_lens, causal: bool = True,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """Plain PyTorch version of the ragged forward kernel over (B, H, S, D):
    sequence b's queries see keys ``[0, kv_lens[b])`` (and only those at or
    before the query when causal).  As in the TPU kernel, query rows at or
    past the length still see those keys; a length of 0 gives zeros."""
    sk = k.shape[2]
    cols = torch.arange(sk, device=q.device)
    vis = (cols[None, :] < kv_lens.to(q.device).long()[:, None])
    vis = vis[:, None, None, :] & _visible(q.shape[2], sk, causal, q.device)
    return _fwd_ref(q, k, v, vis, _scale(q, scale))[0]


# -- the kernels --------------------------------------------------------------

# C entry point -> (library, pointer arguments before the common tail
# (batch, heads, kv_heads, sq, sk, d, causal, scale, dtype, stream), the
# kernel whose shared-memory size it needs).  The backward's take q, k, v,
# dout, lse, delta, their outputs (and the varlen span), then the strides.
_ENTRIES = {"flash_fwd": ("flash_fwd", 6, "flash_fwd"),
            "varlen_fwd": ("flash_fwd", 7, "flash_fwd"),
            "ragged_fwd": ("flash_fwd", 6, "flash_fwd"),
            "flash_dq": ("flash_bwd", 8, "flash_dq"),
            "varlen_dq": ("flash_bwd", 9, "flash_dq"),
            "flash_dkv": ("flash_bwd", 9, "flash_dkv"),
            "varlen_dkv": ("flash_bwd", 10, "flash_dkv")}
_LIBS = {}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i] * 7 + [ctypes.c_float, i, p]
    for fn, (lib_name, pointers, smem) in _ENTRIES.items():
        if lib_name == name:
            getattr(lib, fn).argtypes = [p] * pointers + tail
            getattr(lib, fn).restype = i
            getattr(lib, f"{smem}_smem_bytes").argtypes = [i, i]
            getattr(lib, f"{smem}_smem_bytes").restype = ctypes.c_size_t
    if name == "flash_bwd":
        # o, dout, delta, strides; batch, heads, sq, d, dtype; stream
        lib.flash_bwd_delta.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.flash_bwd_delta.restype = i
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x with contiguous rows of D that start on 16-byte boundaries (what
    the kernels' 16-byte loads need); a copy only when x has not."""
    vec = 16 // x.element_size()
    if (x.stride(-1) != 1 or any(s % vec for s in x.stride()[:-1])
            or x.data_ptr() % 16):
        x = x.contiguous()
    return x


def _strides(**named) -> ctypes.Array:
    """24 int64: (b, h, s) strides of q, k, v, o, do, dq, dk, dv; a packed
    (H, T, D) tensor is one batch (stride 0)."""
    vals = []
    for name in ("q", "k", "v", "o", "do", "dq", "dk", "dv"):
        t = named.get(name)
        vals += [0, 0, 0] if t is None else \
            [0] * (4 - t.dim()) + list(t.stride()[:-1])
    return (ctypes.c_longlong * 24)(*vals)


def _dims(q, k, causal, scale):
    """The common tail: batch, heads, kv_heads, sq, sk, d, causal, scale,
    dtype code; a packed (H, T, D) q is one batch of T."""
    b, h, sq, d = q.shape if q.dim() == 4 else (1, *q.shape)
    return [b, h, k.shape[-3], sq, k.shape[-2], d, int(bool(causal)),
            ctypes.c_float(scale), _DTYPE_CODES[q.dtype]]


def _launch(fn: str, *args) -> None:
    """Build (at first use), check the shared memory of, launch and count
    the entry point ``fn``; ``args`` are tensors (passed by pointer) and
    the common tail.  Raises on a refused launch."""
    lib_name, _, smem_fn = _ENTRIES[fn]
    lib = _lib(lib_name)
    q = args[0]
    smem = getattr(lib, f"{smem_fn}_smem_bytes")(q.shape[-1],
                                                 _DTYPE_CODES[q.dtype])
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{fn} at head_dim {q.shape[-1]} needs {smem} "
                         f"bytes of shared memory per block (> "
                         f"{_MAX_SMEM_BYTES})")
    _call(lib_name, fn, q.device, args)


def _call(lib_name: str, fn: str, device, args) -> None:
    """Call entry point ``fn`` on the current stream of ``device`` (tensors
    passed by pointer), raise on a refused launch, count the launch."""
    lib = _lib(lib_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                                else a for a in args], stream)
    if rc != 0:
        err = getattr(lib, f"{lib_name}_error_string")
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    LAUNCH_COUNTS[fn] += 1


def _device(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward over (B, H, S, D).  Returns (out like q,
    lse float32 (B, H, Sq)).  CPU tensors get the plain version; CUDA
    tensors the kernel."""
    _check(q, k, v, causal)
    scale = _scale(q, scale)
    if _device(q) == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, scale)
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k, v, out, lse, _strides(q=q, k=k, v=v, o=out),
            *_dims(q, k, causal, scale))
    return out, lse


def flash_bwd_delta(out, do) -> torch.Tensor:
    """The backward's pre-pass: delta = rowsum(dO * O) in f32 over (B, H,
    S, D) (or packed (H, T, D)) ``out`` and ``do``, shape ``out.shape[:-1]``.
    CPU tensors get the plain version; CUDA tensors the kernel."""
    if out.dim() not in (3, 4) or do.shape != out.shape:
        raise ValueError(f"out and do must share one (B, H, S, D) or (H, T, "
                         f"D) shape, got {tuple(out.shape)} and "
                         f"{tuple(do.shape)}")
    if out.dtype not in _DTYPE_CODES or do.dtype != out.dtype:
        raise TypeError(f"out and do must share one dtype of float32, "
                        f"float16 or bfloat16, got {out.dtype}, {do.dtype}")
    if do.device != out.device:
        raise ValueError(f"all arguments must be on one device, got "
                         f"{out.device} and {do.device}")
    # the kernel reads each row in 16-byte vectors
    vec = 16 // out.element_size()
    if out.shape[-1] % vec:
        raise ValueError(f"head_dim {out.shape[-1]} is not supported: the "
                         f"delta kernel takes a multiple of {vec} for "
                         f"{out.dtype}")
    if _device(out) == "cpu":
        return flash_bwd_delta_ref(out, do)
    out, do = _rows(out), _rows(do)
    delta = torch.empty(out.shape[:-1], dtype=torch.float32,
                        device=out.device)
    b, h, s, d = out.shape if out.dim() == 4 else (1, *out.shape)
    _call("flash_bwd", "flash_bwd_delta", out.device,
          (out, do, delta, _strides(o=out, do=do), b, h, s, d,
           _DTYPE_CODES[out.dtype]))
    return delta


def _bwd_launch(fn, q, k, v, out, lse, do, causal, scale, delta, extra=(),
                **outputs):
    """Launch a backward entry point, first the delta pre-pass if ``delta``
    is None; ``extra`` are the tensors it takes after its outputs (varlen:
    the span).  Returns the new outputs."""
    q, k, v, do = (_rows(t) for t in (q, k, v, do))
    if delta is None:
        delta = flash_bwd_delta(out, do)
    made = {name: torch.empty_like(like)
            for name, like in (("dq", q), ("dk", k), ("dv", v))
            if name in outputs}
    st = _strides(q=q, k=k, v=v, do=do, **made)
    _launch(fn, q, k, v, do, lse.contiguous(), delta.contiguous(),
            *made.values(), *extra, st, *_dims(q, k, causal, scale))
    return tuple(made.values())


def flash_attention_dq(q, k, v, out, lse, do, causal: bool = False,
                       scale: Optional[float] = None,
                       delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dq of flash attention from the forward's ``out`` and ``lse`` (and
    the pre-pass's ``delta``, launched here when not given).  CPU tensors
    get the plain version; CUDA tensors the dq kernel."""
    _check(q, k, v, causal, out=out, lse=lse, do=do, delta=delta)
    scale = _scale(q, scale)
    if _device(q) == "cpu":
        return flash_attention_dq_ref(q, k, v, out, lse, do, causal, scale,
                                      delta)
    return _bwd_launch("flash_dq", q, k, v, out, lse, do, causal, scale,
                       delta, dq=True)[0]


def flash_attention_dkv(q, k, v, out, lse, do, causal: bool = False,
                        scale: Optional[float] = None,
                        delta: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv of flash attention (like k and v, summed over each kv group)
    from the forward's ``out`` and ``lse`` (and the pre-pass's ``delta``,
    launched here when not given).  CPU tensors get the plain version;
    CUDA tensors the dk/dv kernel."""
    _check(q, k, v, causal, out=out, lse=lse, do=do, delta=delta)
    scale = _scale(q, scale)
    if _device(q) == "cpu":
        return flash_attention_dkv_ref(q, k, v, out, lse, do, causal, scale,
                                       delta)
    return _bwd_launch("flash_dkv", q, k, v, out, lse, do, causal, scale,
                       delta, dk=True, dv=True)


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention backward from the forward's ``out`` and ``lse``:
    (dq like q, dk like k, dv like v), dk/dv summed over each kv group.
    CPU tensors get the plain versions; CUDA tensors the delta pre-pass
    (once), then the dq and the dk/dv kernels."""
    _check(q, k, v, causal, out=out, lse=lse, do=do)
    delta = flash_bwd_delta(out, do)
    dq = flash_attention_dq(q, k, v, out, lse, do, causal, scale, delta)
    return (dq, *flash_attention_dkv(q, k, v, out, lse, do, causal, scale,
                                     delta))


# -- packed sequences (varlen): wrappers ------------------------------------

def _check_varlen(q, k, v, cu, causal, *, out=None, lse=None, do=None,
                  delta=None):
    """The dense checks on the packed (H, T, D) tensors as one batch, plus
    ``cu_seqlens``: 1-D integer, on q's device."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"packed q must be (H, T, D) and k/v both (Hkv, T, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"q and k/v must hold the same T tokens (one "
                         f"cu_seqlens packs both), got {q.shape[1]} and "
                         f"{k.shape[1]}")
    if (cu.dim() != 1 or cu.numel() < 1
            or cu.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"cu_seqlens must be a 1-D int32/int64 tensor of "
                         f"segment starts and the end, got {cu.dtype} "
                         f"{tuple(cu.shape)}")
    if cu.device != q.device:
        raise ValueError(f"all arguments must be on one device, got "
                         f"cu_seqlens on {cu.device} and q on {q.device}")
    _check(q[None], k[None], v[None], causal, out=_batch1(out),
           lse=_batch1(lse), do=_batch1(do), delta=_batch1(delta))


def _segment_span(cu_seqlens: torch.Tensor, t: int) -> torch.Tensor:
    """(2, T) int32, the varlen kernels' view of ``cu_seqlens``: the start
    and the end of each token's segment (as ``segment_ids`` defines them;
    ``cu_seqlens`` non-decreasing, as the reference assumes).  Computed on
    the tensor's device, with no host sync."""
    cu = cu_seqlens.to(torch.int32)
    bounds = torch.cat([cu.new_zeros(1), cu.clamp(0, t), cu.new_full((1,), t)])
    seg = segment_ids(cu, t).long() + 1
    return torch.stack([bounds[seg], bounds[seg + 1]]).contiguous()


def varlen_flash_fwd(q, k, v, cu_seqlens, causal: bool = False,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-sequence flash attention forward: q (H, T, D), k/v (Hkv, T, D)
    (any strides with contiguous D, e.g. a transposed (T, H, D) tensor),
    ``cu_seqlens`` (nseg + 1,) int32.  Each token attends to the tokens of
    its own segment, at or before it when causal; a stretch before
    ``cu[0]`` or past ``cu[-1]`` is a segment of its own.  Returns (out
    like q, lse float32 (H, T)).  CPU tensors get the plain version; CUDA
    tensors the kernel."""
    _check_varlen(q, k, v, cu_seqlens, causal)
    scale = _varlen_scale(q, scale)
    if _device(q) == "cpu":
        return varlen_flash_fwd_ref(q, k, v, cu_seqlens, causal, scale)
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("varlen_fwd", q, k, v, out, lse,
            _segment_span(cu_seqlens, q.shape[1]),
            _strides(q=q, k=k, v=v, o=out), *_dims(q, k, causal, scale))
    return out, lse


def varlen_flash_dq(q, k, v, cu_seqlens, out, lse, do, causal: bool = False,
                    scale: Optional[float] = None,
                    delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dq of packed-sequence flash attention from the forward's ``out`` and
    ``lse`` (H, T) (and the pre-pass's ``delta`` (H, T), launched here when
    not given).  CPU tensors get the plain version; CUDA tensors the
    varlen dq kernel."""
    _check_varlen(q, k, v, cu_seqlens, causal, out=out, lse=lse, do=do,
                  delta=delta)
    scale = _varlen_scale(q, scale)
    if _device(q) == "cpu":
        return varlen_flash_dq_ref(q, k, v, cu_seqlens, out, lse, do, causal,
                                   scale, delta)
    return _bwd_launch("varlen_dq", q, k, v, out, lse, do, causal, scale,
                       delta, (_segment_span(cu_seqlens, q.shape[1]),),
                       dq=True)[0]


def varlen_flash_dkv(q, k, v, cu_seqlens, out, lse, do, causal: bool = False,
                     scale: Optional[float] = None,
                     delta: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv of packed-sequence flash attention (like k and v, summed over
    each kv group).  CPU tensors get the plain version; CUDA tensors the
    varlen dk/dv kernel."""
    _check_varlen(q, k, v, cu_seqlens, causal, out=out, lse=lse, do=do,
                  delta=delta)
    scale = _varlen_scale(q, scale)
    if _device(q) == "cpu":
        return varlen_flash_dkv_ref(q, k, v, cu_seqlens, out, lse, do,
                                    causal, scale, delta)
    return _bwd_launch("varlen_dkv", q, k, v, out, lse, do, causal, scale,
                       delta, (_segment_span(cu_seqlens, q.shape[1]),),
                       dk=True, dv=True)


def varlen_flash_bwd(q, k, v, cu_seqlens, out, lse, do, causal: bool = False,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed-sequence flash attention backward: (dq, dk, dv), dk/dv summed
    over each kv group.  CPU tensors get the plain versions; CUDA tensors
    the delta pre-pass (once), then the varlen dq and dk/dv kernels."""
    _check_varlen(q, k, v, cu_seqlens, causal, out=out, lse=lse, do=do)
    delta = flash_bwd_delta(out, do)
    dq = varlen_flash_dq(q, k, v, cu_seqlens, out, lse, do, causal, scale,
                         delta)
    return (dq, *varlen_flash_dkv(q, k, v, cu_seqlens, out, lse, do, causal,
                                  scale, delta))


# -- ragged lengths: wrapper ------------------------------------------------

def flash_attention_ragged_bhsd(q, k, v, kv_lens, causal: bool = True,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Flash attention forward over (B, H, S, D) where sequence b attends
    keys ``[0, kv_lens[b])`` only (the reference's name; forward only, no
    lse).  k/v have q's head count, as the TPU kernel takes them.  Query
    rows at or past the length still see those keys, as the TPU kernel
    computes (its docstring says they emit zeros; only a length of 0
    does).  CPU tensors get the plain version; CUDA tensors the kernel."""
    _check(q, k, v, causal)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"ragged attention takes k/v with q's head count "
                         f"({q.shape[1]}), got {k.shape[1]}")
    if (kv_lens.shape != (q.shape[0],)
            or kv_lens.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f"kv_lens must be int32/int64 of shape (B,) = "
                         f"({q.shape[0]},), got {kv_lens.dtype} "
                         f"{tuple(kv_lens.shape)}")
    if kv_lens.device != q.device:
        raise ValueError(f"all arguments must be on one device, got "
                         f"kv_lens on {kv_lens.device} and q on {q.device}")
    scale = _scale(q, scale)
    if _device(q) == "cpu":
        return flash_attention_ragged_bhsd_ref(q, k, v, kv_lens, causal,
                                               scale)
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty_like(q)
    _launch("ragged_fwd", q, k, v, out, kv_lens.to(torch.int32).contiguous(),
            _strides(q=q, k=k, v=v, o=out), *_dims(q, k, causal, scale))
    return out
