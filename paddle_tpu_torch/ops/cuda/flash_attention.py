"""Dense flash attention, forward and backward: the CUDA kernels' wrappers
and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/attention.py`` ``_flash_fwd`` (TPU
kernel ``_fwd_kernel``) and ``_flash_bwd`` (``_dq_kernel``,
``_dkv_kernel``); the kernels are ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``.

Layout is ``(B, H, S, D)``; k and v may have fewer heads (``H % Hkv == 0``,
query head h reads kv head ``h // (H // Hkv)``), and the backward returns
dk/dv with the kv heads' shape, summed over each group.  ``lse`` is
``(B, H, S)`` float32.  Each wrapper checks its arguments, then computes
the plain version for CPU tensors and launches its kernel for CUDA tensors:
there is no other route, and no fallback from a failed build or launch.
``LAUNCH_COUNTS`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .attention import _DTYPE_CODES, LAUNCH_COUNTS

__all__ = ["flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_bwd", "flash_attention_fwd_ref",
           "flash_attention_dq_ref", "flash_attention_dkv_ref",
           "flash_attention_bwd_ref", "MAX_HEAD_DIM"]

# the kernels take D in 16-element steps (one mma.sync k-step, and two
# n-tiles of 8 for each ldmatrix.x4), up to the 16 n-tiles a warp holds
MAX_HEAD_DIM = 128
_HEAD_DIM_STEP = 16
_BIG_NEG = -1e30   # finite, as the kernels: masked scores, never -inf
_MAX_SMEM_BYTES = 232448

LAUNCH_COUNTS.update({"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0})


def _check(q, k, v, causal, *, out=None, lse=None, do=None) -> None:
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
    if d % _HEAD_DIM_STEP or not _HEAD_DIM_STEP <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {d} is not supported: the flash kernels take a "
            f"multiple of {_HEAD_DIM_STEP} up to {MAX_HEAD_DIM}")
    if sq < 1 or sk < 1:
        raise ValueError(f"sequence lengths must be >= 1, got Sq={sq}, "
                         f"Sk={sk}")
    if causal and sq != sk:
        raise ValueError(f"causal attention needs Sq == Sk (the mask is "
                         f"the square lower triangle), got Sq={sq}, "
                         f"Sk={sk}")
    if q.dtype not in _DTYPE_CODES:
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
    if lse is not None:
        if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
            raise ValueError(f"lse must be float32 (B, H, Sq) = "
                             f"{(b, h, sq)}, got {lse.dtype} "
                             f"{tuple(lse.shape)}")
        tensors.append(lse)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all arguments must be on one device, got "
                         f"{sorted(str(x) for x in devices)}")


def _scale(q, scale) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _expand_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    hkv = x.shape[1]
    return x if hkv == heads else x.repeat_interleave(heads // hkv, dim=1)


def _visible(sq: int, sk: int, causal: bool, device) -> torch.Tensor:
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    return mask.tril() if causal else mask


def flash_attention_fwd_ref(q, k, v, causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: f32 scores, masked
    scores -1e30 with probability 0, f32 softmax, probabilities rounded to
    the input type for the PV product.  Returns (out in q's dtype, lse
    f32 (B, H, Sq))."""
    scale = _scale(q, scale)
    h = q.shape[1]
    kf = _expand_kv(k, h).float()
    vf = _expand_kv(v, h).float()
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    vis = _visible(q.shape[2], k.shape[2], causal, q.device)
    s = torch.where(vis, s, torch.full_like(s, _BIG_NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(q.dtype).float(), vf)
    out = torch.where(l > 0, out / torch.where(l > 0, l, torch.ones_like(l)),
                      torch.zeros_like(out))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, _BIG_NEG))
    return out.to(q.dtype), lse[..., 0]


def _bwd_terms(q, k, v, out, lse, do, causal, scale):
    """What both backward kernels recompute from the saved out and lse, in
    f32 over the repeated kv heads: p = exp(s - lse) (0 where masked),
    delta = rowsum(dO * O), dS = p (dO V^T - delta) scale; p and dS
    rounded to the input type, as the kernels use them as operands."""
    h = q.shape[1]
    dt = q.dtype
    qf, dof = q.float(), do.float()
    kf = _expand_kv(k, h).float()
    vf = _expand_kv(v, h).float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    vis = _visible(q.shape[2], k.shape[2], causal, q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dt).float()
    return qf, kf, dof, p.to(dt).float(), ds


def _group_sum(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, H, S, D) per query head -> (B, Hkv, S, D) summed over groups."""
    b, h, s, d = x.shape
    if kv_heads == h:
        return x
    return x.reshape(b, kv_heads, h // kv_heads, s, d).sum(dim=2)


def flash_attention_dq_ref(q, k, v, out, lse, do, causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel: dq = dS K."""
    qf, kf, dof, p, ds = _bwd_terms(q, k, v, out, lse, do, causal,
                                    _scale(q, scale))
    return torch.matmul(ds, kf).to(q.dtype)


def flash_attention_dkv_ref(q, k, v, out, lse, do, causal: bool = False,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel: dk = dS^T Q, dv = P^T dO,
    summed over each kv group in f32."""
    qf, kf, dof, p, ds = _bwd_terms(q, k, v, out, lse, do, causal,
                                    _scale(q, scale))
    hkv = k.shape[1]
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), qf), hkv)
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), dof), hkv)
    return dk.to(q.dtype), dv.to(q.dtype)


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


_LIBS = {}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i] * 7 + [ctypes.c_float, i, p]   # b, h, hkv, sq, sk, d, causal
    if name == "flash_fwd":
        lib.flash_fwd.argtypes = [p] * 6 + tail
        lib.flash_fwd.restype = i
        fns = ("flash_fwd",)
    else:
        lib.flash_dq.argtypes = [p] * 8 + tail
        lib.flash_dkv.argtypes = [p] * 9 + tail
        lib.flash_dq.restype = lib.flash_dkv.restype = i
        fns = ("flash_dq", "flash_dkv")
    for fn in fns:
        getattr(lib, f"{fn}_smem_bytes").argtypes = [i, i]
        getattr(lib, f"{fn}_smem_bytes").restype = ctypes.c_size_t
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x with contiguous rows of D that start on 16-byte boundaries (what
    the kernels' 16-byte loads need); a copy only when x has not."""
    vec = 16 // x.element_size()
    if (x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3])
            or x.data_ptr() % 16):
        x = x.contiguous()
    return x


def _strides(**named) -> ctypes.Array:
    """24 int64: (b, h, s) strides of q, k, v, o, do, dq, dk, dv."""
    vals = []
    for name in ("q", "k", "v", "o", "do", "dq", "dk", "dv"):
        t = named.get(name)
        vals += [0, 0, 0] if t is None else list(t.stride()[:3])
    return (ctypes.c_longlong * 24)(*vals)


def _call(lib, fn: str, *args) -> None:
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                                else a for a in args], stream)
    if rc != 0:
        err = lib.flash_fwd_error_string if fn == "flash_fwd" \
            else lib.flash_bwd_error_string
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def _check_smem(lib, fn: str, d: int, dtype) -> None:
    smem = getattr(lib, f"{fn}_smem_bytes")(d, _DTYPE_CODES[dtype])
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{fn} at head_dim {d} needs {smem} bytes of "
                         f"shared memory per block (> {_MAX_SMEM_BYTES})")


def _dims(q, k, causal, scale):
    b, h, sq, d = q.shape
    return [b, h, k.shape[1], sq, k.shape[2], d, int(bool(causal)),
            ctypes.c_float(scale), _DTYPE_CODES[q.dtype]]


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward over (B, H, S, D).  Returns (out like q,
    lse float32 (B, H, Sq)).  CPU tensors get the plain version; CUDA
    tensors the kernel."""
    _check(q, k, v, causal)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    lib = _lib("flash_fwd")
    _check_smem(lib, "flash_fwd", q.shape[-1], q.dtype)
    q, k, v = _rows(q), _rows(k), _rows(v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _call(lib, "flash_fwd", q, k, v, out, lse,
          _strides(q=q, k=k, v=v, o=out), *_dims(q, k, causal, scale))
    LAUNCH_COUNTS["flash_fwd"] += 1
    return out, lse


def _bwd_args(q, k, v, out, lse, do, causal, scale):
    _check(q, k, v, causal, out=out, lse=lse, do=do)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return _scale(q, scale)


def _bwd_launch(fn, q, k, v, out, lse, do, causal, scale, **outputs):
    lib = _lib("flash_bwd")
    _check_smem(lib, fn, q.shape[-1], q.dtype)
    q, k, v, out, do = (_rows(t) for t in (q, k, v, out, do))
    made = {name: torch.empty_like(like)
            for name, like in (("dq", q), ("dk", k), ("dv", v))
            if name in outputs}
    st = _strides(q=q, k=k, v=v, o=out, do=do, **made)
    _call(lib, fn, q, k, v, out, do, lse.contiguous(), *made.values(), st,
          *_dims(q, k, causal, scale))
    LAUNCH_COUNTS[fn] += 1
    return tuple(made.values())


def flash_attention_dq(q, k, v, out, lse, do, causal: bool = False,
                       scale: Optional[float] = None) -> torch.Tensor:
    """dq of flash attention from the forward's ``out`` and ``lse``.  CPU
    tensors get the plain version; CUDA tensors the dq kernel."""
    scale = _bwd_args(q, k, v, out, lse, do, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_dq_ref(q, k, v, out, lse, do, causal, scale)
    return _bwd_launch("flash_dq", q, k, v, out, lse, do, causal, scale,
                       dq=True)[0]


def flash_attention_dkv(q, k, v, out, lse, do, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv of flash attention (like k and v, summed over each kv group)
    from the forward's ``out`` and ``lse``.  CPU tensors get the plain
    version; CUDA tensors the dk/dv kernel."""
    scale = _bwd_args(q, k, v, out, lse, do, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_dkv_ref(q, k, v, out, lse, do, causal, scale)
    return _bwd_launch("flash_dkv", q, k, v, out, lse, do, causal, scale,
                       dk=True, dv=True)


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention backward from the forward's ``out`` and ``lse``:
    (dq like q, dk like k, dv like v), dk/dv summed over each kv group.
    CPU tensors get the plain versions; CUDA tensors the dq and the dk/dv
    kernels."""
    dq = flash_attention_dq(q, k, v, out, lse, do, causal, scale)
    return (dq, *flash_attention_dkv(q, k, v, out, lse, do, causal, scale))
