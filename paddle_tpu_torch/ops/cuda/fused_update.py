"""The optimizer update (SGD, Adam, AdamW) as one multi-tensor CUDA kernel,
and its plain PyTorch version.

The reference traces each parameter's update into the one XLA program of
its step, which fuses it (``paddle_tpu/optimizer/optimizer.py:330-350``,
``paddle_tpu/jit/api.py:826-840``); there is no TPU kernel.  Here one
launch of ``csrc/fused_update.cu`` updates every tensor of a dtype group
in place, reading p, g, m1 and m2 once and writing p, m1 and m2 once.

``fused_update`` computes the plain version for CPU tensors and launches
the kernel for CUDA tensors: there is no other route, and no fallback.  The
kernel takes p (and g, which must share p's dtype) in float32, float16 or
bfloat16 and the moments in p's dtype or float32; anything else raises.
``lr`` and ``step`` are 0-dim float32 tensors on the parameters' device:
the kernel reads them from device memory, so a CUDA graph of the update
reads each replay's values.  ``skip`` (dynamic loss scaling's overflow
flag, ``amp.GradScaler``) is None or a 0-dim float32 tensor there too:
where it is nonzero, every block of the kernel returns before it touches
a tensor, and the plain version keeps each old value by a select, so an
overflowed step leaves the parameters and moments bitwise unchanged with
no host sync (the reference's ``_select_update``,
``paddle_tpu/optimizer/optimizer.py:33-37``).

The kernel reads its tensors through a device table (:class:`UpdateTable`,
an entry (p, g, m1, m2, numel, decay) a tensor, one table a dtype group)
that the caller keeps (``cache``, a dict the optimizer owns).  A table is
built once for a list of parameters and moments and their decay flags,
and is looked up by their addresses.  Grads are allocated by the backward,
so their addresses are written into the table by a small kernel
(``fused_update_set_grads``) at the launch where they moved, and at every
launch made while the stream is captured: a capture records that write,
so each replay rewrites its own grads' addresses.  A table cannot be
uploaded while a stream is captured, so a table for a captured update is
built before the capture (``prepare``, which ``TrainStepCapture`` calls)
and kept apart from the eager step's.

Rounding: both versions compute in float32 (float64 where a tensor is
float64, in the plain version only), in the order the CUDA source states,
and round each output once to its dtype.  ``bc1 = 1 - b1 ** step`` and
``bc2`` are formed in float32 from the float32 ``step``, as the
reference's traced scalars are float32.  ``LAUNCH_COUNTS["fused_update"]``
counts launches of the update kernel (one a dtype group a call).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import _build
from .attention import LAUNCH_COUNTS

__all__ = ["SGD", "ADAM", "fused_update", "fused_update_ref", "prepare",
           "UpdateTable"]

SGD, ADAM = 0, 1
LAUNCH_COUNTS.update({"fused_update": 0})

_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# (p dtype, moment dtype) pairs the kernel takes
_GROUPS = {(torch.float32, torch.float32), (torch.float16, torch.float16),
           (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32),
           (torch.bfloat16, torch.float32)}


def _hyper(beta1: float, beta2: float, epsilon: float, coeff: float):
    """The kernel's constants as float32, 1 - b formed in float64 first,
    as the plain version's Python floats are."""
    return [float(np.float32(v)) for v in
            (beta1, 1.0 - beta1, beta2, 1.0 - beta2, epsilon, coeff)]


def fused_update_ref(kind: int, params, grads, m1s, m2s, decay, lr, step,
                     beta1: float = 0.9, beta2: float = 0.999,
                     epsilon: float = 1e-8, coeff: float = 0.0,
                     skip: Optional[torch.Tensor] = None) -> None:
    """Plain version of the kernel, a tensor at a time, in place.  Each
    tensor is upcast to float32 (float64 where p or a moment is float64),
    updated in the kernel's order (``csrc/fused_update.cu``), and each
    output is rounded once to its dtype.  ``lr``/``step`` are 0-dim
    float32 tensors (Python numbers also work); ``decay[i]`` applies
    ``p *= 1 - lr * coeff`` before the Adam update (AdamW).  Where
    ``skip`` (a 0-dim tensor) is nonzero every output keeps its old
    value."""
    keep_old = None if skip is None else skip != 0

    def put(dst, val):
        val = val.to(dst.dtype)
        dst.copy_(val if keep_old is None
                  else torch.where(keep_old, dst, val))

    if kind == SGD:
        for p, g in zip(params, grads):
            ct = torch.promote_types(p.dtype, torch.float32)
            put(p, p.to(ct) - lr * g.to(ct))
        return
    b1, b2 = float(beta1), float(beta2)
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    keep = 1.0 - lr * float(coeff)
    for p, g, m1, m2, dec in zip(params, grads, m1s, m2s, decay):
        ct = torch.promote_types(torch.promote_types(p.dtype, m1.dtype),
                                 torch.float32)
        pf, gf, af, bf = (t.to(ct) for t in (p, g, m1, m2))
        if dec:
            pf = pf * keep
        af = af * b1 + gf * (1.0 - b1)
        bf = bf * b2 + gf * gf * (1.0 - b2)
        pf = pf - lr * (af / bc1) / (torch.sqrt(bf / bc2) + epsilon)
        put(p, pf)
        put(m1, af)
        put(m2, bf)


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("fused_update")
        lib.fused_update.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 3 + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        lib.fused_update.restype = ctypes.c_int
        lib.fused_update_set_grads.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.fused_update_set_grads.restype = ctypes.c_int
        lib.fused_update_chunk.restype = ctypes.c_longlong
        lib.fused_update_max_patch.restype = ctypes.c_int
        lib.fused_update_entry_bytes.restype = ctypes.c_int
        lib.fused_update_error_string.argtypes = [ctypes.c_int]
        lib.fused_update_error_string.restype = ctypes.c_char_p
        if lib.fused_update_entry_bytes() != 48:
            raise RuntimeError("fused_update: the library's table entry is "
                               "not 6 x int64")
        _LIB = lib
    return _LIB


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: error {rc} "
                           f"({lib.fused_update_error_string(rc).decode()})")


class _Group:
    """One dtype group's device table: its tensors' indices in the call,
    the table, the chunk prefix, and the grad addresses last written."""

    def __init__(self, index: List[int], table, prefix, n_chunks: int,
                 p_dtype, m_dtype) -> None:
        self.index = index
        self.table = table
        self.prefix = prefix
        self.n_chunks = n_chunks
        self.p_code = _CODES[p_dtype]
        self.m_code = _CODES[m_dtype]
        self.grads: Optional[List[int]] = None


class UpdateTable:
    """The device tables of one update: a group for each (p dtype, moment
    dtype), built (uploaded) once.  Built only outside a capture."""

    def __init__(self, kind: int, params, m1s, m2s, decay) -> None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "fused_update: the update's table cannot be built while the "
                "stream is captured; build it first (fused_update.prepare, "
                "which TrainStepCapture calls before its capture)")
        lib = _lib()
        chunk = lib.fused_update_chunk()
        self.kind = kind
        self.device = params[0].device
        by_group: Dict[tuple, List[int]] = {}
        for i, p in enumerate(params):
            if p.numel() == 0:
                continue
            m = p if kind == SGD else m1s[i]
            by_group.setdefault((p.dtype, m.dtype), []).append(i)
        self.groups: List[_Group] = []
        for (pdt, mdt), index in by_group.items():
            rows = np.zeros((len(index), 6), np.int64)
            prefix = np.zeros(len(index) + 1, np.int64)
            for r, i in enumerate(index):
                p = params[i]
                if kind == ADAM:
                    rows[r, 2] = m1s[i].data_ptr()
                    rows[r, 3] = m2s[i].data_ptr()
                rows[r, 0] = p.data_ptr()
                rows[r, 4] = p.numel()
                rows[r, 5] = 1 if decay[i] else 0
                prefix[r + 1] = prefix[r] + -(-p.numel() // chunk)
            with torch.cuda.device(self.device):
                table = torch.from_numpy(rows).to(self.device)
                pre = torch.from_numpy(prefix).to(self.device)
            self.groups.append(_Group(index, table, pre, int(prefix[-1]),
                                      pdt, mdt))

    def launch(self, grads, lr: torch.Tensor, step: torch.Tensor,
               skip: Optional[torch.Tensor],
               hyper: Sequence[float]) -> None:
        lib = _lib()
        capturing = torch.cuda.is_current_stream_capturing()
        patch = lib.fused_update_max_patch()
        skip_ptr = None if skip is None else skip.data_ptr()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            for grp in self.groups:
                ptrs = [grads[i].data_ptr() for i in grp.index]
                if capturing or ptrs != grp.grads:
                    for first in range(0, len(ptrs), patch):
                        part = ptrs[first:first + patch]
                        arr = (ctypes.c_longlong * len(part))(*part)
                        _check(lib, lib.fused_update_set_grads(
                            grp.table.data_ptr(), arr, first, len(part),
                            stream), "fused_update_set_grads")
                    # a replay rewrites the addresses it captured, so what
                    # the table holds after a capture is not known here
                    grp.grads = None if capturing else ptrs
                _check(lib, lib.fused_update(
                    grp.table.data_ptr(), grp.prefix.data_ptr(),
                    len(grp.index), grp.n_chunks, lr.data_ptr(),
                    step.data_ptr(), skip_ptr, self.kind, grp.p_code,
                    grp.m_code,
                    *hyper, stream), "fused_update")
                LAUNCH_COUNTS["fused_update"] += 1


def _check_args(kind, params, grads, m1s, m2s, lr, step,
                skip=None) -> None:
    dev = params[0].device
    for i, (p, g) in enumerate(zip(params, grads)):
        m = [] if kind == SGD else [m1s[i], m2s[i]]
        for name, t in [("p", p), ("g", g)] + list(zip(("m1", "m2"), m)):
            if t.device != dev:
                raise ValueError(f"fused_update: tensor {i}'s {name} is on "
                                 f"{t.device}, p[0] on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"fused_update: tensor {i}'s {name} is not "
                                 f"contiguous")
            if t.shape != p.shape:
                raise ValueError(f"fused_update: tensor {i}'s {name} has "
                                 f"shape {tuple(t.shape)}, p "
                                 f"{tuple(p.shape)}")
        if g.dtype != p.dtype:
            raise TypeError(f"fused_update: tensor {i}'s grad is {g.dtype}, "
                            f"its parameter {p.dtype}; the kernel reads g in "
                            f"p's dtype")
        mdt = p.dtype if kind == SGD else m1s[i].dtype
        if kind == ADAM and m2s[i].dtype != mdt:
            raise TypeError(f"fused_update: tensor {i}'s moments are "
                            f"{mdt}/{m2s[i].dtype}")
        if (p.dtype, mdt) not in _GROUPS:
            raise TypeError(
                f"fused_update: parameter {p.dtype} with moments {mdt} is "
                f"not a group the kernel takes (float32, float16 or "
                f"bfloat16 parameters, moments in their dtype or float32)")
    scalars = [("lr", lr), ("step", step)]
    if skip is not None:
        scalars.append(("skip", skip))
    for name, t in scalars:
        if not (isinstance(t, torch.Tensor) and t.dim() == 0
                and t.dtype == torch.float32 and t.device == dev):
            raise TypeError(f"fused_update: {name} must be a 0-dim float32 "
                            f"tensor on {dev} (the kernel reads it from "
                            f"device memory)")


def _key(kind, params, m1s, m2s, decay, capture: bool):
    ms = ([(m1.data_ptr(), m2.data_ptr()) for m1, m2 in zip(m1s, m2s)]
          if kind == ADAM else [])
    return (capture, kind, tuple(p.data_ptr() for p in params), tuple(ms),
            tuple(bool(d) for d in decay))


def prepare(kind: int, params, m1s, m2s, decay,
            cache: Dict) -> Optional[UpdateTable]:
    """Build, before a CUDA-graph capture, the table that the captured
    update of these tensors reads (nothing for CPU tensors)."""
    if not params or params[0].device.type != "cuda":
        return None
    key = _key(kind, params, m1s, m2s, decay, True)
    if key not in cache:
        cache[key] = UpdateTable(kind, params, m1s, m2s, decay)
    return cache[key]


def fused_update(kind: int, params, grads, m1s, m2s, decay, lr, step,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, coeff: float = 0.0,
                 cache: Optional[Dict] = None,
                 skip: Optional[torch.Tensor] = None) -> None:
    """Update ``params`` (and for ADAM the moments ``m1s``/``m2s``) in
    place from ``grads``: SGD ``p -= lr g``; ADAM the Adam update, with
    ``p *= 1 - lr * coeff`` first where ``decay[i]`` (AdamW); nothing
    where ``skip`` is nonzero.  CPU tensors take
    :func:`fused_update_ref`; CUDA tensors the kernel, one launch a dtype
    group.  ``cache`` keeps the tables (a fresh dict rebuilds them each
    call)."""
    if not params:
        return
    m1s = m1s if kind == ADAM else [None] * len(params)
    m2s = m2s if kind == ADAM else [None] * len(params)
    decay = list(decay) if decay is not None else [False] * len(params)
    dev = params[0].device
    if dev.type == "cpu":
        return fused_update_ref(kind, params, grads, m1s, m2s, decay, lr,
                                step, beta1, beta2, epsilon, coeff, skip)
    if dev.type != "cuda":
        raise ValueError(f"fused_update: unsupported device {dev}")
    _check_args(kind, params, grads, m1s, m2s, lr, step, skip)
    cache = {} if cache is None else cache
    capturing = torch.cuda.is_current_stream_capturing()
    key = _key(kind, params, m1s, m2s, decay, capturing)
    table = cache.get(key)
    if table is None:
        if not capturing:
            # the eager step keeps one table: the latest
            for k in [k for k in cache if not k[0]]:
                del cache[k]
        table = UpdateTable(kind, params, m1s, m2s, decay)
        cache[key] = table
    table.launch(grads, lr, step, skip,
                 _hyper(beta1, beta2, epsilon, coeff))
