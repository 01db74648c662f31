"""The optimizer update (SGD, Adam, AdamW, Momentum, Adagrad, Adamax,
RMSProp, Adadelta, Rprop, NAdam, RAdam, ASGD, Lamb) as one multi-tensor
CUDA kernel, and its plain PyTorch version.

The reference traces each parameter's update into the one XLA program of
its step, which fuses it (``paddle_tpu/optimizer/optimizer.py:227-610``,
``paddle_tpu/jit/api.py:826-840``); there is no TPU kernel.  Here one
launch of ``csrc/fused_update.cu`` updates every tensor of a dtype group
in place, reading p, g and the rule's states once and writing p and the
states once.  Lamb takes two launches: its trust ratio needs the norms of
each whole tensor before any element is written (the first launch sums
them a chunk at a time into a workspace, the second writes).

``fused_update`` computes the plain version for CPU tensors and launches
the kernel for CUDA tensors: there is no other route, and no fallback.  The
kernel takes p (and g, which must share p's dtype) in float32, float16 or
bfloat16 and the states in p's dtype or float32; anything else raises.
``lr`` and ``step`` are 0-dim float32 tensors on the parameters' device:
the kernel reads them from device memory, so a CUDA graph of the update
reads each replay's values.  ``skip`` (dynamic loss scaling's overflow
flag, ``amp.GradScaler``) is None or a 0-dim float32 tensor there too:
where it is nonzero, every block of the kernel returns before it touches
a tensor, and the plain version keeps each old value by a select, so an
overflowed step leaves the parameters and states bitwise unchanged with
no host sync (the reference's ``_select_update``,
``paddle_tpu/optimizer/optimizer.py:33-37``).

The kernel reads its tensors through a device table (:class:`UpdateTable`,
an entry (p, g, m1, m2, m3, numel, decay) a tensor, one table a dtype
group) that the caller keeps (``cache``, a dict the optimizer owns).  A
table is built once for a list of parameters and states and their decay
flags, and is looked up by their addresses.  Grads are allocated by the
backward, so their addresses are written into the table by a small kernel
(``fused_update_set_grads``) at the launch where they moved, and at every
launch made while the stream is captured: a capture records that write,
so each replay rewrites its own grads' addresses.  A table cannot be
uploaded while a stream is captured, so a table for a captured update is
built before the capture (``prepare``, which ``TrainStepCapture`` calls)
and kept apart from the eager step's; Lamb's workspace is allocated with
its table, so a capture records no allocation.

Rounding: both versions compute in float32 (float64 where a tensor is
float64, in the plain version only), in the order the CUDA source states,
and round each output once to its dtype.  Adam's ``bc1 = 1 - b1 ** step``
and ``bc2`` are formed in float32 from the float32 ``step``; the later
rules form their step's scalars in float64 and round each to float32, as
the reference's Python-float arithmetic is float64 until it meets an
array (RAdam's ``rho_t`` keeps no digit in float32).  Lamb's norms are
sums in another order in the two versions.  ``LAUNCH_COUNTS`` counts
launches of the update kernel: ``"fused_update"`` for SGD, Adam and AdamW
(one a dtype group a call), ``"fused_update:<rule>"`` for each later rule
(Lamb: two a dtype group a call, one a pass).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import _build
from .attention import LAUNCH_COUNTS

__all__ = ["SGD", "ADAM", "MOMENTUM", "ADAGRAD", "ADAMAX", "RMSPROP",
           "RMSPROP_CENTERED", "ADADELTA", "RPROP", "NADAM", "RADAM", "ASGD",
           "LAMB", "RULES", "N_STATES", "count_key", "fused_update",
           "fused_update_ref", "prepare", "UpdateTable"]

(SGD, ADAM, MOMENTUM, ADAGRAD, ADAMAX, RMSPROP, RMSPROP_CENTERED, ADADELTA,
 RPROP, NADAM, RADAM, ASGD, LAMB) = range(13)
# the rule's name (its launch count is "fused_update:<name>" past Adam)
RULES = {SGD: "sgd", ADAM: "adam", MOMENTUM: "momentum",
         ADAGRAD: "adagrad", ADAMAX: "adamax", RMSPROP: "rmsprop",
         RMSPROP_CENTERED: "rmsprop_centered", ADADELTA: "adadelta",
         RPROP: "rprop", NADAM: "nadam", RADAM: "radam", ASGD: "asgd",
         LAMB: "lamb"}
# the states each rule reads and writes (m1, m2, m3 in order)
N_STATES = {SGD: 0, ADAM: 2, MOMENTUM: 1, ADAGRAD: 1, ADAMAX: 2,
            RMSPROP: 2, RMSPROP_CENTERED: 3, ADADELTA: 2, RPROP: 2,
            NADAM: 2, RADAM: 2, ASGD: 1, LAMB: 2}


def count_key(kind: int) -> str:
    """The ``LAUNCH_COUNTS`` key of a rule's kernel."""
    return "fused_update" if kind in (SGD, ADAM) else \
        f"fused_update:{RULES[kind]}"


LAUNCH_COUNTS.update({count_key(k): 0 for k in RULES})

_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# (p dtype, state dtype) pairs the kernel takes
_GROUPS = {(torch.float32, torch.float32), (torch.float16, torch.float16),
           (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32),
           (torch.bfloat16, torch.float32)}
_F32 = ("b1", "omb1", "b2", "omb2", "eps", "coeff", "mu", "eps2",
        "eta_minus", "eta_plus", "lo", "hi")
_F64 = ("db1", "db2", "rho_inf")


class _Hyper(ctypes.Structure):
    """The kernel's constants (``Hyper`` in ``csrc/fused_update.cu``)."""
    _fields_ = ([(n, ctypes.c_float) for n in _F32]
                + [("nesterov", ctypes.c_int)]
                + [(n, ctypes.c_double) for n in _F64])


def _f32(v: float) -> float:
    return float(np.float32(v))


def _hyper(kind: int, beta1: float = 0.9, beta2: float = 0.999,
           epsilon: float = 1e-8, coeff: float = 0.0, momentum: float = 0.0,
           nesterov: bool = False, rho: float = 0.95,
           etas: Sequence[float] = (0.5, 1.2),
           lr_range: Sequence[float] = (1e-5, 50.0)) -> dict:
    """The rule's constants: float32 values (the reference's Python floats
    as they meet its float32 arrays, ``1 - b`` formed in float64 first) and
    the float64 ones that form the step's scalars.  RMSProp and Adadelta
    keep ``rho`` where the Adam family keeps ``beta1``."""
    b1 = float(rho if kind in (RMSPROP, RMSPROP_CENTERED, ADADELTA)
               else beta1)
    b2 = float(beta2)
    h = dict(b1=b1, omb1=1.0 - b1, b2=b2, omb2=1.0 - b2, eps=epsilon,
             coeff=coeff, mu=momentum, eps2=float(epsilon) ** 2,
             eta_minus=etas[0], eta_plus=etas[1], lo=lr_range[0],
             hi=lr_range[1])
    h = {k: _f32(v) for k, v in h.items()}
    h.update(nesterov=int(bool(nesterov)), db1=b1, db2=b2,
             rho_inf=2.0 / (1.0 - b2) - 1.0 if kind == RADAM else 0.0)
    return h


def _scalar64(x, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim float32 value (tensor or number) as a float64 tensor on
    ``like``'s device: the kernel reads lr and step as float32."""
    return torch.as_tensor(x, dtype=torch.float32,
                           device=like.device).double()


def _plain_rule(kind, params, grads, states, decay, lr, step, h, put):
    """The later rules' plain version, a tensor at a time, in the kernel's
    order (``csrc/fused_update.cu``); ``states`` holds the rule's state
    lists, m1 first."""
    t = _scalar64(step, params[0])
    if kind in (ADAMAX, NADAM, RADAM, LAMB):
        bt2 = h["db2"] ** t
        bc1_d = 1.0 - h["db1"] ** t
        bc2_d = 1.0 - bt2
        bc1, bc2 = bc1_d.float(), bc2_d.float()
    if kind == ADAMAX:
        lr_bc = (_scalar64(lr, params[0]) / bc1_d).float()
    if kind == RADAM:
        rho_inf = h["rho_inf"]
        rho_t = rho_inf - 2.0 * t * bt2 / bc2_d
        num = (rho_t - 4) * (rho_t - 2) * rho_inf
        den = ((rho_inf - 4) * (rho_inf - 2) * rho_t).clamp_min(1e-12)
        rect = torch.sqrt((num / den).clamp_min(0.0)).float()
        rectify = rho_t > 5.0
    b1, omb1, b2, omb2, eps = (h[k] for k in ("b1", "omb1", "b2", "omb2",
                                              "eps"))
    mu = h["mu"]
    n = N_STATES[kind]
    for i, (p, g) in enumerate(zip(params, grads)):
        st = [s[i] for s in states[:n]]
        ct = torch.float32
        for x in [p] + st:
            ct = torch.promote_types(ct, x.dtype)
        pf, gf = p.to(ct), g.to(ct)
        a, b, c = ([x.to(ct) for x in st] + [None] * 3)[:3]
        if kind == MOMENTUM:
            a = mu * a + gf
            pf = pf - lr * (gf + mu * a if h["nesterov"] else a)
        elif kind == ADAGRAD:
            a = a + gf * gf
            pf = pf - (lr * gf) / (torch.sqrt(a) + eps)
        elif kind == ADAMAX:
            a = b1 * a + omb1 * gf
            b = torch.maximum(b2 * b, gf.abs())
            pf = pf - (lr_bc * a) / (b + eps)
        elif kind in (RMSPROP, RMSPROP_CENTERED):
            a = b1 * a + (omb1 * gf) * gf
            if kind == RMSPROP_CENTERED:
                c = b1 * c + omb1 * gf
                den = torch.sqrt((a - c * c) + eps)
            else:
                den = torch.sqrt(a + eps)
            b = mu * b + (lr * gf) / den
            pf = pf - b
        elif kind == ADADELTA:
            a = b1 * a + (omb1 * gf) * gf
            dx = (torch.sqrt(b + eps) / torch.sqrt(a + eps)) * gf
            b = b1 * b + (omb1 * dx) * dx
            pf = pf - lr * dx
        elif kind == RPROP:
            sg = torch.sign(gf * a)
            sz = torch.where(sg > 0, b * h["eta_plus"],
                             torch.where(sg < 0, b * h["eta_minus"], b))
            b = sz.clamp(h["lo"], h["hi"])
            a = torch.where(sg < 0, torch.zeros_like(gf), gf)
            pf = pf - torch.sign(a) * b
        elif kind in (NADAM, RADAM, LAMB):
            a = b1 * a + omb1 * gf
            b = b2 * b + (omb2 * gf) * gf
            if kind == NADAM:
                mh = (b1 * a) / bc1 + (omb1 * gf) / bc1
                pf = pf - (lr * mh) / (torch.sqrt(b / bc2) + eps)
            elif kind == RADAM:
                r = rect * (1 / torch.sqrt(b / bc2 + h["eps2"]))
                r = torch.where(rectify, r, torch.ones_like(r))
                pf = pf - (lr * (a / bc1)) * r
            else:
                r = (a / bc1) / (torch.sqrt(b / bc2) + eps)
                if decay[i]:
                    r = r + h["coeff"] * pf
                wn = torch.linalg.vector_norm(pf.double()).to(ct)
                rn = torch.linalg.vector_norm(r.double()).to(ct)
                trust = torch.where((wn > 0) & (rn > 0), wn / rn,
                                    torch.ones_like(wn))
                pf = pf - (lr * trust) * r
        elif kind == ASGD:
            pf = pf - lr * gf
            a = a + (pf - a) / t.float()
        else:
            raise ValueError(f"fused_update: unknown rule {kind}")
        put(p, pf)
        for dst, val in zip(st, (a, b, c)):
            put(dst, val)


def fused_update_ref(kind: int, params, grads, m1s, m2s, decay, lr, step,
                     beta1: float = 0.9, beta2: float = 0.999,
                     epsilon: float = 1e-8, coeff: float = 0.0,
                     skip: Optional[torch.Tensor] = None, m3s=None,
                     **rule) -> None:
    """Plain version of the kernel, a tensor at a time, in place.  Each
    tensor is upcast to float32 (float64 where p or a state is float64),
    updated in the kernel's order (``csrc/fused_update.cu``), and each
    output is rounded once to its dtype.  ``lr``/``step`` are 0-dim
    float32 tensors (Python numbers also work); ``decay[i]`` applies
    AdamW's ``p *= 1 - lr * coeff`` before the Adam update, and Lamb's
    ``r += coeff * p``.  ``rule`` holds the later rules' constants
    (``momentum``, ``nesterov``, ``rho``, ``etas``, ``lr_range``).  Where
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
    if kind != ADAM:
        h = _hyper(kind, beta1, beta2, epsilon, coeff, **rule)
        return _plain_rule(kind, params, grads, [m1s, m2s, m3s], decay, lr,
                           step, h, put)
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
             ctypes.c_longlong] + [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 3 + [ctypes.POINTER(_Hyper),
                                    ctypes.c_void_p])
        lib.fused_update.restype = ctypes.c_int
        lib.fused_update_set_grads.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.fused_update_set_grads.restype = ctypes.c_int
        lib.fused_update_chunk.restype = ctypes.c_longlong
        lib.fused_update_max_patch.restype = ctypes.c_int
        lib.fused_update_entry_bytes.restype = ctypes.c_int
        lib.fused_update_hyper_bytes.restype = ctypes.c_int
        lib.fused_update_error_string.argtypes = [ctypes.c_int]
        lib.fused_update_error_string.restype = ctypes.c_char_p
        if lib.fused_update_entry_bytes() != 56:
            raise RuntimeError("fused_update: the library's table entry is "
                               "not 7 x int64")
        if lib.fused_update_hyper_bytes() != ctypes.sizeof(_Hyper):
            raise RuntimeError("fused_update: the library's constants are "
                               f"{lib.fused_update_hyper_bytes()} bytes, "
                               f"the wrapper's {ctypes.sizeof(_Hyper)}")
        _LIB = lib
    return _LIB


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: error {rc} "
                           f"({lib.fused_update_error_string(rc).decode()})")


class _Group:
    """One dtype group's device table: its tensors' indices in the call,
    the table, the chunk prefix, Lamb's workspace (a float2 a chunk), and
    the grad addresses last written."""

    def __init__(self, index: List[int], table, prefix, n_chunks: int,
                 p_dtype, m_dtype, partials) -> None:
        self.index = index
        self.table = table
        self.prefix = prefix
        self.n_chunks = n_chunks
        self.p_code = _CODES[p_dtype]
        self.m_code = _CODES[m_dtype]
        self.partials = partials
        self.grads: Optional[List[int]] = None


class UpdateTable:
    """The device tables of one update: a group for each (p dtype, state
    dtype), built (uploaded) once, with Lamb's workspace.  Built only
    outside a capture."""

    def __init__(self, kind: int, params, states, decay) -> None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "fused_update: the update's table cannot be built while the "
                "stream is captured; build it first (fused_update.prepare, "
                "which TrainStepCapture calls before its capture)")
        lib = _lib()
        chunk = lib.fused_update_chunk()
        n = N_STATES[kind]
        self.kind = kind
        self.device = params[0].device
        by_group: Dict[tuple, List[int]] = {}
        for i, p in enumerate(params):
            if p.numel() == 0:
                continue
            m = states[0][i] if n else p
            by_group.setdefault((p.dtype, m.dtype), []).append(i)
        self.groups: List[_Group] = []
        for (pdt, mdt), index in by_group.items():
            rows = np.zeros((len(index), 7), np.int64)
            prefix = np.zeros(len(index) + 1, np.int64)
            for r, i in enumerate(index):
                p = params[i]
                rows[r, 0] = p.data_ptr()
                for j in range(n):
                    rows[r, 2 + j] = states[j][i].data_ptr()
                rows[r, 5] = p.numel()
                rows[r, 6] = 1 if decay[i] else 0
                prefix[r + 1] = prefix[r] + -(-p.numel() // chunk)
            n_chunks = int(prefix[-1])
            with torch.cuda.device(self.device):
                table = torch.from_numpy(rows).to(self.device)
                pre = torch.from_numpy(prefix).to(self.device)
                partials = (torch.empty((n_chunks, 2), dtype=torch.float32,
                                        device=self.device)
                            if kind == LAMB else None)
            self.groups.append(_Group(index, table, pre, n_chunks, pdt, mdt,
                                      partials))

    def launch(self, grads, lr: torch.Tensor, step: torch.Tensor,
               skip: Optional[torch.Tensor], hyper: dict) -> None:
        lib = _lib()
        capturing = torch.cuda.is_current_stream_capturing()
        patch = lib.fused_update_max_patch()
        skip_ptr = None if skip is None else skip.data_ptr()
        consts = _Hyper(**hyper)
        key = count_key(self.kind)
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
                partials = (None if grp.partials is None
                            else grp.partials.data_ptr())
                _check(lib, lib.fused_update(
                    grp.table.data_ptr(), grp.prefix.data_ptr(),
                    len(grp.index), grp.n_chunks, lr.data_ptr(),
                    step.data_ptr(), skip_ptr, partials, self.kind,
                    grp.p_code, grp.m_code, ctypes.byref(consts), stream),
                    "fused_update")
                LAUNCH_COUNTS[key] += 2 if self.kind == LAMB else 1


def _check_args(kind, params, grads, m1s, m2s, lr, step, skip=None,
                m3s=None) -> None:
    dev = params[0].device
    n = N_STATES[kind]
    states = [m1s, m2s, m3s]
    names = ("m1", "m2", "m3")[:n]
    for i, (p, g) in enumerate(zip(params, grads)):
        st = [states[j][i] for j in range(n)]
        for name, t in [("p", p), ("g", g)] + list(zip(names, st)):
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
        mdt = st[0].dtype if n else p.dtype
        if any(s.dtype != mdt for s in st):
            raise TypeError(f"fused_update: tensor {i}'s states are "
                            f"{[s.dtype for s in st]}")
        if (p.dtype, mdt) not in _GROUPS:
            raise TypeError(
                f"fused_update: parameter {p.dtype} with states {mdt} is "
                f"not a group the kernel takes (float32, float16 or "
                f"bfloat16 parameters, states in their dtype or float32)")
    scalars = [("lr", lr), ("step", step)]
    if skip is not None:
        scalars.append(("skip", skip))
    for name, t in scalars:
        if not (isinstance(t, torch.Tensor) and t.dim() == 0
                and t.dtype == torch.float32 and t.device == dev):
            raise TypeError(f"fused_update: {name} must be a 0-dim float32 "
                            f"tensor on {dev} (the kernel reads it from "
                            f"device memory)")


def _key(kind, params, states, decay, capture: bool):
    ms = tuple(tuple(t.data_ptr() for t in states[j])
               for j in range(N_STATES[kind]))
    return (capture, kind, tuple(p.data_ptr() for p in params), ms,
            tuple(bool(d) for d in decay))


def prepare(kind: int, params, m1s, m2s, decay, cache: Dict,
            m3s=None) -> Optional[UpdateTable]:
    """Build, before a CUDA-graph capture, the table that the captured
    update of these tensors reads (nothing for CPU tensors)."""
    if not params or params[0].device.type != "cuda":
        return None
    states = [m1s, m2s, m3s]
    key = _key(kind, params, states, decay, True)
    if key not in cache:
        cache[key] = UpdateTable(kind, params, states, decay)
    return cache[key]


def fused_update(kind: int, params, grads, m1s, m2s, decay, lr, step,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, coeff: float = 0.0,
                 cache: Optional[Dict] = None,
                 skip: Optional[torch.Tensor] = None, m3s=None,
                 **rule) -> None:
    """Update ``params`` and the rule's states (``m1s``, ``m2s``, ``m3s``
    as ``N_STATES[kind]`` says) in place from ``grads`` by rule ``kind``
    (SGD ``p -= lr g``; ADAM with ``p *= 1 - lr * coeff`` first where
    ``decay[i]``, AdamW; the later rules as ``csrc/fused_update.cu``
    states, Lamb's ``decay[i]`` adding ``coeff * p`` to its r); nothing
    where ``skip`` is nonzero.  ``rule`` holds the later rules' constants
    (``momentum``, ``nesterov``, ``rho``, ``etas``, ``lr_range``).  CPU
    tensors take :func:`fused_update_ref`; CUDA tensors the kernel, one
    launch a dtype group (Lamb two).  ``cache`` keeps the tables (a fresh
    dict rebuilds them each call)."""
    if not params:
        return
    n = N_STATES[kind]
    states = [m if j < n else None
              for j, m in enumerate((m1s, m2s, m3s))]
    decay = list(decay) if decay is not None else [False] * len(params)
    dev = params[0].device
    if dev.type == "cpu":
        return fused_update_ref(kind, params, grads, *states[:2], decay, lr,
                                step, beta1, beta2, epsilon, coeff, skip,
                                m3s=states[2], **rule)
    if dev.type != "cuda":
        raise ValueError(f"fused_update: unsupported device {dev}")
    _check_args(kind, params, grads, *states[:2], lr, step, skip,
                m3s=states[2])
    cache = {} if cache is None else cache
    capturing = torch.cuda.is_current_stream_capturing()
    key = _key(kind, params, states, decay, capturing)
    table = cache.get(key)
    if table is None:
        if not capturing:
            # the eager step keeps one table: the latest
            for k in [k for k in cache if not k[0]]:
                del cache[k]
        table = UpdateTable(kind, params, states, decay)
        cache[key] = table
    table.launch(grads, lr, step, skip,
                 _hyper(kind, beta1, beta2, epsilon, coeff, **rule))
