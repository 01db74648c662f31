"""Weight-only int8/int4 matmul: the CUDA kernels' wrapper and their plain
PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/quant_matmul.py`` (TPU kernels
``_qmm_kernel_i8`` and ``_qmm_kernel_i4``; plain version
``quant_matmul_xla``); the kernels are ``csrc/quant_matmul.cu``.

The weight layout is ``quantize/core.quantize_weight``'s: int8 codes
``(kp, N)`` or nibble-packed int4 codes ``(kp / 2, N)`` plus f32 scales
``(kp / group, N)``, where ``kp`` pads the in dim up to a group multiple.
The TPU kernel's tile rules (``fallback_reason``) are not the port's: the
CUDA kernels take any M, K, N and group.

``qmm_route`` names the route a call takes, from the input alone:
float16/bfloat16 x with ``group % 16 == 0`` the tensor-core kernels (exact
integer codes on 16-bit tensor cores, group scales applied to the f32
accumulators, one launch a call), anything else the f32 FMA kernels.  The
library's ``qmm_plan`` applies the same rule and chooses the kernel, which
``qmm`` launches; ``qmm_route`` states the rule for callers.

``quant_matmul`` checks its arguments, then computes the plain version
for CPU tensors and launches a kernel for CUDA tensors — there is no
other route, and no fallback from a failed build or launch.  Layers pick
``quant_matmul`` or ``quant_matmul_ref`` once, at construction, by
``use_quant_kernel`` (``FLAGS_weight_quant_kernel``).
``LAUNCH_COUNTS["qmm_i8"]``/``["qmm_i4"]`` count calls that launched.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ...flags import get_flags
from ..op import register_op
from . import _build
from .attention import _DTYPE_CODES, LAUNCH_COUNTS

__all__ = ["qmm_route", "quant_matmul", "quant_matmul_ref",
           "use_quant_kernel"]

LAUNCH_COUNTS.update({"qmm_i8": 0, "qmm_i4": 0})


def use_quant_kernel(device) -> bool:
    """Dispatch gate for the quantized matmul kernel:
    FLAGS_weight_quant_kernel 'auto' = the kernel for weights on a CUDA
    device; 'on'/'off' force."""
    mode = str(get_flags("weight_quant_kernel")).strip().lower()
    if mode in ("on", "1", "true"):
        return True
    if mode in ("off", "0", "false"):
        return False
    return torch.device(device).type == "cuda"


def qmm_route(dtype, group: int) -> str:
    """The kernel a CUDA call takes: ``"tensor_cores"`` for float16 or
    bfloat16 x with ``group % 16 == 0`` (codes are exact in 16 bits, so the
    16-bit tensor cores with f32 accumulators give the f32 result up to
    rounding), else ``"fma"`` (float32 x: rounding it to 16 bits would
    change the result; other groups: a group ends inside a 16-deep
    product).  ``csrc/quant_matmul.cu`` applies the same rule."""
    if dtype in (torch.float16, torch.bfloat16) and int(group) % 16 == 0:
        return "tensor_cores"
    return "fma"


def _expected_groups(in_features: int, group: int, bits: int) -> int:
    """Scale rows ``quantize_weight`` makes for this in dim: ``in`` padded
    to a group multiple, plus one group when int4 would be left odd."""
    g = -(-in_features // group)
    if bits == 4 and (g * group) % 2:
        g += 1
    return g


def _check(x, qw, scales, bits: int, group: int) -> None:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if int(group) < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    if x.dim() < 1 or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32, float16 or bfloat16 with a "
                        f"last (K) axis, got {x.dtype} {tuple(x.shape)}")
    if qw.dim() != 2 or qw.dtype != torch.int8:
        raise TypeError(f"codes must be a 2-D int8 tensor, got {qw.dtype} "
                        f"{tuple(qw.shape)}")
    if scales.dim() != 2 or scales.dtype != torch.float32:
        raise TypeError(f"scales must be a 2-D float32 tensor, got "
                        f"{scales.dtype} {tuple(scales.shape)}")
    k, n = x.shape[-1], qw.shape[1]
    g = _expected_groups(k, group, bits)
    rows = g * group // (2 if bits == 4 else 1)
    if tuple(scales.shape) != (g, n) or qw.shape[0] != rows:
        raise ValueError(
            f"K={k}, group={group}, int{bits} needs codes ({rows}, N) and "
            f"scales ({g}, N); got codes {tuple(qw.shape)} and scales "
            f"{tuple(scales.shape)}")
    devices = {t.device for t in (x, qw, scales)}
    if len(devices) != 1:
        raise ValueError(f"all arguments must be on one device, got "
                         f"{sorted(str(d) for d in devices)}")


def quant_matmul_ref(x, qw, scales, *, bits: int, group: int):
    """Plain PyTorch version: dequantize the weight to f32 (first K rows)
    and multiply in f32; (..., K) → (..., N) in x's dtype."""
    # imported here: quantize/ imports this module for its layers
    from ...quantize.core import dequantize_weight
    w = dequantize_weight(qw, scales, bits, group, x.shape[-1])
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


_LIB = None
# (device index, m, k, n, group, bits, dtype, aligned) -> (kernel, splits,
# rows a split, counters)
_PLANS: Dict[tuple, Tuple[int, int, int, int]] = {}
# (device index, stream) -> (f32 partials, int32 counters) of the
# tensor-core kernel's split merge; the kernel leaves the counters at 0
_WORKSPACE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("quant_matmul")
        lib.qmm.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + \
            [ctypes.c_void_p]
        lib.qmm.restype = ctypes.c_int
        lib.qmm_plan.argtypes = [ctypes.c_int] * 7 + \
            [ctypes.POINTER(ctypes.c_int)] * 4
        lib.qmm_plan.restype = ctypes.c_int
        lib.qmm_error_string.argtypes = [ctypes.c_int]
        lib.qmm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _plan(lib, device, m, k, n, group, bits, dtype_code, aligned):
    key = (device, m, k, n, group, bits, dtype_code, aligned)
    plan = _PLANS.get(key)
    if plan is None:
        out = [ctypes.c_int() for _ in range(4)]
        rc = lib.qmm_plan(m, k, n, group, bits, dtype_code, aligned,
                          *(ctypes.byref(v) for v in out))
        if rc != 0:
            raise RuntimeError(f"qmm_plan failed: CUDA error {rc} "
                               f"({lib.qmm_error_string(rc).decode()})")
        plan = _PLANS[key] = tuple(v.value for v in out)
    return plan


def _workspace(device, stream: int, partials: int, counters: int):
    """The tensor-core kernel's split workspace for (device, stream), grown
    to ``partials`` f32 values and ``counters`` zeroed counters; not cached
    while the stream is captured."""
    if torch.cuda.is_current_stream_capturing():
        return (torch.empty(partials, dtype=torch.float32, device=device),
                torch.zeros(counters, dtype=torch.int32, device=device))
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < partials or ws[1].numel() < counters:
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(partials, have[0]), dtype=torch.float32,
                          device=device),
              torch.zeros(max(counters, have[1]), dtype=torch.int32,
                          device=device))
        _WORKSPACE[key] = ws
    return ws


def _launch(x, qw, scales, bits: int, group: int):
    # a serving step makes 225 of these calls: the host work here is kept
    # to what the launch needs
    k, n = x.shape[-1], qw.shape[1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m = x2.shape[0]
    dev = x.device
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out.reshape(*lead, n)
    if not (qw.is_contiguous() and scales.is_contiguous()):
        raise ValueError("codes and scales must be contiguous")
    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    if dev.index != torch.cuda.current_device():
        # the kernel launches on the calling thread's current device
        with torch.cuda.device(dev):
            return _launch(x, qw, scales, bits, group)
    # the prefill's wgmma kernel reads x and the codes by TMA, from 16-byte
    # aligned bases: the plan's kernel depends on it
    aligned = int(x2.data_ptr() % 16 == 0 and qw.data_ptr() % 16 == 0)
    kernel, splits, ks, counters = _plan(lib, dev.index, m, k, n, group, bits,
                                         code, aligned)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = cnt = None
    if counters:
        # a tensor-core kernel's split merge, in the same launch
        scratch, cnt = _workspace(dev, stream, splits * m * n, counters)
    elif splits > 1:
        scratch = torch.empty(splits * m * n, dtype=torch.float32,
                              device=dev)
    rc = lib.qmm(x2.data_ptr(), qw.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), None if scratch is None
                 else scratch.data_ptr(), None if cnt is None
                 else cnt.data_ptr(), kernel, m, k, n, group, bits, code,
                 splits, ks, stream)
    if rc != 0:
        raise RuntimeError(f"qmm launch failed: CUDA error {rc} "
                           f"({lib.qmm_error_string(rc).decode()})")
    LAUNCH_COUNTS[f"qmm_i{bits}"] += 1
    return out.reshape(*lead, n)


def quant_matmul(x, qw, scales, *, bits: int, group: int):
    """``x`` (..., K) float32/float16/bfloat16 times the quantized weight
    (``quantize_weight``'s codes and scales for in dim K) → (..., N) in
    x's dtype, with f32 sums of exact products (``qmm_route``).  CPU
    tensors get the plain version; CUDA tensors a kernel."""
    _check(x, qw, scales, bits, group)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, qw, scales, bits=bits, group=group)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, qw, scales, bits, group)


def _quant_matmul_op(x, qw, scales, *, bits: int, group: int, kernel: bool):
    """The reference's registry op: ``kernel`` (decided when the layer is
    built) takes ``quant_matmul`` (the CUDA kernels on CUDA tensors), else
    the plain version."""
    fn = quant_matmul if kernel else quant_matmul_ref
    return fn(x, qw, scales, bits=int(bits), group=int(group))


register_op("quant_matmul", _quant_matmul_op)
