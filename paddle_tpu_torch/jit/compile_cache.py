"""Recapture bookkeeping and warmup (counterpart of the retrace half of
``paddle_tpu/jit/compile_cache.py``).

The reference traces and compiles a step once per input signature, and
every trace beyond a name's first is a retrace.  Here the same counters
count captures: a captured step (``TrainStepCapture``, the serving
engine's two step signatures) notes one trace each time it captures a
signature into a CUDA graph; replays run no Python and note nothing.  On
the CPU a step runs its body eagerly, and it notes a trace the first time
it meets a signature, so the counters read the same on both devices.  The
first trace of a name is the expected cost; every further one is a
recapture.

:func:`pad_to_batch` pads a ragged last batch up to the steady-state
shape, and :func:`warmup` builds (captures) known signatures before the
first step.

The persistent XLA compilation cache of the reference (``initialize``,
``sweep``, ``cache_stats``, ``resolve_cache_dir``) has no counterpart
yet (ROADMAP queue A4), nor have the retrace metrics and flight-recorder
events (queue A5).
"""

from __future__ import annotations

import functools
import threading
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..flags import get_flags

__all__ = ["note_trace", "counted", "trace_counts", "retrace_count",
           "reset_trace_counts", "pad_to_batch", "warmup", "in_warmup",
           "as_struct", "TensorSpec"]

_lock = threading.Lock()
# name -> [traces so far, signature of the latest]
_trace_counts: Dict[str, List[Any]] = {}
_warned: set = set()
_tls = threading.local()


def _signature(args: Sequence[Any]) -> str:
    parts = []
    for a in args:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is not None and dtype is not None:
            parts.append(f"{str(dtype).replace('torch.', '')}"
                         f"[{','.join(str(s) for s in shape)}]")
        elif isinstance(a, (tuple, list)):
            parts.append(f"[{_signature(a)}]")
        else:
            parts.append(type(a).__name__)
    return ",".join(parts)


def note_trace(kind: str, name: str, args: Sequence[Any]) -> None:
    """Bookkeep one capture (or, on the CPU, one new signature) of
    ``name``.  The first is the expected cost; every further one is a
    recapture, and at ``FLAGS_retrace_warn_threshold`` traces of a whole
    step (``kind`` other than ``"op"``) a warning names the signature
    change."""
    sig = _signature(args)
    with _lock:
        entry = _trace_counts.get(name)
        if entry is None:
            _trace_counts[name] = [1, sig]
            return
        entry[0] += 1
        count, old_sig = entry[0], entry[1]
        entry[1] = sig
    threshold = int(get_flags("retrace_warn_threshold"))
    if kind != "op" and threshold and count == threshold \
            and name not in _warned:
        _warned.add(name)
        warnings.warn(
            f"paddle_tpu_torch: {name} has been captured {count} times "
            f"(latest signature change: {old_sig} -> {sig}). Pad or bucket "
            f"input shapes (jit.compile_cache.pad_to_batch), or jit.warmup() "
            f"the known signatures, to stop the recaptures.", stacklevel=3)


def counted(kind: str, name: str, fn: Callable) -> Callable:
    """Wrap ``fn`` so that each call notes a trace of ``name``: wrap the
    body that a capture runs, which executes once a capture."""

    @functools.wraps(fn)
    def traced(*args):
        note_trace(kind, name, args)
        return fn(*args)

    return traced


def trace_counts() -> Dict[str, int]:
    with _lock:
        return {k: v[0] for k, v in _trace_counts.items()}


def retrace_count(name: Optional[str] = None) -> int:
    """Total recaptures (traces beyond each name's first); a single name's
    when given."""
    with _lock:
        if name is not None:
            e = _trace_counts.get(name)
            return max(e[0] - 1, 0) if e else 0
        return sum(max(v[0] - 1, 0) for v in _trace_counts.values())


def reset_trace_counts() -> None:
    with _lock:
        _trace_counts.clear()
        _warned.clear()


def pad_to_batch(batch, batch_size: int):
    """Pad a collated batch's ragged leading dimension up to
    ``batch_size`` by repeating the final row (values stay valid for
    embeddings and integer labels).

    Returns ``(padded_batch, valid)``: ``valid`` is a boolean numpy mask
    of length ``batch_size`` (True = real row) for a masked loss.  A batch
    that is already full comes back unchanged with ``valid=None``."""
    n = [None]

    def walk(obj):
        if hasattr(obj, "shape") and getattr(obj, "ndim", 0) >= 1:
            rows = int(obj.shape[0])
            if rows < batch_size:
                n[0] = rows if n[0] is None else min(n[0], rows)
                reps = [obj[-1:]] * (batch_size - rows)
                if isinstance(obj, torch.Tensor):
                    return torch.cat([obj] + reps, dim=0)
                return np.concatenate([obj] + reps, axis=0)
            return obj
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(v) for v in obj)
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        return obj

    padded = walk(batch)
    if n[0] is None:
        return batch, None
    return padded, np.arange(batch_size) < n[0]


class _warmup_guard:
    """Marks the current thread as executing warmup work."""

    def __enter__(self):
        _tls.warming = getattr(_tls, "warming", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.warming -= 1
        return False


def in_warmup() -> bool:
    return getattr(_tls, "warming", 0) > 0


class TensorSpec(NamedTuple):
    """The shape and dtype of one step argument (the port's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype
    found = getattr(torch, name.replace("torch.", ""), None)
    if not isinstance(found, torch.dtype):
        raise TypeError(f"unknown dtype {dtype!r}")
    return found


def as_struct(spec) -> TensorSpec:
    """Normalise a signature spec — a ``(shape, dtype)`` tuple, an object
    with ``.shape``/``.dtype`` (a tensor, a numpy array, a ``TensorSpec``),
    or a bare shape tuple (float32) — to a :class:`TensorSpec`."""
    shape = getattr(spec, "shape", None)
    if shape is not None:
        return TensorSpec(tuple(int(s) for s in shape),
                          _torch_dtype(getattr(spec, "dtype", "float32")))
    if isinstance(spec, (tuple, list)) and len(spec) == 2 and \
            isinstance(spec[0], (tuple, list)):
        return TensorSpec(tuple(int(s) for s in spec[0]),
                          _torch_dtype(spec[1]))
    if isinstance(spec, (tuple, list)):
        return TensorSpec(tuple(int(s) for s in spec), torch.float32)
    raise TypeError(f"cannot build a TensorSpec from spec {spec!r}")


def _warm_callable(fn, spec) -> None:
    """Execute ``fn`` once on zero-filled tensors matching ``spec`` under
    the warmup guard and ``no_grad``, on the device of the module it
    belongs to (the CPU for a plain function); every buffer of that module
    is restored afterwards, so zero-input statistics do not survive."""
    modules = [t for t in (fn, getattr(fn, "__self__", None))
               if isinstance(t, torch.nn.Module)]
    device = torch.device("cpu")
    for m in modules:
        t = next(iter(list(m.parameters()) + list(m.buffers())), None)
        if t is not None:
            device = t.device
            break
    args = [torch.zeros(s.shape, dtype=s.dtype, device=device)
            for s in map(as_struct, spec)]
    saved = [(b, b.detach().clone()) for m in modules for b in m.buffers()]
    try:
        with _warmup_guard(), torch.no_grad():
            fn(*args)
    finally:
        with torch.no_grad():
            for b, value in saved:
                b.copy_(value)


def warmup(fn, specs, block: bool = True):
    """Build ``fn`` for every known signature before step 1.

    ``specs`` is a sequence of signatures; each signature is a sequence of
    per-argument specs (see :func:`as_struct`).  A ``TrainStepCapture``
    captures each signature (its ``warmup``: nothing of the model or the
    optimizer moves); any other callable is executed once per signature on
    zero-filled inputs.  ``block=False`` runs the work on a daemon thread
    and returns it (``.join()`` to synchronise).  A signature that fails
    warns, and the first real call with it builds it instead (and raises
    there if it fails again)."""
    from .api import TrainStepCapture

    spec_list = list(specs)

    def work():
        for spec in spec_list:
            try:
                if isinstance(fn, TrainStepCapture):
                    fn.warmup(spec)
                else:
                    _warm_callable(fn, spec)
            except Exception as e:  # noqa: BLE001 — warmup is advisory
                warnings.warn(
                    f"paddle_tpu_torch: jit.warmup of "
                    f"{getattr(fn, '__name__', fn)!r} failed for spec "
                    f"{spec!r}: {e!r} — the first real step will build it "
                    f"instead.", stacklevel=2)

    if block:
        work()
        return None
    t = threading.Thread(target=work, daemon=True, name="jit-warmup")
    t.start()
    return t
