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

The persistent half is the cache of kernel libraries that
``ops/cuda/_build.py`` compiles with nvcc (the reference's is JAX's XLA
cache): :func:`resolve_cache_dir` places it by ``FLAGS_compile_cache_dir``
(``auto`` = ``build/kernels`` beside the package; a path; the
reference's disabled values = a fresh temporary directory for this
process), :func:`initialize` arms it (and :func:`sweep`s it),
:func:`sweep` evicts least-recently-used libraries, each with its nvcc
report, beyond ``FLAGS_compile_cache_max_bytes``, and :func:`cache_stats`
reads the directory's size and ``_build``'s hits and misses.  nvcc has no
compile-time threshold, so ``FLAGS_compile_cache_min_compile_secs`` keeps
its default and refuses others.  The reference's metrics, spans and
flight-recorder events (``jit.persistent_cache_*``, ``jit.cache``, the
retrace events) are ROADMAP queue A5.
"""

from __future__ import annotations

import atexit
import functools
import os
import shutil
import tempfile
import threading
import warnings
from pathlib import Path
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..flags import get_flags, on_flag_set

__all__ = ["initialize", "ensure_initialized", "resolve_cache_dir",
           "cache_stats", "sweep", "note_trace", "counted", "trace_counts", "retrace_count",
           "reset_trace_counts", "pad_to_batch", "warmup", "in_warmup",
           "as_struct", "TensorSpec"]

_DISABLED_VALUES = {"", "0", "off", "none", "false", "disabled"}

_lock = threading.Lock()
# name -> [traces so far, signature of the latest]
_trace_counts: Dict[str, List[Any]] = {}
_warned: set = set()
_tls = threading.local()


# ---------------------------------------------------------------------------
# The persistent cache of kernel libraries
# ---------------------------------------------------------------------------

_initialized = False
_armed_dir: Optional[str] = None
_process_dir: Optional[str] = None


def _default_dir() -> str:
    return str(Path(__file__).resolve().parents[2] / "build" / "kernels")


def _fresh_process_dir() -> str:
    """A temporary directory of this process's own, removed at exit."""
    global _process_dir
    if _process_dir is None:
        _process_dir = tempfile.mkdtemp(prefix="paddle_tpu_torch-kernels-")
        atexit.register(shutil.rmtree, _process_dir, True)
    return _process_dir


def resolve_cache_dir() -> str:
    """The directory ``FLAGS_compile_cache_dir`` names: ``auto`` is
    ``build/kernels`` beside the package, a path is itself, and the
    reference's disabled values (``off``, ``none``, ``""``, ...) give a
    fresh temporary directory for this process, so nothing persists."""
    raw = str(get_flags("compile_cache_dir")).strip()
    if raw.lower() in _DISABLED_VALUES:
        return _fresh_process_dir()
    return _default_dir() if raw.lower() == "auto" else raw


def initialize(cache_dir: Optional[str] = None) -> str:
    """Arm the kernel cache at ``cache_dir`` (default: the flag's
    directory) and sweep it; returns the directory in use.  A directory
    that cannot be made degrades to a fresh temporary one, with a
    warning (the reference disables persistence there)."""
    global _initialized, _armed_dir
    with _lock:
        d = cache_dir if cache_dir is not None else resolve_cache_dir()
        try:
            os.makedirs(d, exist_ok=True)
        except OSError as e:
            warnings.warn(
                f"paddle_tpu_torch: kernel cache directory {d!r} is not "
                f"writable ({e}); kernels are built in a temporary "
                f"directory of this process instead. Point "
                f"FLAGS_compile_cache_dir somewhere writable to keep "
                f"them.", stacklevel=2)
            d = _fresh_process_dir()
        _armed_dir = d
        _initialized = True
    sweep(cache_dir=d)
    return d


def ensure_initialized() -> str:
    """The armed directory, arming it first if needed."""
    if not _initialized:
        initialize()
    return _armed_dir


def _cache_entries(d: str) -> List[Tuple[List[str], float, int]]:
    """([library, its report], last use, bytes) per built library: the
    report's mtime is the last use (``_build`` touches it at every hit),
    the library's own where the report is missing."""
    entries = []
    try:
        names = os.listdir(d)
    except OSError:
        return entries
    for fn in names:
        if not (fn.startswith("lib") and fn.endswith(".so")):
            continue
        lib = os.path.join(d, fn)
        report = lib[:-len(".so")] + ".ptxas"
        paths = [lib] + ([report] if os.path.exists(report) else [])
        try:
            size = sum(os.path.getsize(p) for p in paths)
            stamp = os.path.getmtime(paths[-1])
        except OSError:      # removed mid-scan (a concurrent sweep)
            continue
        entries.append((paths, stamp, size))
    return entries


def sweep(max_bytes: Optional[int] = None,
          cache_dir: Optional[str] = None) -> List[str]:
    """LRU eviction: delete the least recently used libraries, each with
    its nvcc report, until the directory (default: the armed one, else
    the flag's) holds at most ``max_bytes`` (default
    ``FLAGS_compile_cache_max_bytes``; 0 disables).  Returns the evicted
    libraries' paths."""
    d = cache_dir or _armed_dir or resolve_cache_dir()
    if max_bytes is None:
        max_bytes = int(get_flags("compile_cache_max_bytes"))
    entries = _cache_entries(d)
    total = sum(e[2] for e in entries)
    evicted: List[str] = []
    if max_bytes and total > max_bytes:
        for paths, _, size in sorted(entries, key=lambda e: e[1]):
            if total <= max_bytes:
                break
            try:
                for p in paths:
                    os.remove(p)
            except OSError:
                continue
            total -= size
            evicted.append(paths[0])
    return evicted


def cache_stats() -> Dict[str, Any]:
    """The armed (else the flag's) directory, its libraries' bytes, and
    this process's hits (libraries reused), misses (built) and requests
    (their sum), as ``ops/cuda/_build.py`` counts them."""
    from ..ops.cuda._build import STATS
    d = _armed_dir or resolve_cache_dir()
    return {"dir": d, "hits": STATS["hits"], "misses": STATS["misses"],
            "requests": STATS["hits"] + STATS["misses"],
            "bytes": sum(e[2] for e in _cache_entries(d))}


on_flag_set("compile_cache_dir", lambda _value: initialize())


# ---------------------------------------------------------------------------
# Recapture bookkeeping
# ---------------------------------------------------------------------------

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
