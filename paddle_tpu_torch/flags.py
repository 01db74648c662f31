"""Runtime flag registry: the serving, quantization and recapture flags
the port reads.

Same names, defaults and ``FLAGS_<name>`` environment seeding as
``paddle_tpu/flags.py``; only the flags the port reads are defined.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, Union

__all__ = ["define_flag", "get_flags", "set_flags", "flag_info"]

_TRUE_STRINGS = {"1", "true", "yes", "on"}
_FALSE_STRINGS = {"0", "false", "no", "off"}

_lock = threading.RLock()
_values: Dict[str, Any] = {}
_defaults: Dict[str, Any] = {}
_docs: Dict[str, str] = {}


def _canon(name: str) -> str:
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def _coerce(value: Any, ftype: type):
    if isinstance(value, ftype):
        return value
    if isinstance(value, str) and ftype is bool:
        low = value.strip().lower()
        if low in _TRUE_STRINGS:
            return True
        if low in _FALSE_STRINGS:
            return False
        raise ValueError(f"cannot parse boolean flag value {value!r}")
    return ftype(value)


def define_flag(name: str, default: Any, doc: str = "") -> None:
    with _lock:
        if name in _values:
            raise ValueError(f"flag '{name}' is already defined")
        env = os.environ.get(f"FLAGS_{name}")
        _defaults[name] = default
        _docs[name] = doc
        _values[name] = default if env is None else _coerce(env, type(default))


def get_flags(names: Union[str, Iterable[str]]):
    """Flag values: a scalar for one name, a dict for an iterable."""
    single = isinstance(names, str)
    out = {}
    with _lock:
        for n in ([names] if single else names):
            key = _canon(n)
            if key not in _values:
                raise KeyError(f"flag '{n}' is not defined")
            out[key] = _values[key]
    return next(iter(out.values())) if single else out


def set_flags(flags: Dict[str, Any]) -> None:
    with _lock:
        for n, v in flags.items():
            key = _canon(n)
            if key not in _values:
                raise KeyError(f"flag '{n}' is not defined")
            _values[key] = _coerce(v, type(_defaults[key]))


def flag_info(name: str) -> Dict[str, Any]:
    key = _canon(name)
    with _lock:
        return {"name": key, "default": _defaults[key], "doc": _docs[key],
                "value": _values[key]}


define_flag("serving_block_size", 16,
            "Tokens per KV-cache page in the serving engine's paged "
            "allocator (serving/kv_cache.py).")
define_flag("serving_num_blocks", 512,
            "Pages in the preallocated KV-cache pool, per layer (K and V "
            "each). Page 0 is the padding sink, so serving_num_blocks - 1 "
            "pages are usable.")
define_flag("serving_max_batch", 8,
            "Decode batch of the continuous-batching scheduler: every "
            "decode step runs at exactly this batch, padded with inert "
            "rows.")
define_flag("serving_prefill_chunk", 128,
            "Prefill token budget per scheduler step; shorter chunks are "
            "padded to it.")
define_flag("serving_prefix_cache", "on",
            "Cross-request prefix cache over the paged KV pool "
            "(content-hashed full blocks, refcounts, copy-on-write, LRU). "
            "'off' gives every request private block tables. Read at "
            "engine/pool construction.")
define_flag("serving_use_rpa_kernel", "auto",
            "Ragged paged attention decode kernel dispatch: 'auto' uses the "
            "CUDA kernel when the engine runs on a CUDA device and the plain "
            "gather path on the CPU; 'on'/'off' force one path ('on' on the "
            "CPU routes decode through the kernel wrapper, which computes "
            "its plain version for CPU tensors).")
define_flag("serving_kv_quant", "off",
            "Paged KV-cache pool precision (serving/kv_cache.py): 'off' "
            "keeps pools in the model dtype; 'int8' stores K/V pages as "
            "symmetric int8 codes with one f32 scale per (token, kv-head) "
            "vector in a (pages, page, Hkv, 1) scale pool beside each page "
            "pool, quantized on write by paged_kv_update_quant and "
            "dequantized by the decode kernel after each row's load. Read "
            "at pool construction only.")
define_flag("weight_quant_group", 128,
            "In-dim rows per scale group for weight-only quantization "
            "(quantize/): each (group x out-column) block of a Linear "
            "weight carries one f32 scale beside its int8/int4 codes.")
define_flag("weight_quant_kernel", "auto",
            "Weight-only quant_matmul dispatch (ops/cuda/quant_matmul.py), "
            "decided when quantize_for_inference builds each layer: 'auto' "
            "uses the CUDA kernel for weights on a CUDA device and the "
            "plain dequantize-then-matmul path on the CPU; 'on'/'off' force "
            "one path ('on' on the CPU routes through the kernel wrapper, "
            "which computes its plain version for CPU tensors; 'off' on the "
            "card is the caller's explicit choice of the plain path).")
define_flag("retrace_warn_threshold", 8,
            "Warn once a captured step (a train step, a serving step "
            "signature) has been captured this many times — the recapture "
            "tripwire (jit/compile_cache.py note_trace). 0 disables the "
            "warning.")
define_flag("exact_dropout_mask", False,
            "Force exact Bernoulli(p) dropout masks instead of the "
            "1/256-quantised fast u8 masks (nn/functional/common.py "
            "fast_keep_mask) for parity-sensitive comparisons against "
            "the reference framework.")
