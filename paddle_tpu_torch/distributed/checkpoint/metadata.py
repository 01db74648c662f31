"""Checkpoint metadata (counterpart of
``paddle_tpu/distributed/checkpoint/metadata.py``; Paddle's
python/paddle/distributed/checkpoint/metadata.py:20/40) and the integrity
layer: CRC32 checksums of each shard's raw bytes and self-verifying
pickle envelopes, so a load rejects torn or corrupt files by name.

pickle names a class by its module path, and the reference's metadata
classes live at ``paddle_tpu.distributed.checkpoint.metadata``: the port
writes its own ``LocalTensorMetadata`` and ``Metadata`` under those names
and reads them back into its classes (``framework/io_utils.py``'s
``RefPickler`` and ``RefUnpickler``), so a manifest is byte for byte the
reference's and each package reads the other's checkpoints, neither
importing the other.
"""

from __future__ import annotations

import io
import pickle
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ...framework.io_utils import RefPickler, RefUnpickler

__all__ = ["LocalTensorMetadata", "Metadata", "compute_overlap",
           "CheckpointCorruptionError", "array_checksum",
           "dump_pickle_checked", "load_pickle_checked"]

_REF_MODULE = "paddle_tpu.distributed.checkpoint.metadata"
_PROTOCOL = 4


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint file failed validation (checksum mismatch, torn read,
    missing shard, or an unreadable manifest). Carries the rejected file
    names so callers can report exactly what was discarded."""

    def __init__(self, message: str, files: Tuple[str, ...] = ()) -> None:
        super().__init__(message)
        self.files = tuple(files)


def crc32_hex(crc: int) -> str:
    return f"crc32:{crc & 0xFFFFFFFF:08x}"


def array_checksum(arr) -> str:
    """CRC32 of an array's raw bytes, as stored in shard metadata."""
    data = arr.tobytes() if hasattr(arr, "tobytes") else bytes(arr)
    return crc32_hex(zlib.crc32(data))


@dataclass
class LocalTensorMetadata:
    """One saved shard: its place in the global tensor + its storage file.

    ``checksum`` is the CRC32 of the shard's raw bytes ("" for legacy
    checkpoints saved before integrity checking existed)."""
    global_shape: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    global_offset: Tuple[int, ...]
    dtype: str
    file_name: str = ""
    checksum: str = ""


@dataclass
class Metadata:
    """Global checkpoint manifest (written by the coordinator rank)."""
    state: Dict[str, List[LocalTensorMetadata]] = field(default_factory=dict)
    flat_mapping: Dict[str, str] = field(default_factory=dict)


_CLASSES = {"LocalTensorMetadata": LocalTensorMetadata,
            "Metadata": Metadata}


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    RefPickler(buf, _PROTOCOL, _REF_MODULE, _CLASSES).dump(obj)
    return buf.getvalue()


def _loads(fileobj):
    return RefUnpickler(fileobj, (_REF_MODULE, __name__), _CLASSES).load()


_ENVELOPE_KEY = "__ckpt_payload__"


def dump_pickle_checked(obj, fileobj) -> None:
    """Pickle ``obj`` wrapped in a checksummed envelope: the file carries
    {payload_bytes, crc32}, making every manifest self-verifying."""
    payload = _dumps(obj)
    pickle.dump({_ENVELOPE_KEY: payload,
                 "crc32": zlib.crc32(payload) & 0xFFFFFFFF},
                fileobj, protocol=_PROTOCOL)


def load_pickle_checked(fileobj, label: str = "manifest"):
    """Unpickle a checked envelope (or a legacy bare pickle). Raises
    :class:`CheckpointCorruptionError` on checksum mismatch or a torn/
    undecodable file."""
    try:
        obj = _loads(fileobj)
    except Exception as e:
        raise CheckpointCorruptionError(
            f"{label}: unreadable pickle ({type(e).__name__}: {e})",
            files=(label,)) from e
    if isinstance(obj, dict) and _ENVELOPE_KEY in obj:
        payload = obj[_ENVELOPE_KEY]
        if zlib.crc32(payload) & 0xFFFFFFFF != obj.get("crc32"):
            raise CheckpointCorruptionError(
                f"{label}: checksum mismatch", files=(label,))
        try:
            return _loads(io.BytesIO(payload))
        except Exception as e:
            raise CheckpointCorruptionError(
                f"{label}: corrupt payload ({type(e).__name__}: {e})",
                files=(label,)) from e
    return obj  # legacy checkpoint written before envelopes existed


def compute_overlap(saved_offset: Tuple[int, ...],
                    saved_shape: Tuple[int, ...],
                    target_offset: Tuple[int, ...],
                    target_shape: Tuple[int, ...]):
    """Intersection of a saved shard and a target shard in global coords.

    Returns ``(src_slices, dst_slices)`` — the region inside the saved
    local array and the matching region inside the target local array — or
    ``None`` when they do not overlap (Paddle's load_state_dict.py:229
    compute_overlap).
    """
    src, dst = [], []
    for so, ss, to, ts in zip(saved_offset, saved_shape,
                              target_offset, target_shape):
        lo = max(so, to)
        hi = min(so + ss, to + ts)
        if hi <= lo:
            return None
        src.append(slice(lo - so, hi - so))
        dst.append(slice(lo - to, hi - to))
    return tuple(src), tuple(dst)
