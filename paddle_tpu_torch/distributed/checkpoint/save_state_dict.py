"""save_state_dict (counterpart of
``paddle_tpu/distributed/checkpoint/save_state_dict.py``; Paddle's
python/paddle/distributed/checkpoint/save_state_dict.py:77), in the
reference's layout on disk::

    path/
      {uid}_{rank}_{i}.npy    # one .npy a saved shard
      meta_{uid}_{rank}.pkl   # each rank's manifest (checked envelope)
      world_{uid}.txt         # the saving job's world size
      metadata.pkl            # the coordinator's merged Metadata

A tensor is one shard covering the whole tensor, saved by the rank that
holds it (DTensor shards come with ROADMAP item A7).  A bfloat16 shard is
written as the reference writes it, a ``'<V2'`` ``.npy`` of its 16-bit
words, and its manifest dtype is ``"bfloat16"`` (numpy has no bfloat16
without ``ml_dtypes``, which the port does not need).

The snapshot is synchronous: every tensor is copied to host memory
(pinned, for device tensors) and the copies are complete before
``save_state_dict`` returns, so the caller may update the tensors in place
at once.  With ``async_save=True`` the checksums and file writes then run
on a writer thread; ``wait_save`` joins it and raises what it raised.
The ``ckpt.shard.write`` failpoint fires before each shard's write
(``corrupt`` flips a byte of the written file).  The reference's
``ckpt.shards_written_total``/``ckpt.bytes_written_total`` counters, its
``ckpt.save`` span and flight-recorder events are ROADMAP item A5.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...utils import failpoint as _fp
from .metadata import (LocalTensorMetadata, Metadata, crc32_hex,
                       dump_pickle_checked, load_pickle_checked)

__all__ = ["save_state_dict", "wait_save"]

_pending_lock = threading.Lock()
_pending: Optional[threading.Thread] = None
_pending_error: List[BaseException] = []


def wait_save() -> None:
    """Block until an outstanding async save has committed to disk; raise
    what its writer raised."""
    global _pending
    with _pending_lock:
        t = _pending
    if t is not None:
        t.join()
    with _pending_lock:
        if _pending is t:
            _pending = None
        err = _pending_error[:]
        _pending_error.clear()
    if err:
        raise err[0]


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype ("float32", "bfloat16", ...), as
    the reference's manifests record it."""
    return str(dtype).replace("torch.", "")


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as numpy: bfloat16 as its uint16 words."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def array_crc(arr: np.ndarray) -> str:
    """``metadata.array_checksum`` of a C-contiguous array, read in place
    (no copy of its bytes)."""
    return crc32_hex(zlib.crc32(arr.reshape(-1).view(np.uint8)))


def _snapshot(state_dict: Dict[str, Any]) -> List[Tuple[str, torch.Tensor]]:
    """Host copies of every tensor, complete on return (the consistency
    point): device tensors into pinned memory by copies on each one's
    current stream, then a synchronize of each device."""
    out = []
    devices = set()
    for name, t in state_dict.items():
        if not isinstance(t, torch.Tensor):
            continue
        t = t.detach()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        host.copy_(t, non_blocking=t.is_cuda)
        if t.is_cuda:
            devices.add(t.device)
        out.append((name, host))
    for dev in devices:
        torch.cuda.synchronize(dev)
    return out


def _write_npy(fpath: str, arr: np.ndarray, bf16: bool) -> None:
    """``np.save``'s bytes; a bfloat16 shard's header says ``'<V2'``, as
    numpy writes an ``ml_dtypes`` bfloat16 array."""
    header = np.lib.format.header_data_from_array_1_0(arr)
    if bf16:
        header["descr"] = "<V2"
    with open(fpath, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        arr.tofile(f)


def _write(path: str, rank: int, coordinator_rank: int, shards,
           world_size: int, uid: str,
           barrier_timeout: float = 300.0) -> None:
    if rank == coordinator_rank:
        # publish the SAVER's world size BEFORE any shard/manifest of this
        # uid can be observed from this process, so a polling loader that
        # sees manifests almost always sees the authoritative count too;
        # write-then-rename so a polling loader never reads a torn file
        wf = os.path.join(path, f"world_{uid}.txt")
        with open(wf + ".tmp", "w") as f:
            f.write(str(world_size))
        os.replace(wf + ".tmp", wf)
    local_meta: Dict[str, List[LocalTensorMetadata]] = {}
    for counter, (name, host) in enumerate(shards):
        arr = host_array(host)
        # two tuples, as the reference's (a shared one would pickle as a
        # memo reference, and the manifest's bytes would differ)
        meta = LocalTensorMetadata(tuple(int(s) for s in host.shape),
                                   tuple(int(s) for s in host.shape),
                                   (0,) * host.dim(),
                                   dtype_name(host.dtype),
                                   f"{uid}_{rank}_{counter}.npy",
                                   array_crc(arr))
        fpath = os.path.join(path, meta.file_name)
        # failpoint BEFORE the write models a failed/partial write; the
        # corrupt action damages the committed bytes post-write so the
        # loader's checksum pass must catch it
        action = _fp.inject("ckpt.shard.write") if _fp.ACTIVE else None
        _write_npy(fpath, arr, host.dtype == torch.bfloat16)
        if action == "corrupt":
            _flip_byte(fpath)
        local_meta.setdefault(name, []).append(meta)
    # every process publishes its shard manifest under THIS save's uid;
    # the coordinator merges only after every rank's manifest for THIS
    # save exists (file barrier on shared storage)
    with open(os.path.join(path, f"meta_{uid}_{rank}.pkl"), "wb") as f:
        dump_pickle_checked(local_meta, f)
    if rank == coordinator_rank:
        deadline = time.monotonic() + barrier_timeout
        prefix = f"meta_{uid}_"
        while True:
            present = {fn for fn in os.listdir(path)
                       if fn.startswith(prefix) and fn.endswith(".pkl")}
            if len(present) >= world_size:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"save_state_dict: only {len(present)}/{world_size} "
                    f"rank manifests appeared within {barrier_timeout}s")
            time.sleep(0.1)
        _merge_metadata(path, uid)


def _flip_byte(fpath: str) -> None:
    """Corrupt one byte of a committed file (ckpt.shard.write=corrupt)."""
    with open(fpath, "rb") as f:
        data = f.read()
    with open(fpath, "wb") as f:
        f.write(_fp.corrupt_bytes(data))


def _merge_metadata(path: str, uid: str) -> None:
    merged = Metadata()
    prefix = f"meta_{uid}_"
    for fn in sorted(os.listdir(path)):
        if not (fn.startswith(prefix) and fn.endswith(".pkl")):
            continue
        with open(os.path.join(path, fn), "rb") as f:
            part = load_pickle_checked(f, label=fn)
        for name, metas in part.items():
            merged.state.setdefault(name, []).extend(metas)
    # atomic publish: load never sees a half-written manifest; the
    # envelope checksum catches bit rot after the rename
    tmp = os.path.join(path, f"metadata.pkl.{uid}.tmp")
    with open(tmp, "wb") as f:
        dump_pickle_checked(merged, f)
    os.replace(tmp, os.path.join(path, "metadata.pkl"))


def _writer(*args) -> None:
    try:
        _write(*args)
    except BaseException as e:  # noqa: BLE001 — raised by wait_save
        with _pending_lock:
            _pending_error.append(e)


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    unique_id=None, async_save: bool = False) -> None:
    """Save every tensor of ``state_dict`` under ``path`` (non-tensor
    values are skipped, as in the reference).  Multi-process saves
    (``PADDLE_TRAINERS_NUM`` or an initialized process group) need a
    ``unique_id`` shared by all ranks; a single process numbers its saves
    into a path itself."""
    global _pending
    wait_save()  # only one in-flight async save
    os.makedirs(path, exist_ok=True)
    from ..env import get_rank, get_world_size
    rank = get_rank(process_group)
    world = get_world_size(process_group)
    if unique_id is None:
        if world > 1:
            raise ValueError(
                "save_state_dict: multi-process saves need an explicit "
                "unique_id shared by all ranks (e.g. the global step)")
        existing = [fn for fn in os.listdir(path)
                    if fn.startswith("meta_") and fn.endswith(".pkl")]
        unique_id = len(existing)
    uid = str(unique_id)
    shards = _snapshot(state_dict)
    args = (path, rank, coordinator_rank, shards, world, uid)
    if async_save:
        t = threading.Thread(target=_writer, args=args,
                             name="distcp-async-save", daemon=False)
        with _pending_lock:
            _pending = t
        t.start()
    else:
        _write(*args)
