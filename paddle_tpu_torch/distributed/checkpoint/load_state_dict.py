"""load_state_dict (counterpart of
``paddle_tpu/distributed/checkpoint/load_state_dict.py``; Paddle's
python/paddle/distributed/checkpoint/load_state_dict.py:365).

1. ``get_rank_to_files`` — from the manifest, the shard FILES this
   process needs for its target tensors (Paddle's :40); files that
   contribute nothing are never opened.
2. ``compute_overlap`` — for each (saved shard, target) pair, the
   intersecting rectangle in both local coordinate systems (Paddle's
   :229).
3. Every needed file is read whole and checked against its CRC32
   before a single target changes; then each target is filled IN PLACE (its
   address kept, so an optimizer's update tables and a captured step stay
   valid) from the overlapping saved regions, cast to its dtype.

A target tensor is one shard covering the whole tensor until DTensor
shards come with ROADMAP item A7.  A shard whose manifest dtype is
``"bfloat16"`` is read as bfloat16 from its ``'<V2'`` words, where the
reference's own load fails (ROADMAP "Reference failures").  A torn or
corrupt newest checkpoint is rejected by name and the next-newest save
in ``path`` is loaded instead; ``CheckpointCorruptionError`` is raised
when none survives.  The ``ckpt.shard.read`` failpoint fires before each
file's read (``corrupt`` flips a byte of what was read).  The reference's
``ckpt.shards_read_total`` counter, ``ckpt.load`` span and
flight-recorder events are ROADMAP item A5.
"""

from __future__ import annotations

import logging
import os
import time as _time
from typing import Any, Dict, Iterator, List, Set, Tuple

import numpy as np
import torch

from ...utils import failpoint as _fp
from .metadata import (CheckpointCorruptionError, Metadata,
                       compute_overlap, load_pickle_checked)
from .save_state_dict import array_crc, wait_save

__all__ = ["load_state_dict", "get_rank_to_files",
           "CheckpointCorruptionError"]

logger = logging.getLogger("paddle_tpu_torch.checkpoint")


# ---------------------------------------------------------------------------
# Candidate enumeration (newest first)
# ---------------------------------------------------------------------------

def _manifest_uid(fn: str) -> str:
    return fn[len("meta_"):].rsplit("_", 1)[0]


def _manifest_groups(path: str) -> List[Tuple[str, List[str]]]:
    """Per-save manifest groups ``(uid, [meta_{uid}_{rank}.pkl...])``,
    newest (by manifest mtime) first."""
    groups: Dict[str, List[str]] = {}
    for fn in os.listdir(path):
        if fn.startswith("meta_") and fn.endswith(".pkl"):
            groups.setdefault(_manifest_uid(fn), []).append(fn)

    def _mtime(fn: str) -> float:
        try:
            return os.path.getmtime(os.path.join(path, fn))
        except OSError:
            return 0.0  # deleted between listdir and stat: sort it last

    def newest(uid: str) -> float:
        return max(_mtime(fn) for fn in groups[uid])

    return [(uid, sorted(groups[uid]))
            for uid in sorted(groups, key=newest, reverse=True)]


def _group_need(path: str, uid: str, group: List[str],
                allow_contiguity: bool):
    """How many rank manifests complete this save — an int, or None when
    the authoritative world file is still pending and contiguity is not
    yet trusted (newest-save polling phase)."""
    wf = os.path.join(path, f"world_{uid}.txt")
    if os.path.exists(wf):
        with open(wf) as f:
            raw = f.read().strip()
        if raw:
            try:
                return int(raw)
            except ValueError:
                logger.warning("world file %s is corrupt (%r); falling "
                               "back to rank contiguity", wf, raw)
    if not allow_contiguity:
        return None
    # LEGACY saves (no world_{uid}.txt): accept rank contiguity 0..max
    ranks = sorted(int(fn[len("meta_"):].rsplit("_", 1)[1][:-len(".pkl")])
                   for fn in group)
    return ranks[-1] + 1 if ranks == list(range(ranks[-1] + 1)) \
        else len(group) + 1


def _metadata_uids(meta: Metadata) -> Set[str]:
    """Save uids a merged manifest's shard files belong to (file names
    are ``{uid}_{rank}_{counter}.npy``)."""
    uids: Set[str] = set()
    for metas in meta.state.values():
        for m in metas:
            if m.file_name.count("_") >= 2:
                uids.add(m.file_name.rsplit("_", 2)[0])
    return uids


def _merge_group(path: str, group: List[str]) -> Metadata:
    """Merge one save's per-rank manifests (corruption-checked)."""
    merged = Metadata()
    for fn in group:
        with open(os.path.join(path, fn), "rb") as f:
            part = load_pickle_checked(f, label=fn)
        for name, metas in part.items():
            merged.state.setdefault(name, []).extend(metas)
    return merged


def _candidates(path: str, timeout: float,
                rejected: List[str]) -> Iterator[Tuple[Metadata, str]]:
    """Yield candidate checkpoints newest-first.

    Phase 1 polls for the newest save to become complete (a concurrent
    save may still be merging).  Phase 2 walks older manifest groups so a
    corrupt newest checkpoint degrades to the previous valid one instead
    of crashing.
    """
    deadline = _time.monotonic() + timeout
    yielded_uids: Set[str] = set()
    saw_metadata_pkl = False
    while True:
        expired = _time.monotonic() >= deadline
        mp = os.path.join(path, "metadata.pkl")
        if not saw_metadata_pkl and os.path.exists(mp):
            saw_metadata_pkl = True
            try:
                with open(mp, "rb") as f:
                    meta = load_pickle_checked(f, label="metadata.pkl")
            except CheckpointCorruptionError as e:
                rejected.extend(e.files)
                logger.warning("metadata.pkl rejected (%s); trying "
                               "per-rank manifests", e)
            else:
                # the manifest group of the same save is redundant with
                # metadata.pkl — don't offer it as a second candidate
                yielded_uids.update(_metadata_uids(meta))
                yield meta, "metadata.pkl"
        groups = _manifest_groups(path)
        if groups:
            uid, group = groups[0]
            if uid not in yielded_uids:
                need = _group_need(path, uid, group,
                                   allow_contiguity=expired)
                if need is not None and len(group) >= need:
                    yielded_uids.add(uid)
                    try:
                        yield _merge_group(path, group), f"save uid {uid}"
                    except CheckpointCorruptionError as e:
                        rejected.extend(e.files)
                        logger.warning("manifest group uid %s rejected "
                                       "(%s)", uid, e)
                    # resuming here means the candidate was rejected;
                    # waiting longer cannot repair it — fall back now
                    break
        if expired or saw_metadata_pkl:
            break
        _time.sleep(0.1)
    # Fallback phase: remaining saves, newest first.  The NEWEST group
    # still defers its contiguity heuristic to the poll deadline; OLDER
    # groups were superseded by a newer save, so no writer can still be
    # appending to them — merge immediately.
    all_groups = _manifest_groups(path)
    global_newest = all_groups[0][0] if all_groups else None
    for uid, group in all_groups:
        if uid in yielded_uids:
            continue
        while uid == global_newest and _time.monotonic() < deadline \
                and _group_need(path, uid, group,
                                allow_contiguity=False) is None:
            _time.sleep(0.1)
            group = [fn for fn in os.listdir(path)
                     if fn.startswith("meta_") and fn.endswith(".pkl")
                     and _manifest_uid(fn) == uid]
        need = _group_need(path, uid, group, allow_contiguity=True)
        if need is None or len(group) < need:
            # incomplete ≠ corrupt: an in-flight save is skipped without
            # marking its (intact) manifests rejected
            logger.warning("save uid %s incomplete (%d/%s manifests) — "
                           "skipped", uid, len(group), need)
            continue
        yielded_uids.add(uid)
        try:
            yield _merge_group(path, group), f"save uid {uid}"
        except CheckpointCorruptionError as e:
            rejected.extend(e.files)
            logger.warning("manifest group uid %s rejected (%s)", uid, e)


# ---------------------------------------------------------------------------
# Read plan + validated file cache
# ---------------------------------------------------------------------------

def _target_shards(t: torch.Tensor):
    """[(offset, shape)] of each target shard: one covering the tensor."""
    return [((0,) * t.dim(), tuple(t.shape))]


def get_rank_to_files(metadata: Metadata,
                      state_dict: Dict[str, Any]) -> Set[str]:
    """Files this process needs to read (Paddle's get_rank_to_files:40)."""
    needed: Set[str] = set()
    for name, target in state_dict.items():
        if not isinstance(target, torch.Tensor) or \
                name not in metadata.state:
            continue
        targets = _target_shards(target)
        for meta in metadata.state[name]:
            for t_off, t_shape in targets:
                if compute_overlap(meta.global_offset, meta.local_shape,
                                   t_off, t_shape) is not None:
                    needed.add(meta.file_name)
                    break
    return needed


class _FileCache:
    """Read + checksum-verify each needed .npy at most once."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._cache: Dict[str, np.ndarray] = {}

    def get(self, file_name: str, checksum: str = "") -> np.ndarray:
        if file_name not in self._cache:
            fpath = os.path.join(self.path, file_name)
            try:
                # inside the try: an injected read error degrades like a
                # real IO failure (reject file, try older save)
                action = _fp.inject("ckpt.shard.read") if _fp.ACTIVE \
                    else None
                arr = np.load(fpath, allow_pickle=False)
            except Exception as e:
                raise CheckpointCorruptionError(
                    f"shard {file_name}: unreadable "
                    f"({type(e).__name__}: {e})",
                    files=(file_name,)) from e
            if action == "corrupt":
                arr = np.frombuffer(_fp.corrupt_bytes(arr.tobytes()),
                                    arr.dtype).reshape(arr.shape)
            if checksum and array_crc(arr) != checksum:
                raise CheckpointCorruptionError(
                    f"shard {file_name}: checksum mismatch",
                    files=(file_name,))
            self._cache[file_name] = arr
        return self._cache[file_name]


def _as_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A host tensor over a shard's data, by its manifest dtype: a
    bfloat16 shard's ``'<V2'`` (or uint16) words as bfloat16."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# Per-tensor read plan: [(file_name, dtype, src, dst), ...]
_ReadPlan = Dict[str, List[Tuple[str, str, tuple, tuple]]]


def _validate(metadata: Metadata, state_dict: Dict[str, Any],
              path: str) -> Tuple[_FileCache, _ReadPlan]:
    """Read + verify every file this load will touch, BEFORE mutating any
    target tensor — a partially-applied state_dict must never happen.
    Shape mismatches raise ValueError (config error, no fallback)."""
    cache = _FileCache(path)
    plan: _ReadPlan = {}
    bad: List[str] = []
    for name, target in state_dict.items():
        if not isinstance(target, torch.Tensor) or \
                name not in metadata.state:
            continue
        saved = metadata.state[name]
        gshape = saved[0].global_shape
        if tuple(gshape) != tuple(target.shape):
            raise ValueError(
                f"checkpoint '{name}': saved global shape {gshape} != "
                f"target shape {tuple(target.shape)}")
        for t_off, t_shape in _target_shards(target):
            covered = 0
            parts = []
            for meta in saved:
                ov = compute_overlap(meta.global_offset, meta.local_shape,
                                     t_off, t_shape)
                if ov is None:
                    continue
                try:
                    cache.get(meta.file_name, getattr(meta, "checksum", ""))
                except CheckpointCorruptionError as e:
                    bad.extend(e.files)
                    continue
                src, dst = ov
                parts.append((meta.file_name, meta.dtype, src, dst))
                covered += int(np.prod([s.stop - s.start for s in dst]))
            if covered < int(np.prod(t_shape)):
                # missing rank files / holes: this candidate cannot fill
                # the tensor — reject it here, before anything mutates
                raise CheckpointCorruptionError(
                    f"checkpoint '{name}': saved shards cover only "
                    f"{covered} of {int(np.prod(t_shape))} elements of "
                    f"the target shard at offset {t_off}"
                    + (f"; failed files: {sorted(set(bad))}" if bad
                       else ""),
                    files=tuple(sorted(set(bad))))
            plan[name] = parts
    if bad:
        raise CheckpointCorruptionError(
            f"{len(bad)} shard file(s) failed validation: "
            f"{sorted(set(bad))}", files=tuple(sorted(set(bad))))
    return cache, plan


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

@torch.no_grad()
def load_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    unique_id=None, offload: bool = False,
                    timeout: float = 30.0) -> None:
    """Fill ``state_dict``'s tensors in place from the checkpoint under
    ``path``.

    ``timeout`` bounds the wait for a concurrent save's metadata to become
    complete; it is also how long a LEGACY checkpoint (no world_{uid}.txt)
    waits before the rank-contiguity fallback merges it.  A corrupt or
    torn checkpoint is rejected (with the offending files logged) and the
    next-newest valid save in ``path`` is loaded instead;
    :class:`CheckpointCorruptionError` is raised only when no candidate
    survives validation."""
    wait_save()  # an async save to this path must be durable first

    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")

    rejected: List[str] = []
    reasons: List[str] = []
    chosen = None
    candidates = 0
    for metadata, label in _candidates(path, timeout, rejected):
        candidates += 1
        try:
            cache, plan = _validate(metadata, state_dict, path)
        except CheckpointCorruptionError as e:
            rejected.extend(e.files)
            reasons.append(f"{label}: {e}")
            logger.warning("checkpoint candidate %s rejected: %s — "
                           "falling back to an older save", label, e)
            continue
        chosen = (cache, plan, label)
        break
    if chosen is None:
        if candidates == 0 and not rejected:
            if not any(fn.startswith("meta_") and fn.endswith(".pkl")
                       for fn in os.listdir(path)):
                raise FileNotFoundError(
                    f"no checkpoint metadata under {path}")
            raise TimeoutError(
                f"checkpoint under {path} is incomplete after {timeout}s")
        raise CheckpointCorruptionError(
            f"no valid checkpoint under {path}; rejected files: "
            f"{sorted(set(rejected))}"
            + ("; " + " | ".join(reasons) if reasons else ""),
            files=tuple(sorted(set(rejected))))
    cache, plan, label = chosen
    if rejected:
        logger.warning("recovered by loading %s; rejected files: %s",
                       label, sorted(set(rejected)))

    # apply: fill each target from the VALIDATED plan (coverage and
    # checksums were proven above), in place
    for name, target in state_dict.items():
        parts = plan.get(name)
        if parts is None:
            continue
        for file_name, dtype, src, dst in parts:
            data = _as_tensor(cache.get(file_name), dtype)
            target[dst].copy_(data[src])
