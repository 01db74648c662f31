"""Distributed checkpoint (counterpart of
``paddle_tpu/distributed/checkpoint``; Paddle's
paddle.distributed.checkpoint): a .npy a shard, each rank's manifest and
the coordinator's merged one, CRC32 checksums; a synchronous snapshot
to host memory with the file writes on a writer thread (``async_save``);
a validated, in-place load with fallback to the newest valid save.
"""

from .metadata import (CheckpointCorruptionError, LocalTensorMetadata,  # noqa: F401
                       Metadata, array_checksum, compute_overlap,
                       dump_pickle_checked, load_pickle_checked)
from .save_state_dict import save_state_dict, wait_save  # noqa: F401
from .load_state_dict import get_rank_to_files, load_state_dict  # noqa: F401

__all__ = ["save_state_dict", "load_state_dict", "wait_save",
           "get_rank_to_files", "compute_overlap", "LocalTensorMetadata",
           "Metadata", "CheckpointCorruptionError", "array_checksum",
           "dump_pickle_checked", "load_pickle_checked"]
