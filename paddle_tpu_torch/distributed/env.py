"""The process's place in a job (counterpart of
``paddle_tpu/distributed/env.py:49-96``): ``get_rank``,
``get_world_size`` and ``is_initialized``.

They read ``torch.distributed`` where its process group is initialized,
else the launcher's ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``
(0 / 1 when unset), as the reference reads its environment.
``init_parallel_env`` and the mesh come with ROADMAP item A7.
"""

from __future__ import annotations

import os

import torch.distributed as dist

__all__ = ["get_rank", "get_world_size", "is_initialized"]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    if is_initialized():
        return dist.get_rank(group)
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size(group=None) -> int:
    if is_initialized():
        return dist.get_world_size(group)
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
