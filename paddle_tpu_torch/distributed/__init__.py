"""paddle_tpu_torch.distributed: the process's rank and world size
(``env.py``), sharded checkpoints (``checkpoint/``) and the single-device
parallel layers (``fleet/meta_parallel/mp_layers.py``); the mesh,
collectives and sharding come with ROADMAP item A7."""

from .env import get_rank, get_world_size, is_initialized  # noqa: F401
from . import checkpoint  # noqa: F401,E402

__all__ = ["get_rank", "get_world_size", "is_initialized"]
