"""LLM serving: paged KV cache with a prefix cache, continuous-batching
scheduler, and the engine (counterpart of ``paddle_tpu/serving``)."""

from .engine import ServingEngine  # noqa: F401
from .kv_cache import PagedKVCache, block_chain  # noqa: F401
from .scheduler import ContinuousBatchingScheduler, Request  # noqa: F401
