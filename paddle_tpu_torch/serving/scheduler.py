"""Continuous-batching scheduler: per-step admit / prefill / decode / evict
over the paged KV cache (counterpart of ``paddle_tpu/serving/scheduler.py``).

Each engine step the scheduler hands out ONE plan:

* ``("prefill", (request, start, stop))`` — the next chunk of the oldest
  request with unprefilled prompt; long prompts prefill across steps.
* ``("decode", [requests])`` — every RUNNING request advances one token.
* ``("idle", hint)`` — nothing runnable.

Admission is continuous and charged by NEW blocks (cached prefix blocks map
for free; hit tokens skip their prefill chunks).  When the pool runs dry
mid-decode the youngest running request is preempted BY EVICTION: its
pages are freed and it re-queues at the front with its generated tokens
folded into the prompt (recompute on resume).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, List, Optional, Tuple

from .control_plane import INTERACTIVE, PRIORITY_RANK, InvalidRequestError
from .kv_cache import PagedKVCache

__all__ = ["Request", "ContinuousBatchingScheduler"]

WAITING = "waiting"
PREFILLING = "prefilling"
RUNNING = "running"
FINISHED = "finished"
CANCELLED = "cancelled"


class Request:
    """One generation request and its lifecycle bookkeeping."""

    _next_rid = 0

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 arrival_time: Optional[float] = None,
                 priority: str = INTERACTIVE) -> None:
        self.rid = Request._next_rid
        Request._next_rid += 1
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.priority = priority if priority in PRIORITY_RANK \
            else INTERACTIVE
        self.state = WAITING
        self.prefill_pos = 0              # prompt tokens already in KV
        self.out_tokens: List[int] = []
        # tokens generated BEFORE an eviction: folded into the prompt for
        # KV recompute but still part of this request's output
        self.folded_tokens: List[int] = []
        self.preemptions = 0
        self.arrival_time = arrival_time  # None = already arrived
        self.submitted_at: Optional[float] = None
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        # why the last preemption happened (_evict_one's reason)
        self.preempt_reason: Optional[str] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return self.state in (FINISHED, CANCELLED)

    @property
    def output_tokens(self) -> List[int]:
        """Every token this request generated, including any folded into
        the prompt by a preemption."""
        return self.folded_tokens + self.out_tokens

    def note_token(self, token: int, now: float) -> None:
        self.out_tokens.append(int(token))
        if self.first_token_at is None:
            self.first_token_at = now

    def hit_stop(self) -> bool:
        if len(self.out_tokens) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and self.out_tokens
                and self.out_tokens[-1] == self.eos_id)


class ContinuousBatchingScheduler:
    """Admission queue + active set over one :class:`PagedKVCache`."""

    def __init__(self, kv: PagedKVCache, max_batch: int,
                 prefill_chunk: int) -> None:
        self.kv = kv
        self.max_batch = int(max_batch)
        self.prefill_chunk = int(prefill_chunk)
        self.waiting: Deque[Request] = deque()
        self.active: List[Request] = []
        # after a prefill chunk a runnable decode batch goes first, so
        # decode never waits more than one chunk behind a long prefill
        self._prefer_decode = False
        # draining (ServingEngine.drain): admit nothing more, run what is
        # already admitted to completion
        self.draining = False

    # -- intake -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submitted_at = time.perf_counter()
        self.waiting.append(req)

    def cancel(self, rid: int) -> bool:
        """Kill a request wherever it is; its KV pages return at once."""
        for req in list(self.active):
            if req.rid == rid:
                self.kv.free(rid)
                self.active.remove(req)
                req.state = CANCELLED
                return True
        for req in list(self.waiting):
            if req.rid == rid:
                self.waiting.remove(req)
                req.state = CANCELLED
                return True
        return False

    def finish(self, req: Request) -> None:
        self.kv.free(req.rid)
        if req in self.active:
            self.active.remove(req)
        req.state = FINISHED

    # -- admission --------------------------------------------------------
    def _next_admit(self, now: float) -> Optional[Request]:
        """Among ARRIVED waiting requests the best (lowest) priority rank
        wins; FIFO within a class."""
        best: Optional[Request] = None
        best_rank = None
        for req in self.waiting:
            if req.arrival_time is not None and req.arrival_time > now:
                continue
            rank = PRIORITY_RANK.get(req.priority, 0)
            if best is None or rank < best_rank:
                best, best_rank = req, rank
                if rank == 0:
                    break
        return best

    def _try_admit(self, now: float) -> None:
        if self.draining:
            return
        while len(self.active) < self.max_batch:
            req = self._next_admit(now)
            if req is None:
                break
            total = req.prompt_len + req.max_new_tokens
            cap = self.kv.max_pages_per_seq * self.kv.block_size
            if cap < total:
                raise InvalidRequestError(
                    f"request {req.rid} needs {total} tokens but the cache "
                    f"tops out at {cap} per sequence")
            # charged by NEW blocks: cached prefix blocks are mapped
            if not self.kv.alloc(req.rid, req.prompt_len,
                                 tokens=req.prompt):
                break                      # pool pressure: retry later
            self.waiting.remove(req)
            req.state = PREFILLING
            # cached prompt tokens skip their prefill chunks
            req.prefill_pos = self.kv.prefix_hit_tokens(req.rid)
            req.admitted_at = now
            self.active.append(req)

    # -- eviction ---------------------------------------------------------
    def _evict_one(self, protect: Optional[Request] = None,
                   reason: str = "kv_pool_exhausted") -> bool:
        """Preempt the youngest running request (≠ ``protect``; batch-class
        before interactive): free its pages and re-queue it at the front
        with generated tokens folded into the prompt.  ``reason`` (why it
        was preempted) lands on the request as ``preempt_reason``."""
        victims = [r for r in self.active
                   if r is not protect and r.state in (RUNNING, PREFILLING)]
        if not victims:
            return False
        victim = max(victims,
                     key=lambda r: (PRIORITY_RANK.get(r.priority, 0),
                                    r.admitted_at or 0.0, r.rid))
        self.kv.free(victim.rid)
        self.active.remove(victim)
        victim.prompt = victim.prompt + victim.out_tokens
        victim.max_new_tokens -= len(victim.out_tokens)
        victim.folded_tokens = victim.folded_tokens + victim.out_tokens
        victim.out_tokens = []
        victim.prefill_pos = 0
        victim.state = WAITING
        victim.preemptions += 1
        victim.preempt_reason = reason
        self.waiting.appendleft(victim)
        return True

    def reserve_decode_token(self, req: Request) -> bool:
        """Grow ``req`` by one KV slot, evicting others until it fits.
        False = even an empty pool cannot host it."""
        tok = req.out_tokens[-1] if req.out_tokens else None
        while not self.kv.append(req.rid, 1, token=tok,
                                 deferred_write=True):
            if not self._evict_one(protect=req):
                return False
        return True

    # -- planning ---------------------------------------------------------
    def next_plan(self, now: Optional[float] = None
                  ) -> Tuple[str, object]:
        """One step's work: ("prefill", (req, start, stop)) |
        ("decode", [reqs]) | ("idle", wait_hint_seconds_or_None)."""
        now = time.perf_counter() if now is None else now
        self._try_admit(now)
        running = [r for r in self.active if r.state == RUNNING]
        if not (running and self._prefer_decode):
            for req in self.active:
                if req.state == PREFILLING:
                    self._prefer_decode = True
                    start = req.prefill_pos
                    stop = min(req.prompt_len, start + self.prefill_chunk)
                    return ("prefill", (req, start, stop))
        if running:
            self._prefer_decode = False
            return ("decode", running[:self.max_batch])
        if self.waiting:
            fut = [r.arrival_time for r in self.waiting
                   if r.arrival_time is not None]
            hint = max(0.0, min(fut) - now) if fut else None
            return ("idle", hint)
        return ("idle", None)
