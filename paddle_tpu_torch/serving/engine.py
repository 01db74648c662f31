"""The serving engine: prefill/decode steps over the paged KV cache, driven
by the continuous-batching scheduler (counterpart of
``paddle_tpu/serving/engine.py``).

Traffic is bucketed into two fixed step shapes, as in the reference:

* **decode** — ``(max_batch, 1)`` tokens; short batches are padded with
  inert rows (seq_len 0, block table of page 0) whose writes land in the
  reserved padding page and whose outputs are discarded.
* **prefill** — ``(1, prefill_chunk)`` tokens: one request's next chunk,
  padded to the chunk budget.  Only the last REAL token's hidden state
  reaches the lm_head.

Steps run eagerly.  The KV pools are updated in place, which stands in for
the reference's donated jit buffers; copy-on-write page copies queued by
the prefix cache are applied at the start of the next step, before its KV
writes.  Decode attention runs the CUDA ragged-paged-attention kernel when
the engine is on the card (``FLAGS_serving_use_rpa_kernel``); prefill
always takes the plain gather path, as in the reference.  With
``FLAGS_serving_kv_quant=int8`` the pools hold int8 codes and every step
passes their scale pools along (quantize-on-write, the quantized decode
kernel, copy-on-write of codes and scales alike).  A model quantized by
``quantize_for_inference`` runs its Linears through the quantized matmul
kernel; the engine needs nothing else for it.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.place import resolve_device
from ..flags import get_flags
from ..nn.functional import linear
from .attention import PagedCacheView, paged_kv_copy, use_rpa_kernel
from .control_plane import INTERACTIVE, InvalidRequestError
from .kv_cache import PagedKVCache
from .scheduler import RUNNING, ContinuousBatchingScheduler, Request

__all__ = ["ServingEngine"]


class ServingEngine:
    """Continuous-batching greedy generation over one causal-LM model.

    Works with any model exposing the Llama-shaped serving surface:
    ``model.config`` (num_hidden_layers / num_key_value_heads / head_dim /
    dtype / tie_word_embeddings), ``model.llama(ids, caches=, positions=)``
    returning final hidden states, and ``model.lm_head`` (or tied
    embeddings).  ``device=None`` means the card; pass ``device="cpu"`` to
    serve on the CPU.  The model must already live on that device.
    """

    def __init__(self, model, block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 use_kernel: Optional[bool] = None, device=None) -> None:
        cfg = model.config
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device != self.device:
            raise ValueError(f"the model lives on {model_device} but the "
                             f"engine was asked for {self.device}")
        max_pos = getattr(cfg, "max_position_embeddings", None)
        if max_seq_len is not None and max_pos and max_seq_len > max_pos:
            raise ValueError(
                f"max_seq_len={max_seq_len} exceeds the model's "
                f"max_position_embeddings={max_pos}: rope positions past "
                f"the table do not exist")
        self.model = model
        self.max_batch = int(max_batch if max_batch is not None
                             else get_flags("serving_max_batch"))
        self.prefill_chunk = int(prefill_chunk if prefill_chunk is not None
                                 else get_flags("serving_prefill_chunk"))
        self.kv = PagedKVCache(
            cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim,
            dtype=cfg.dtype, block_size=block_size, num_blocks=num_blocks,
            max_seq_len=max_seq_len or cfg.max_position_embeddings,
            device=self.device)
        self.scheduler = ContinuousBatchingScheduler(
            self.kv, self.max_batch, self.prefill_chunk)
        self._use_kernel = (use_rpa_kernel(self.device) if use_kernel is None
                            else bool(use_kernel))
        self._scale = 1.0 / math.sqrt(cfg.head_dim)
        self._warmed = False
        # host wall time of the executed steps, each ending in the sync
        # that reads its sampled tokens back
        self.stats = {"prefill_steps": 0, "decode_steps": 0,
                      "prefill_seconds": 0.0, "decode_seconds": 0.0}
        self.last_logits: Optional[torch.Tensor] = None
        self.last_requests: List[Request] = []

    # -- steps ------------------------------------------------------------
    def _tensor(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self.device, dtype=dtype)

    def _run_step(self, ids, pos, bt, sl, slot_pages, slot_offsets,
                  last_idx, kernel: bool) -> torch.Tensor:
        """One forward over the pools: apply queued CoW copies, write this
        step's K/V, attend, and project only ``last_idx`` positions.
        Returns (B, vocab) logits."""
        model = self.model
        i64, i32 = torch.int64, torch.int32
        pos_t = self._tensor(pos, i64)
        bt_t = self._tensor(bt, i32)
        sl_t = self._tensor(sl, i32)
        sp_t = self._tensor(slot_pages, i64)
        so_t = self._tensor(slot_offsets, i64)
        with torch.no_grad():
            pend = self.kv.take_pending_copies()
            pools = self.kv.layer_pools()
            if pend:
                src = self._tensor(np.asarray([s for s, _ in pend]), i64)
                dst = self._tensor(np.asarray([d for _, d in pend]), i64)
                # a copied page takes its scales with it (int8 pool)
                for layer in pools:
                    for a, b in zip(layer[0::2], layer[1::2]):
                        paged_kv_copy(a, b, src, dst)
            views = [PagedCacheView(layer[0], layer[1], bt_t, sl_t, sp_t,
                                    so_t, pos_t, self._scale, kernel,
                                    *layer[2:])
                     for layer in pools]
            hidden = model.llama(self._tensor(ids, i64), caches=views,
                                 positions=pos_t)
            rows = torch.arange(hidden.shape[0], device=self.device)
            hb = hidden[rows, self._tensor(last_idx, i64)]   # (B, hidden)
            if model.config.tie_word_embeddings:
                logits = linear(hb, model.llama.embed_tokens.weight.t())
            else:
                logits = model.lm_head(hb)
        self.last_logits = logits
        return logits

    def warmup(self) -> None:
        """Run one zero-filled step of each shape, which builds every kernel
        the steps launch (the decode kernel when selected, its int8 variant
        for an int8 pool, the quantized matmul for a quantized model):
        every write lands in page 0 and seq_len 0 masks every read."""
        b, c, p = self.max_batch, self.prefill_chunk, self.kv.max_pages_per_seq
        z = np.zeros
        self._run_step(z((b, 1), np.int64), z((b, 1), np.int64),
                       z((b, p), np.int32), z((b,), np.int32),
                       z((b,), np.int64), z((b,), np.int64),
                       z((b,), np.int64), kernel=self._use_kernel)
        self._run_step(z((1, c), np.int64), z((1, c), np.int64),
                       z((1, p), np.int32), z((1,), np.int32),
                       z((c,), np.int64), z((c,), np.int64),
                       z((1,), np.int64), kernel=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed = True

    # -- request intake ---------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               arrival_time: Optional[float] = None,
               priority: str = INTERACTIVE) -> Request:
        """Queue one request; impossible requests raise
        :class:`InvalidRequestError` at intake."""
        if not prompt:
            raise InvalidRequestError("empty prompt")
        total = len(prompt) + int(max_new_tokens)
        seq_cap = self.kv.max_pages_per_seq * self.kv.block_size
        if total > seq_cap:
            raise InvalidRequestError(
                f"request needs {total} tokens but the cache tops out at "
                f"{seq_cap} per sequence")
        usable = self.kv.num_blocks - 1          # page 0 is reserved
        need = self.kv.blocks_needed(len(prompt))
        if need > usable:
            raise InvalidRequestError(
                f"prompt needs {need} KV pages but the whole pool has "
                f"{usable} (FLAGS_serving_num_blocks)")
        req = Request(list(prompt), max_new_tokens, eos_id=eos_id,
                      arrival_time=arrival_time, priority=priority)
        self.scheduler.submit(req)
        return req

    def cancel(self, rid: int) -> bool:
        """Kill a request mid-flight; its KV pages return immediately."""
        return self.scheduler.cancel(rid)

    # -- the serving loop -------------------------------------------------
    def step(self) -> str:
        """Run one scheduler plan; returns the phase executed
        ("prefill" | "decode" | "idle")."""
        kind, payload = self.scheduler.next_plan()
        if kind == "prefill":
            self._run_prefill(*payload)
        elif kind == "decode":
            self._run_decode(payload)
        return kind

    def _run_prefill(self, req: Request, start: int, stop: int) -> None:
        t0 = time.perf_counter()
        n = stop - start
        c = self.prefill_chunk
        ids = np.zeros((1, c), np.int64)
        ids[0, :n] = req.prompt[start:stop]
        pos = np.zeros((1, c), np.int64)
        pos[0, :n] = np.arange(start, stop)
        slot_pages = np.zeros((c,), np.int64)
        slot_offsets = np.zeros((c,), np.int64)
        for i, ap in enumerate(range(start, stop)):
            # cached positions (a full prefix hit's one recompute token)
            # write to the page-0 sink: the cached K/V stays authoritative
            slot_pages[i], slot_offsets[i] = self.kv.write_slot(req.rid, ap)
        bt = np.asarray([self.kv.padded_table(req.rid)], np.int32)
        sl = np.asarray([stop], np.int32)
        last_idx = np.asarray([n - 1], np.int64)
        logits = self._run_step(ids, pos, bt, sl, slot_pages, slot_offsets,
                                last_idx, kernel=False)
        self.kv.append(req.rid, n)       # pages were reserved at alloc()
        req.prefill_pos = stop
        if stop == req.prompt_len:
            if req.max_new_tokens <= 0:
                self.scheduler.finish(req)
            else:
                # the final chunk's logits ARE the first sampled token
                token = int(logits[0].argmax())
                req.state = RUNNING
                req.note_token(token, time.perf_counter())
                if req.hit_stop():
                    self.scheduler.finish(req)
        self.stats["prefill_steps"] += 1
        self.stats["prefill_seconds"] += time.perf_counter() - t0

    def _run_decode(self, reqs: List[Request]) -> None:
        t0 = time.perf_counter()
        # reserve this step's KV slot per request; reservations may evict
        # (preempt) later requests in the list, so filter afterwards
        for req in list(reqs):
            if req.state == RUNNING and \
                    not self.scheduler.reserve_decode_token(req):
                # the pool cannot host even one more token anywhere
                self.scheduler.finish(req)
        live = [r for r in reqs if r.state == RUNNING][:self.max_batch]
        if not live:
            return
        b = self.max_batch
        p = self.kv.max_pages_per_seq
        ids = np.zeros((b, 1), np.int64)
        pos = np.zeros((b, 1), np.int64)
        bt = np.zeros((b, p), np.int32)
        sl = np.zeros((b,), np.int32)
        slot_pages = np.zeros((b,), np.int64)
        slot_offsets = np.zeros((b,), np.int64)
        last_idx = np.zeros((b,), np.int64)
        for i, req in enumerate(live):
            new_len = self.kv.seq_len(req.rid)      # includes this token
            ids[i, 0] = req.out_tokens[-1]
            pos[i, 0] = new_len - 1
            bt[i] = self.kv.padded_table(req.rid)
            sl[i] = new_len
            slot_pages[i], slot_offsets[i] = self.kv.write_slot(
                req.rid, new_len - 1)
        logits = self._run_step(ids, pos, bt, sl, slot_pages, slot_offsets,
                                last_idx, kernel=self._use_kernel)
        tokens = logits.argmax(dim=-1).tolist()
        now = time.perf_counter()
        for i, req in enumerate(live):
            req.note_token(tokens[i], now)
            if req.hit_stop():
                self.scheduler.finish(req)
        self.stats["decode_steps"] += 1
        self.stats["decode_seconds"] += now - t0

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 16, eos_id: Optional[int] = None,
                 arrival_times: Optional[Sequence[float]] = None
                 ) -> List[List[int]]:
        """Greedy-decode every prompt to completion; returns the generated
        ids per prompt (prompt excluded).  ``arrival_times``
        (perf_counter-relative) make a request invisible to admission
        before its arrival."""
        if not self._warmed:
            self.warmup()
        reqs = [self.submit(prompt, max_new_tokens, eos_id=eos_id,
                            arrival_time=None if arrival_times is None
                            else arrival_times[i])
                for i, prompt in enumerate(prompts)]
        # kept for callers that need per-request latency breakdowns
        self.last_requests = reqs
        while any(not r.done for r in reqs):
            if self.step() != "idle":
                continue
            kind, hint = self.scheduler.next_plan()
            if kind != "idle":
                continue             # work became runnable mid-wait
            if hint is None:
                raise RuntimeError("serving loop stalled: no runnable work "
                                   "but requests remain")
            time.sleep(min(float(hint), 0.05))
        return [r.output_tokens for r in reqs]
