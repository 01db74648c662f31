"""The serving engine: prefill/decode steps over the paged KV cache, driven
by the continuous-batching scheduler (counterpart of
``paddle_tpu/serving/engine.py``).

Traffic is bucketed into exactly two step signatures, as in the
reference:

* **decode** — ``(max_batch, 1)`` tokens; short batches are padded with
  inert rows (seq_len 0, block table of page 0) whose writes land in the
  reserved padding page and whose outputs are discarded.
* **prefill** — ``(1, prefill_chunk)`` tokens: one request's next chunk,
  padded to the chunk budget.  Only the last REAL token's hidden state
  reaches the lm_head.

Each signature owns static input tensors on the engine's device: ids,
positions, block table, seq_lens, slot pages and offsets, ``last_idx``
and, with the prefix cache on, a fixed-width ``(src, dst)`` page-copy
list of width ``max_batch`` padded with ``(0, 0)`` (page 0 onto itself).
The copy-on-write copies run inside the step, before its KV writes.  On
the card each signature is captured once into a CUDA graph (``warmup``,
or the signature's first step) and every step replays it: the host fills
pinned staging buffers, copies them into the static inputs and replays;
the logits come back from the graph's static output.  The two graphs
share one memory pool (they never run at once).  On the CPU a step runs
the same body eagerly on the static inputs.  A capture that fails
raises; there is no eager path on the card.

The KV pools are updated in place, which stands in for the reference's
donated jit buffers, and they keep their addresses for the engine's life
(``PagedKVCache.reset_pools`` zeroes them in place), since the graphs hold
them.  Decode attention runs the CUDA ragged-paged-attention kernel when
the engine is on the card (``FLAGS_serving_use_rpa_kernel``); prefill
always takes the plain gather path, as in the reference.  With
``FLAGS_serving_kv_quant=int8`` the pools hold int8 codes and every step
passes their scale pools along.  A model quantized by
``quantize_for_inference`` runs its Linears through the quantized matmul
kernel; the engine needs nothing else for it.

The reference's telemetry (gauges, spans, the health endpoint and its
exporter) and the request log are not ported yet (ROADMAP queue A5); the
health snapshot they serve is (``health_snapshot``).
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.place import resolve_device
from ..flags import get_flags
from ..jit import compile_cache as _cc
from ..jit.api import CapturedGraph
from ..nn.functional import linear
from ..utils import failpoint as _fp
from .attention import PagedCacheView, paged_kv_copy, use_rpa_kernel
from .control_plane import INTERACTIVE, InvalidRequestError
from .kv_cache import PagedKVCache
from .scheduler import (CANCELLED, RUNNING, ContinuousBatchingScheduler,
                        Request)

__all__ = ["ServingEngine"]

_I64, _I32 = torch.int64, torch.int32


class _Step:
    """One step signature: its static inputs on the engine's device, the
    host staging they are filled from, and, on the card, its graph."""

    def __init__(self, name: str, kernel: bool, shapes: Dict[str, tuple],
                 device: torch.device) -> None:
        self.name = name
        self.kernel = kernel
        cuda = device.type == "cuda"
        self.inputs = {k: torch.zeros(shape, dtype=dtype, device=device)
                       for k, (shape, dtype) in shapes.items()}
        # on the CPU the body reads the staging itself
        self.staging = ({k: torch.zeros_like(t, device="cpu")
                         .pin_memory() for k, t in self.inputs.items()}
                        if cuda else self.inputs)
        self.host = {k: t.numpy() for k, t in self.staging.items()}
        # recorded after each host-to-device copy: the staging is not
        # rewritten before the copy that reads it has run
        self.copied = torch.cuda.Event() if cuda else None
        self.rows = torch.arange(shapes["last_idx"][0][0], device=device)
        self.graph: Optional[CapturedGraph] = None
        self.built = False

    def fill(self) -> Dict[str, np.ndarray]:
        """The staging arrays, zeroed, once the last copy out of them ran."""
        if self.copied is not None:
            self.copied.synchronize()
        for a in self.host.values():
            a.fill(0)
        return self.host

    def upload(self) -> None:
        if self.copied is None:
            return
        for k, t in self.inputs.items():
            t.copy_(self.staging[k], non_blocking=True)
        self.copied.record()


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
                 use_kernel: Optional[bool] = None, device=None,
                 replica_id: Optional[str] = None) -> None:
        cfg = model.config
        self.device = resolve_device(device)
        model_device = next(iter(model.parameters())).device
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
        # prefix cache: the steps carry a fixed-width (src, dst) page-copy
        # list, the device half of copy-on-write.  Width max_batch:
        # admissions and decode reservations between two steps are bounded
        # by the active set, and each queues at most one copy.  With the
        # cache off the copy inputs are left out.
        self._with_copies = self.kv.prefix_enabled
        self._max_copies = self.max_batch
        self._scale = 1.0 / math.sqrt(cfg.head_dim)
        self.replica_id = replica_id
        b, c = self.max_batch, self.prefill_chunk
        p = self.kv.max_pages_per_seq
        model_name = type(model).__name__
        # decode runs the RPA kernel (when selected); prefill always the
        # gather path (the kernel is decode-shaped)
        self._decode = _Step(f"serving_decode[{model_name}]",
                             self._use_kernel,
                             self._shapes(b, 1, b, p), self.device)
        self._prefill = _Step(f"serving_prefill[{model_name}]", False,
                              self._shapes(1, c, c, p), self.device)
        self._pool = None
        self._warmed = False
        self._warmup_thread: Optional[threading.Thread] = None
        self._warmup_error: Optional[Exception] = None
        self._closed = False
        self._draining = False
        # decode-rate EWMA (tokens/s) behind projected_queue_delay_s
        self._tok_rate: Optional[float] = None
        self._last_error: Optional[str] = None
        self._last_step_at: Optional[float] = None
        self._retrace_base: Optional[int] = None
        # host wall time of the executed steps, each ending in the sync
        # that reads its sampled tokens back
        self.stats = {"prefill_steps": 0, "decode_steps": 0,
                      "prefill_seconds": 0.0, "decode_seconds": 0.0}
        self.last_logits: Optional[torch.Tensor] = None
        self.last_requests: List[Request] = []

    def _shapes(self, rows: int, cols: int, slots: int, pages: int):
        shapes = {"ids": ((rows, cols), _I64), "pos": ((rows, cols), _I64),
                  "bt": ((rows, pages), _I32), "sl": ((rows,), _I32),
                  "slot_pages": ((slots,), _I64),
                  "slot_offsets": ((slots,), _I64),
                  "last_idx": ((rows,), _I64)}
        if self._with_copies:
            shapes["copy_src"] = ((self._max_copies,), _I64)
            shapes["copy_dst"] = ((self._max_copies,), _I64)
        return shapes

    @contextmanager
    def _eval_mode(self):
        """Serve under eval without permanently flipping a model that is
        mid-training; every capture happens under eval."""
        was_training = bool(getattr(self.model, "training", False))
        if was_training:
            self.model.eval()
        try:
            yield
        finally:
            if was_training:
                self.model.train()

    # -- steps ------------------------------------------------------------
    def _forward(self, st: _Step) -> torch.Tensor:
        """The step body over ``st``'s static inputs: queued copy-on-write
        copies, this step's K/V writes, attention, and the vocab projection
        of the ``last_idx`` positions only.  Returns (B, vocab) logits."""
        model = self.model
        t = st.inputs
        with torch.no_grad():
            pools = self.kv.layer_pools()
            if self._with_copies:
                # a copied page takes its scales with it (int8 pool)
                for layer in pools:
                    for a, b in zip(layer[0::2], layer[1::2]):
                        paged_kv_copy(a, b, t["copy_src"], t["copy_dst"])
            views = [PagedCacheView(layer[0], layer[1], t["bt"], t["sl"],
                                    t["slot_pages"], t["slot_offsets"],
                                    t["pos"], self._scale, st.kernel,
                                    *layer[2:])
                     for layer in pools]
            hidden = model.llama(t["ids"], caches=views, positions=t["pos"])
            hb = hidden[st.rows, t["last_idx"]]             # (B, hidden)
            if model.config.tie_word_embeddings:
                return linear(hb, model.llama.embed_tokens.weight.t())
            return model.lm_head(hb)

    def _build(self, st: _Step) -> None:
        """Make ``st`` ready to run.  On the card: run its body once
        eagerly on zero inputs (every write lands in page 0, seq_len 0
        masks every read), which loads every kernel and module before the
        capture, then capture it.  Either way one trace of its name is
        noted."""
        if st.built:
            return
        _cc.note_trace("serving", st.name, list(st.inputs.values()))
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                for x in st.inputs.values():
                    x.zero_()
                self._forward(st)
                torch.cuda.synchronize()
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                st.graph = CapturedGraph(lambda: self._forward(st),
                                         self._pool)
        st.built = True

    def _stage_copies(self, host: Dict[str, np.ndarray]) -> None:
        """The queued copy-on-write copies into the fixed-width (src, dst)
        inputs; unused entries stay (0, 0)."""
        pend = self.kv.take_pending_copies()
        if len(pend) > self._max_copies:
            raise RuntimeError(
                f"{len(pend)} pending CoW copies exceed the step's fixed "
                f"width {self._max_copies} — scheduler/allocator invariant "
                f"broken")
        for i, (s, d) in enumerate(pend):
            host["copy_src"][i], host["copy_dst"][i] = s, d

    def _run(self, st: _Step) -> torch.Tensor:
        """Copy the staged inputs in and run the step: a replay on the card,
        the body on the CPU.  Returns the logits (a copy on the card: the
        graph's output is overwritten by the next replay)."""
        if self._with_copies:
            self._stage_copies(st.host)
        st.upload()
        if st.graph is not None:
            logits = st.graph.replay().clone()
        else:
            logits = self._forward(st)
        self.last_logits = logits
        return logits

    def _run_eagerly(self, kind: str) -> torch.Tensor:
        """The step body of ``kind`` ("decode" or "prefill") run once
        eagerly on the static inputs of its last step, for checking a
        replay against it.  The writes repeat the same slots (and the same
        page copies), so the pools end as the replay left them."""
        st = self._decode if kind == "decode" else self._prefill
        with self._eval_mode():
            return self._forward(st)

    def graphs(self) -> Dict[str, CapturedGraph]:
        """The captured graph of each step signature, by kind (none on the
        CPU)."""
        return {kind: st.graph for kind, st in (("decode", self._decode),
                                                ("prefill", self._prefill))
                if st.graph is not None}

    def warmup(self, block: bool = True):
        """Build both step signatures before traffic arrives: on the card,
        an eager run and a capture each.  With ``block=False`` this runs on
        a thread that the first ``step()`` joins (the warmup and every real
        step touch the same KV pools, so they never overlap); the caller
        may submit requests meanwhile.  The captures run in CUDA's global
        capture mode, so other CUDA work in the process meanwhile can make
        them fail (the joining step raises)."""
        def work():
            with self._eval_mode():
                self._build(self._decode)
                self._build(self._prefill)
            # the 0-recapture contract starts HERE: health_snapshot
            # reports recaptures after the post-warmup count
            self._retrace_base = _cc.retrace_count()

        def background():
            try:
                work()
            except Exception as exc:  # re-raised by the joining step
                self._warmup_error = exc

        if block:
            work()
            self._warmed = True
            return None
        self._warmed = True
        self._warmup_thread = threading.Thread(
            target=background, name="serving-warmup", daemon=True)
        self._warmup_thread.start()
        return [self._warmup_thread]

    def _join_warmup(self) -> None:
        if self._warmup_thread is not None:
            self._warmup_thread.join()
            self._warmup_thread = None
            if self._warmup_error is not None:
                exc, self._warmup_error = self._warmup_error, None
                self._warmed = False
                raise RuntimeError("the serving warmup failed") from exc

    # -- request intake ---------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               arrival_time: Optional[float] = None,
               priority: str = INTERACTIVE) -> Request:
        """Queue one request; impossible requests raise
        :class:`InvalidRequestError` at intake, and a draining or closed
        engine admits nothing."""
        if not prompt:
            raise InvalidRequestError("empty prompt")
        if self._draining or self._closed:
            who = f" {self.replica_id!r}" if self.replica_id else ""
            raise RuntimeError(
                f"serving engine{who} is "
                f"{'draining' if self._draining else 'closed'}: not "
                f"admitting new requests (route to another replica)")
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
        ("prefill" | "decode" | "idle").  A step that raises records the
        error (``health_snapshot``), folds every active request back to
        waiting (recompute on resume), zeroes the pools in place and
        re-raises."""
        self._join_warmup()
        kind, payload = self.scheduler.next_plan()
        try:
            if _fp.ACTIVE:
                # chaos: an engine death mid-traffic ("serving.step=error")
                # is raised on the host, before any replay, and reported
                # by health_snapshot
                _fp.inject("serving.step")
            with self._eval_mode():
                if kind == "prefill":
                    self._run_prefill(*payload)
                elif kind == "decode":
                    self._run_decode(payload)
        except Exception as exc:
            self._last_error = f"{type(exc).__name__}: {exc}"
            self._recover_pools()
            raise
        if kind != "idle":
            # a completed work step is proof of life
            self._last_error = None
        self._last_step_at = time.perf_counter()
        return kind

    def _recover_pools(self) -> None:
        """After a failed step: evict every active request
        (``reason="step_failure"``, recompute on resume) and zero the
        pools in place, dropping the prefix cache with their content."""
        while self.scheduler._evict_one(reason="step_failure"):
            pass
        self.kv.reset_pools()

    def projected_queue_delay_s(self) -> Optional[float]:
        """Tokens still owed to every queued and active request over the
        recent decode rate (an EWMA over decode steps); None before the
        first decode step."""
        rate = self._tok_rate
        if not rate or rate <= 0.0:
            return None
        pending = 0
        sched = self.scheduler
        for req in list(sched.waiting) + list(sched.active):
            pending += max(0, req.prompt_len - req.prefill_pos)
            pending += max(0, req.max_new_tokens - len(req.out_tokens))
        return pending / rate

    def health_snapshot(self) -> dict:
        """Admission signals and liveness, the reference's /healthz
        payload.  Unhealthy once close() ran, while draining, or when the
        last executed step raised (a later successful work step clears
        it).  ``retraces_after_warmup`` counts recaptures since warmup."""
        now = time.perf_counter()
        retraces = None if self._retrace_base is None \
            else _cc.retrace_count() - self._retrace_base
        proj = self.projected_queue_delay_s()
        return {
            "healthy": (not self._closed and not self._draining
                        and self._last_error is None),
            "closed": self._closed,
            "draining": self._draining,
            "replica_id": self.replica_id,
            "last_error": self._last_error,
            "kv_blocks_in_use": self.kv.blocks_in_use,
            "kv_blocks_total": self.kv.num_blocks - 1,
            "kv_block_size": self.kv.block_size,
            "kv_utilization": round(self.kv.utilization(), 4),
            "kv_fragmentation": round(self.kv.fragmentation(), 4),
            "kv_pool_bytes": self.kv.pool_bytes(),
            "queue_depth": len(self.scheduler.waiting),
            "active": len(self.scheduler.active),
            "waiting": len(self.scheduler.waiting),
            "max_batch": self.max_batch,
            "projected_queue_delay_s": None if proj is None
            else round(proj, 4),
            "retraces_after_warmup": retraces,
            "last_step_age_s": None if self._last_step_at is None
            else round(now - self._last_step_at, 4),
            "prefix_cache": self.kv.prefix_stats(),
        }

    def drain(self, timeout: Optional[float] = None) -> List[Request]:
        """Graceful retirement: stop admitting, run every ADMITTED request
        to completion, then :meth:`close`.

        Returns the never-admitted requests (the waiting queue), marked
        cancelled: they hold no KV pages and have produced no tokens, so
        their prompts can go to another engine intact.  ``timeout`` bounds
        the finish-in-flight phase; requests still running at expiry are
        preempted (recompute-on-resume state kept) and returned too."""
        if self._closed:
            return []
        self._draining = True
        self.scheduler.draining = True

        def hand_back_waiting(into: List[Request]) -> None:
            for req in list(self.scheduler.waiting):
                self.scheduler.waiting.remove(req)
                req.state = CANCELLED
                into.append(req)

        handed: List[Request] = []
        hand_back_waiting(handed)
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while self.scheduler.active:
            if deadline is not None and time.perf_counter() > deadline:
                while self.scheduler._evict_one(reason="drained"):
                    pass
                hand_back_waiting(handed)
                break
            self.step()
        self.close()
        return handed

    def close(self) -> None:
        """Retire the engine: join the warmup and report unhealthy.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._warmup_thread is not None:
            self._warmup_thread.join()
            self._warmup_thread = None

    def _run_prefill(self, req: Request, start: int, stop: int) -> None:
        t0 = time.perf_counter()
        st = self._prefill
        self._build(st)
        n = stop - start
        h = st.fill()
        h["ids"][0, :n] = req.prompt[start:stop]
        h["pos"][0, :n] = np.arange(start, stop)
        for i, ap in enumerate(range(start, stop)):
            # cached positions (a full prefix hit's one recompute token)
            # write to the page-0 sink: the cached K/V stays authoritative
            h["slot_pages"][i], h["slot_offsets"][i] = \
                self.kv.write_slot(req.rid, ap)
        h["bt"][0] = self.kv.padded_table(req.rid)
        h["sl"][0] = stop
        h["last_idx"][0] = n - 1
        logits = self._run(st)
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
        st = self._decode
        self._build(st)
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
        h = st.fill()
        for i, req in enumerate(live):
            new_len = self.kv.seq_len(req.rid)      # includes this token
            h["ids"][i, 0] = req.out_tokens[-1]
            h["pos"][i, 0] = new_len - 1
            h["bt"][i] = self.kv.padded_table(req.rid)
            h["sl"][i] = new_len
            h["slot_pages"][i], h["slot_offsets"][i] = self.kv.write_slot(
                req.rid, new_len - 1)
        logits = self._run(st)
        tokens = logits.argmax(dim=-1).tolist()
        now = time.perf_counter()
        for i, req in enumerate(live):
            req.note_token(tokens[i], now)
            if req.hit_stop():
                self.scheduler.finish(req)
        self.stats["decode_steps"] += 1
        self.stats["decode_seconds"] += now - t0
        # decode-rate EWMA: smooth enough to ride out one slow step
        inst = len(live) / max(now - t0, 1e-6)
        self._tok_rate = inst if self._tok_rate is None \
            else 0.8 * self._tok_rate + 0.2 * inst

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
