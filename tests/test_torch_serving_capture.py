"""The port's serving engine with its two step signatures (static inputs,
the fixed-width copy-on-write list inside the step, CUDA graphs on the
card) against the JAX package's engine: tokens, the recapture counters,
the health snapshot, drain, and recovery from a failed step.

On the CPU each step runs its body eagerly on the static inputs; the
card's replays are held to it in ``tests/test_torch_cuda_capture.py``.
The reference's Pallas decode kernel runs in interpret mode, set through
``monkeypatch`` only."""

import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import random_state
from paddle_tpu.jit import compile_cache as jcc
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import attention as jattn
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu.serving.kv_cache import PagedKVCache as JaxKV
from paddle_tpu.telemetry import exporter as jexp
from paddle_tpu.telemetry import flight_recorder as fr
from paddle_tpu.telemetry import metrics
from paddle_tpu.utils.monitor import stat_reset
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.jit import compile_cache as cc
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           load_reference_arrays)
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.kv_cache import PagedKVCache

FLAGS = {"serving_use_rpa_kernel": "auto", "serving_prefix_cache": "on",
         "serving_kv_quant": "off"}
KW = dict(block_size=4, num_blocks=64, max_batch=2, prefill_chunk=8,
          max_seq_len=32)
# admitted two at a time: the third and fourth prompts hit the first's
# cached blocks, the fourth forking inside a block (copy-on-write)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [7, 8, 9],
           [1, 2, 3, 4, 5, 6, 7, 8, 30, 31],
           [1, 2, 3, 4, 5, 6, 40, 41, 42, 43, 44]]


@pytest.fixture(autouse=True)
def _restore():
    """Neither package's flags, seed, counters or health source leak."""
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    random_state.seed(seed)
    random_state.set_rng_state(key)
    paddle.set_flags(FLAGS)
    tflags.set_flags(FLAGS)
    fr.configure(fr.DEFAULT_SIZE)
    metrics.default_registry().reset()
    stat_reset()
    cc.reset_trace_counts()
    jcc.reset_trace_counts()
    jexp.set_health_source(None)


def set_both(flags):
    paddle.set_flags(flags)
    tflags.set_flags(flags)


def model_pair(layers=2, max_pos=64):
    paddle.seed(1234)
    jmodel = jllama.LlamaForCausalLM(jllama.llama_tiny_config(
        num_hidden_layers=layers, max_position_embeddings=max_pos))
    jmodel.eval()
    port = LlamaForCausalLM(llama_tiny_config(
        num_hidden_layers=layers, max_position_embeddings=max_pos),
        device="cpu")
    load_reference_arrays(port, {n: np.asarray(p.numpy())
                                 for n, p in jmodel.named_parameters()})
    return jmodel, port


def port_engine(port, **kw):
    return ServingEngine(port, use_kernel=True, device="cpu",
                         **{**KW, **kw})


def recorded_copies(eng):
    """Wrap the engine's copy staging: every (src, dst) pair a step
    carried, page-0 padding left out."""
    seen = []
    real = eng._stage_copies

    def stage(host):
        real(host)
        seen.extend((int(s), int(d)) for s, d in zip(host["copy_src"],
                                                     host["copy_dst"])
                    if (s, d) != (0, 0))
    eng._stage_copies = stage
    return seen


# ---------------------------------------------------------------------------
# tokens against the reference, with the fixed-width copy list
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix", ["on", "off"])
def test_generate_matches_reference_with_the_copy_list(prefix,
                                                       monkeypatch):
    """Tokens identical to the reference engine (its Pallas decode kernel
    in interpret mode).  With the prefix cache on, every copy-on-write
    rides a step's fixed-width (src, dst) list; off, the steps carry no
    copy inputs at all."""
    set_both({"serving_prefix_cache": prefix})
    jmodel, port = model_pair()
    monkeypatch.setattr(jattn, "_PALLAS_INTERPRET", True)
    paddle.set_flags({"serving_use_rpa_kernel": "on"})
    ref = JaxEngine(jmodel, **KW)
    assert ref._use_kernel
    want = ref.generate(PROMPTS, max_new_tokens=6)
    eng = port_engine(port)
    copies = recorded_copies(eng)
    got = eng.generate(PROMPTS, max_new_tokens=6)
    assert got == want and all(len(o) == 6 for o in got)
    if prefix == "on":
        assert set(eng._decode.inputs) >= {"copy_src", "copy_dst"}
        assert eng._decode.inputs["copy_src"].shape == (KW["max_batch"],)
        assert len(copies) == eng.kv.prefix_stats()["cow_copies_total"] >= 1
    else:
        assert "copy_src" not in eng._prefill.inputs and not copies


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_preemption_with_the_copy_list_matches_reference(kv_quant):
    """A pool too small for the working set: decode evicts and
    recomputes, with the prefix cache on and the bf16 or int8 pool."""
    set_both({"serving_kv_quant": kv_quant})
    jmodel, port = model_pair()
    kw = dict(block_size=4, num_blocks=9, max_batch=3, prefill_chunk=8,
              max_seq_len=16)
    prompts = [[1, 2, 3, 4, 5], [1, 2, 3, 4, 9, 10], [11, 12, 13, 14, 15]]
    want = JaxEngine(jmodel, use_kernel=False, **kw).generate(
        prompts, max_new_tokens=8)
    eng = ServingEngine(port, use_kernel=True, device="cpu", **kw)
    assert eng.kv.quantized == (kv_quant == "int8")
    got = eng.generate(prompts, max_new_tokens=8)
    assert got == want
    assert sum(r.preemptions for r in eng.last_requests) >= 1
    assert all(r.preempt_reason == "kv_pool_exhausted"
               for r in eng.last_requests if r.preemptions)
    assert eng.kv.blocks_in_use == 0


def test_int8_pool_with_prefix_hits_matches_reference():
    set_both({"serving_kv_quant": "int8"})
    jmodel, port = model_pair()
    want = JaxEngine(jmodel, use_kernel=False, **KW).generate(
        PROMPTS, max_new_tokens=6)
    eng = port_engine(port)
    copies = recorded_copies(eng)
    assert eng.kv.quantized
    assert eng.generate(PROMPTS, max_new_tokens=6) == want
    assert copies and eng.kv.prefix_stats()["hits"] >= 2


def test_copy_list_raises_past_its_width():
    """As the reference's ``_copy_arrays``: more queued copies than the
    step's fixed width is a broken invariant, not a silent drop."""
    _, port = model_pair(layers=1)
    eng = port_engine(port)
    eng.kv._pending_copies.extend([(1, 2), (3, 4), (5, 6)])
    with pytest.raises(RuntimeError, match="fixed width 2"):
        eng._stage_copies(eng._decode.fill())


# ---------------------------------------------------------------------------
# warmup, recaptures and the health snapshot
# ---------------------------------------------------------------------------

def test_zero_recaptures_over_50_mixed_length_requests():
    """As the reference's ``test_zero_retrace_over_50_mixed_length_
    requests``: warmup builds the two signatures once each, and 50 ragged
    requests add none."""
    _, port = model_pair()
    eng = ServingEngine(port, block_size=4, num_blocks=256, max_batch=4,
                        prefill_chunk=8, max_seq_len=48, device="cpu")
    assert eng.health_snapshot()["retraces_after_warmup"] is None
    eng.warmup()
    counts = cc.trace_counts()
    assert counts == {"serving_decode[LlamaForCausalLM]": 1,
                      "serving_prefill[LlamaForCausalLM]": 1}
    rng = np.random.RandomState(1)
    prompts = [list(map(int, rng.randint(1, 255, rng.randint(1, 20))))
               for _ in range(50)]
    outs = eng.generate(prompts, max_new_tokens=4)
    assert all(len(o) == 4 for o in outs)
    assert eng.health_snapshot()["retraces_after_warmup"] == 0
    assert cc.trace_counts() == counts
    assert eng.kv.blocks_in_use == 0
    assert eng.stats["decode_steps"] > 0 and eng.stats["prefill_steps"] >= 50


def test_warmup_on_a_thread_is_joined_by_the_first_step():
    jmodel, port = model_pair()
    eng = port_engine(port)
    threads = eng.warmup(block=False)
    assert len(threads) == 1
    eng.submit([1, 2, 3], 2)            # intake overlaps the warmup
    assert eng.step() == "prefill"
    assert not threads[0].is_alive() and eng._warmup_thread is None
    assert eng.health_snapshot()["retraces_after_warmup"] == 0


def test_a_failed_background_warmup_raises_at_the_first_step(monkeypatch):
    _, port = model_pair(layers=1)
    eng = port_engine(port)

    def failing(step):
        raise RuntimeError("capture refused")
    monkeypatch.setattr(eng, "_build", failing)
    eng.warmup(block=False)
    with pytest.raises(RuntimeError, match="serving warmup failed") as err:
        eng.step()
    assert "capture refused" in str(err.value.__cause__)
    assert not eng._warmed and eng._warmup_thread is None


def test_health_snapshot_has_the_reference_keys():
    """The same keys as the reference engine's snapshot, and the same
    allocator signals after the same traffic.  No key of the reference's
    snapshot is telemetry-only: the endpoint that serves it (queue A5)
    adds its own identity fields outside ``health_snapshot``."""
    jmodel, port = model_pair()
    ref = JaxEngine(jmodel, use_kernel=False, **KW)
    eng = port_engine(port)
    for e in (ref, eng):
        e.warmup()
        e.generate(PROMPTS[:2], max_new_tokens=4)
        e.submit(PROMPTS[2], 4)
        e.submit(PROMPTS[3], 4)
        while not any(r.out_tokens for r in e.scheduler.active):
            e.step()
    want, got = ref.health_snapshot(), eng.health_snapshot()
    assert set(got) == set(want)
    for key in ("healthy", "closed", "draining", "last_error",
                "kv_blocks_in_use", "kv_blocks_total", "kv_block_size",
                "kv_utilization", "kv_fragmentation", "kv_pool_bytes",
                "queue_depth", "active", "waiting", "max_batch",
                "retraces_after_warmup", "prefix_cache"):
        assert got[key] == want[key], key
    assert got["projected_queue_delay_s"] > 0
    assert got["last_step_age_s"] >= 0


def test_projected_queue_delay_waits_for_a_decode_rate():
    _, port = model_pair(layers=1)
    eng = port_engine(port)
    eng.submit([1, 2, 3], 6)
    assert eng.projected_queue_delay_s() is None
    while eng.stats["decode_steps"] == 0:
        eng.step()
    assert eng._tok_rate > 0
    # 1 request, 4 tokens still owed after its prefill token and one decode
    assert eng.projected_queue_delay_s() == pytest.approx(4 / eng._tok_rate)


def test_steps_run_in_eval_mode_and_restore_training():
    _, port = model_pair(layers=1)
    port.train()
    seen = []
    port.llama.register_forward_hook(
        lambda m, a, out: seen.append(m.training))
    eng = port_engine(port)
    eng.generate([[1, 2, 3]], max_new_tokens=2)
    assert seen and not any(seen)
    assert port.training


# ---------------------------------------------------------------------------
# drain, and recovery from a failed step
# ---------------------------------------------------------------------------

def drain_script(eng):
    """The reference test's drain: one request admitted and in flight, two
    that arrive 'later' stay waiting; drain hands those back."""
    eng.warmup()
    admitted = eng.submit([1, 2, 3], max_new_tokens=4)
    while admitted.state == "waiting":
        eng.step()
    far = time.perf_counter() + 3600.0
    waiting = [eng.submit([4, 5], max_new_tokens=4, arrival_time=far),
               eng.submit([6, 7], max_new_tokens=4, arrival_time=far)]
    handed = eng.drain()
    return admitted, waiting, handed


def test_drain_finishes_inflight_and_hands_back_waiting():
    """As the reference's ``test_engine_drain_finishes_inflight_and_hands_
    back_waiting``, and with the same tokens as the reference engine."""
    jmodel, port = model_pair()
    results = []
    for eng in (JaxEngine(jmodel, use_kernel=False, replica_id="a", **KW),
                ServingEngine(port, device="cpu", replica_id="a", **KW)):
        admitted, waiting, handed = drain_script(eng)
        assert admitted.done and len(admitted.output_tokens) == 4
        assert {r.rid for r in handed} == {r.rid for r in waiting}
        assert all(r.output_tokens == [] and r.state == "cancelled"
                   for r in handed)
        snap = eng.health_snapshot()
        assert snap["healthy"] is False
        assert snap["draining"] is True and snap["closed"] is True
        assert snap["replica_id"] == "a"
        with pytest.raises(RuntimeError, match="not admitting"):
            eng.submit([1], max_new_tokens=1)
        assert eng.kv.blocks_in_use == 0
        assert eng.drain() == []
        results.append(admitted.output_tokens)
    assert results[0] == results[1]


def test_drain_past_its_deadline_hands_back_the_stragglers():
    _, port = model_pair()
    eng = port_engine(port)
    reqs = [eng.submit(p, max_new_tokens=8) for p in PROMPTS[:2]]
    while not all(r.out_tokens for r in reqs):
        eng.step()
    handed = eng.drain(timeout=0.0)
    assert {r.rid for r in handed} == {r.rid for r in reqs}
    assert all(r.preempt_reason == "drained" and r.folded_tokens
               for r in handed)
    assert eng.kv.blocks_in_use == 0 and not eng.scheduler.active


def pool_addresses(eng):
    return [t.data_ptr() for layer in eng.kv.layer_pools() for t in layer]


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_failed_step_recovers_the_pools_in_place(kv_quant, monkeypatch):
    """A step made to raise mid-traffic: the error is recorded, every
    active request folds back to waiting (``step_failure``), the pools are
    zeroed where they lie (their addresses are what a captured step
    holds), and the prefix cache is dropped.  The same requests then run
    to the tokens of a fresh engine, which equal the reference's, and so
    does the next ``generate``."""
    set_both({"serving_kv_quant": kv_quant})
    jmodel, port = model_pair()
    want = JaxEngine(jmodel, use_kernel=False, **KW).generate(
        PROMPTS, max_new_tokens=6)
    assert port_engine(port).generate(PROMPTS, max_new_tokens=6) == want
    eng = port_engine(port)
    eng.warmup()
    addresses = pool_addresses(eng)
    reqs = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
    while not any(len(r.out_tokens) >= 2 for r in reqs):
        eng.step()
    real = type(port.llama).forward
    calls = []

    def failing(self, *a, **k):
        if not calls:
            calls.append(1)
            raise RuntimeError("injected step failure")
        return real(self, *a, **k)

    monkeypatch.setattr(type(port.llama), "forward", failing)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    snap = eng.health_snapshot()
    assert snap["healthy"] is False
    assert snap["last_error"] == "RuntimeError: injected step failure"
    assert pool_addresses(eng) == addresses
    assert all(float(t.abs().sum()) == 0.0
               for layer in eng.kv.layer_pools() for t in layer)
    assert not eng.scheduler.active and eng.kv.blocks_in_use == 0
    assert eng.kv.prefix_stats()["cached_blocks"] == 0
    assert any(r.preempt_reason == "step_failure" for r in reqs)
    while any(not r.done for r in reqs):
        eng.step()
    assert [r.output_tokens for r in reqs] == want
    assert eng.health_snapshot()["last_error"] is None
    assert eng.generate(PROMPTS, max_new_tokens=6) == want
    assert eng.health_snapshot()["retraces_after_warmup"] == 0


# ---------------------------------------------------------------------------
# the allocator's new signals against the reference's
# ---------------------------------------------------------------------------

def test_utilization_fragmentation_and_reset_match_reference():
    """The same calls on both allocators: utilization and fragmentation
    agree at every step; ``reset_pools`` drops the cache as the
    reference's does (no stale hit afterwards), zeroing in place."""
    kw = dict(block_size=4, num_blocks=16, max_seq_len=32)
    ref = JaxKV(num_layers=1, num_kv_heads=2, head_dim=4, **kw)
    port = PagedKVCache(1, 2, 4, device="cpu", **kw)
    t = list(range(1, 13))
    d = t[:10] + [99, 98]
    for kv in (ref, port):
        assert kv.alloc(0, 12, tokens=t)
        kv.append(0, 12)
        assert kv.alloc(1, 12, tokens=d)          # queues a CoW copy
        kv.append(1, 3)
    assert port.utilization() == ref.utilization()
    assert port.fragmentation() == pytest.approx(ref.fragmentation())
    assert port.used_tokens() == ref.used_tokens()
    for kv in (ref, port):
        kv.free(0)
        kv.free(1)
    assert port.prefix_stats()["cached_blocks"] > 0
    addresses = [x.data_ptr() for x in port.layer_pools()[0]]
    port.layer_pools()[0][0].fill_(3.0)
    for kv in (ref, port):
        kv.reset_pools()
        assert kv.take_pending_copies() == []
    assert port.prefix_stats()["cached_blocks"] == 0
    assert port.free_blocks == ref.free_blocks == 15
    assert [x.data_ptr() for x in port.layer_pools()[0]] == addresses
    assert float(port.layer_pools()[0][0].abs().sum()) == 0.0
    for kv in (ref, port):
        assert kv.alloc(2, 12, tokens=t)
        assert kv.prefix_hit_tokens(2) == 0
    assert port.utilization() == ref.utilization()
    assert port.fragmentation() == pytest.approx(ref.fragmentation())
