"""The port's serving path (paddle_tpu_torch/serving) against the JAX
package's: the paged KV allocator with its prefix cache driven by the same
calls, and ``generate()`` on the tiny Llama with the same weights — token
for token, with the prefix cache on and off and under forced preemption.
The JAX engine runs its Pallas RPA kernel in interpret mode."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import random_state
from paddle_tpu.jit import compile_cache as cc
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import attention as jattn
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu.serving.kv_cache import PagedKVCache as JaxKV
from paddle_tpu.serving.kv_cache import block_chain as jax_block_chain
from paddle_tpu.telemetry import flight_recorder as fr
from paddle_tpu.telemetry import metrics
from paddle_tpu.utils.monitor import stat_reset
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           load_reference_arrays)
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.kv_cache import PagedKVCache, block_chain


@pytest.fixture(autouse=True)
def _restore_flags():
    """Neither package's flags, seed or serving globals may leak out of a
    test (later files in the same worker read the reference's seed)."""
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    random_state.seed(seed)
    random_state.set_rng_state(key)
    paddle.set_flags({"serving_use_rpa_kernel": "auto",
                      "serving_prefix_cache": "on"})
    jattn._PALLAS_INTERPRET = False
    tflags.set_flags({"serving_use_rpa_kernel": "auto",
                      "serving_prefix_cache": "on"})
    fr.configure(fr.DEFAULT_SIZE)
    metrics.default_registry().reset()
    stat_reset()
    cc.reset_trace_counts()


def set_prefix_cache(mode):
    paddle.set_flags({"serving_prefix_cache": mode})
    tflags.set_flags({"serving_prefix_cache": mode})


# ---------------------------------------------------------------------------
# allocator parity
# ---------------------------------------------------------------------------

def kv_state(kv):
    return {"tables": {r: list(t) for r, t in kv._tables.items()},
            "lens": dict(kv._lens), "refcnt": dict(kv._refcnt),
            "lru": list(kv._lru), "free": list(kv._free),
            "pending": list(kv._pending_copies),
            "stats": kv.prefix_stats(), "free_blocks": kv.free_blocks}


def kv_script():
    a = list(range(1, 11))                       # 10 prompt tokens
    return [
        ("alloc", 0, 10, a), ("append", 0, 10, None, False),
        # three decode reservations (tokens 91, 92, 93): block 2 fills
        ("append", 0, 1, 91, True), ("append", 0, 1, 92, True),
        ("append", 0, 1, 93, True),
        # two cached full blocks, then a miss
        ("alloc", 1, 9, a[:8] + [50]), ("append", 1, 1, None, False),
        # full blocks + a cached tail covering the rest: shared tail
        ("alloc", 2, 11, a + [91]), ("write_slot", 2, 10),
        ("append", 2, 1, None, False),
        # first decode write into the shared tail block: copy-on-write
        ("append", 2, 1, 77, True), ("take",),
        # a mid-block fork: copy-on-write at admission
        ("alloc", 3, 7, a[:4] + [5, 6, 99]), ("take",),
        ("write_slot", 3, 6), ("append", 3, 1, None, False),
        ("free", 0), ("free", 1),
        # a big request drains the freelist and evicts cached pages
        ("alloc", 4, 20, list(range(200, 220))),
        ("alloc", 5, 30, list(range(300, 330))),
        ("free", 2), ("free", 3),
        ("alloc", 5, 30, list(range(300, 330))),
        ("append", 5, 30, None, False), ("free", 5), ("free", 4),
        ("alloc", 6, 12, a[:8] + [1, 2, 3, 4]),
    ]


def run_op(kv, op):
    name, *args = op
    if name == "alloc":
        rid, n, toks = args
        return kv.alloc(rid, n, tokens=toks)
    if name == "append":
        rid, n, tok, deferred = args
        return kv.append(rid, n, token=tok, deferred_write=deferred)
    if name == "write_slot":
        return kv.write_slot(*args)
    if name == "take":
        return kv.take_pending_copies()
    if name == "free":
        return kv.free(*args)
    raise AssertionError(name)


@pytest.mark.parametrize("prefix", ["on", "off"])
def test_allocator_matches_reference_call_for_call(prefix):
    set_prefix_cache(prefix)
    kw = dict(block_size=4, num_blocks=14, max_seq_len=32)
    ref = JaxKV(num_layers=1, num_kv_heads=2, head_dim=4, **kw)
    port = PagedKVCache(1, 2, 4, device="cpu", **kw)
    assert port.prefix_enabled == ref.prefix_enabled == (prefix == "on")
    for op in kv_script():
        assert run_op(port, op) == run_op(ref, op), op
        assert kv_state(port) == kv_state(ref), op
        for rid in ref._tables:
            assert port.padded_table(rid) == ref.padded_table(rid)
    if prefix == "on":
        stats = port.prefix_stats()
        assert stats["hits"] >= 3 and stats["cow_copies_total"] >= 2
        assert stats["evictions_total"] >= 1


def test_block_hashes_are_identical_across_packages():
    toks = list(range(1000, 1037))
    assert block_chain(toks, 8) == jax_block_chain(toks, 8)
    assert len(block_chain(toks, 8)) == 4


# ---------------------------------------------------------------------------
# generate(): token-identical to the reference engine
# ---------------------------------------------------------------------------

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


def reference_engine(jmodel, **kw):
    """The JAX engine with its RPA kernel forced on, in interpret mode."""
    jattn._PALLAS_INTERPRET = True
    paddle.set_flags({"serving_use_rpa_kernel": "on"})
    eng = JaxEngine(jmodel, **kw)
    assert eng._use_kernel
    return eng


# admitted two at a time, so the third and fourth prompts arrive after the
# first has prefilled: they hit its cached blocks (the fourth forks inside
# a block: copy-on-write)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [7, 8, 9],
           [1, 2, 3, 4, 5, 6, 7, 8, 30, 31],
           [1, 2, 3, 4, 5, 6, 40, 41, 42, 43, 44]]


@pytest.mark.parametrize("prefix", ["on", "off"])
def test_generate_is_token_identical_to_reference(prefix):
    set_prefix_cache(prefix)
    jmodel, port = model_pair()
    kw = dict(block_size=4, num_blocks=64, max_batch=2, prefill_chunk=8,
              max_seq_len=32)
    want = reference_engine(jmodel, **kw).generate(PROMPTS, max_new_tokens=6)
    eng = ServingEngine(port, use_kernel=True, device="cpu", **kw)
    got = eng.generate(PROMPTS, max_new_tokens=6)
    assert got == want
    assert all(len(o) == 6 for o in got)
    if prefix == "on":
        assert eng.kv.prefix_stats()["hits"] >= 2
        assert eng.kv.prefix_stats()["cow_copies_total"] >= 1
    else:
        assert eng.kv.prefix_stats()["hits"] == 0


def test_generate_under_forced_preemption_is_token_identical():
    """8 usable pages of 4 tokens; three requests each peak at 3 pages, so
    decode must evict and recompute — with the same outputs."""
    jmodel, port = model_pair()
    kw = dict(block_size=4, num_blocks=9, max_batch=3, prefill_chunk=8,
              max_seq_len=16)
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10], [11, 12, 13, 14, 15]]
    want = reference_engine(jmodel, **kw).generate(prompts, max_new_tokens=8)
    eng = ServingEngine(port, use_kernel=True, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=8)
    assert got == want
    assert sum(r.preemptions for r in eng.last_requests) >= 1
    assert eng.kv.blocks_in_use == 0


def ref_greedy(model, prompt, n):
    ids, out = list(prompt), []
    for _ in range(n):
        with torch.no_grad():
            tok = int(model(torch.tensor([ids]))[0, -1].argmax())
        out.append(tok)
        ids.append(tok)
    return out


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["decode_wrapper", "gather_path"])
def test_generate_matches_full_recompute_greedy(use_kernel):
    port = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=2,
                                              max_position_embeddings=64),
                            device="cpu", seed=5)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(11, 30))]
    got = port.generate(prompts, max_new_tokens=6, block_size=4,
                        num_blocks=64, max_batch=3, prefill_chunk=8,
                        max_seq_len=40, use_kernel=use_kernel, device="cpu")
    assert got == [ref_greedy(port, p, 6) for p in prompts]
    eng = port._serving_engine
    assert eng._use_kernel is use_kernel
    assert eng.stats["decode_steps"] > 0 and eng.kv.blocks_in_use == 0
    # the cached engine is reused; a single prompt returns one list
    assert port.generate([1, 2, 3, 4, 5], max_new_tokens=6) == got[0]
    with pytest.raises(ValueError, match="already built"):
        port.generate([1, 2], block_size=8)


def test_engine_intake_and_cancel():
    port = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=1,
                                              max_position_embeddings=64),
                            device="cpu")
    eng = ServingEngine(port, block_size=4, num_blocks=8, max_batch=2,
                        prefill_chunk=8, max_seq_len=16, device="cpu")
    from paddle_tpu_torch.serving.control_plane import InvalidRequestError
    with pytest.raises(InvalidRequestError):
        eng.submit([])
    with pytest.raises(InvalidRequestError, match="tops out"):
        eng.submit(list(range(1, 15)), max_new_tokens=4)
    req = eng.submit([1, 2, 3], max_new_tokens=4)
    assert eng.step() == "prefill"
    assert eng.kv.blocks_in_use == 1
    assert eng.cancel(req.rid) and req.done
    assert eng.kv.blocks_in_use == 0 and eng.step() == "idle"


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    port = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=1),
                            device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(port)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.generate([1, 2, 3], max_new_tokens=2)
    with pytest.raises(ValueError, match="unsupported device"):
        ServingEngine(port, device="meta")


def test_arrival_times_gate_admission():
    """Later arrivals join mid-generation and still match the full
    recompute greedy."""
    import time
    port = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=2,
                                              max_position_embeddings=64),
                            device="cpu", seed=2)
    eng = ServingEngine(port, block_size=4, num_blocks=64, max_batch=4,
                        prefill_chunk=8, max_seq_len=40, device="cpu")
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [4, 3, 2, 1]]
    now = time.perf_counter()
    got = eng.generate(prompts, max_new_tokens=4,
                       arrival_times=[now, now + 0.05, now + 0.1])
    assert got == [ref_greedy(port, p, 4) for p in prompts]
    admitted = [r.admitted_at for r in eng.last_requests]
    assert admitted[1] >= now + 0.05 and admitted[2] >= now + 0.1


def test_flag_defaults_match_reference():
    from paddle_tpu.flags import flag_info as jax_flag_info
    for name in ("serving_block_size", "serving_num_blocks",
                 "serving_max_batch", "serving_prefill_chunk",
                 "serving_prefix_cache", "serving_use_rpa_kernel",
                 "serving_kv_quant", "weight_quant_group",
                 "weight_quant_kernel"):
        assert tflags.flag_info(name)["default"] == \
            jax_flag_info(name).default, name
        assert tflags.flag_info(name)["doc"], name
