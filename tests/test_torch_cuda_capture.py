"""The captured steps on the card: ``TrainStepCapture``'s CUDA graph
against the eager loop and the CPU, and the serving engine's replays
against the CPU engine.  This file imports neither jax nor paddle_tpu, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda_capture.py -q

Without a CUDA device every test here skips (decided in a fixture)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch.jit import CapturedGraph, TrainStepCapture
from paddle_tpu_torch.jit import compile_cache as cc
from paddle_tpu_torch.jit.api import replayed_launches
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.cuda import reset_launch_counts
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import LinearWarmup
from paddle_tpu_torch.serving.engine import ServingEngine

FLASH = ("flash_fwd", "flash_bwd_delta", "flash_dq", "flash_dkv")
# captured vs eager on the card: the same kernels in the same order; the
# update's learning rate and bias corrections are f32 tensors in one and
# f64 Python floats in the other (one f32 ulp apart); vs the CPU also the
# plain versions' summation order (about 3e-6 measured)
CAPTURE_RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs run only on the card)")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old
    cc.reset_trace_counts()
    flags.set_flags({"serving_kv_quant": "off",
                     "serving_prefix_cache": "on"})


def lm_loss(model, ids, labels):
    return model.compute_loss(model(ids), labels)


def tiny_pair(seed=0, **cfg):
    """The tiny f32 Llama (2 layers, GQA 4/2) on the card and on the CPU
    with the same weights."""
    config = llama_tiny_config(**cfg)
    card = LlamaForCausalLM(config, seed=seed)
    cpu = LlamaForCausalLM(config, device="cpu", seed=seed)
    cpu.load_state_dict(card.state_dict())
    return card, cpu


def train_batch(seq=128, seed=1):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(0, 256, (2, seq))),
            torch.from_numpy(rng.randint(0, 256, (2, seq))))


def optimizer_for(model):
    return AdamW(learning_rate=LinearWarmup(1e-3, warmup_steps=4,
                                            start_lr=1e-4, end_lr=1e-3),
                 parameters=model.parameters(), weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(1.0))


def rel(a, b):
    return ((a.detach().float().cpu() - b.detach().float().cpu()).norm()
            / b.detach().float().cpu().norm()).item()


@pytest.mark.gpu
def test_captured_train_step_matches_eager_and_launches_per_replay(
        cuda_device):
    """5 steps with a changing learning rate: the graph's losses and
    parameters within 1e-5 of the eager loop's on the card; its replays
    launch each flash kernel once a layer and the fused update once, and
    nothing recaptures."""
    card, twin = tiny_pair()
    twin = twin.to(cuda_device)
    ids, labels = (x.to(cuda_device) for x in train_batch())
    opt, eager = optimizer_for(card), optimizer_for(twin)
    reset_launch_counts()
    step = TrainStepCapture(card, opt, lm_loss)
    got, want = [], []
    for _ in range(5):
        got.append(step(ids, labels))
        loss = lm_loss(twin, ids, labels)
        loss.backward()
        eager.step()
        eager.clear_grad()
        want.append(loss.item())
        for o in (opt, eager):
            o._learning_rate.step()
    got = [x.item() for x in got]
    assert len(set(got)) == 5, got            # held losses keep their own
    np.testing.assert_allclose(got, want, rtol=CAPTURE_RTOL)
    assert got[-1] < got[0]
    params = dict(twin.named_parameters())
    for n, p in card.named_parameters():
        assert rel(p, params[n]) <= CAPTURE_RTOL, n
    assert all(p.grad is None for p in card.parameters())
    assert opt._global_step == 5
    (graph,) = step.graphs()
    layers = card.config.num_hidden_layers
    # one fused update a replay: every parameter is f32, one dtype group
    assert graph.launches == {**{n: layers for n in FLASH},
                              "fused_update": 1}
    assert graph.replays == 5
    assert replayed_launches(step.graphs()) == {
        **{n: 5 * layers for n in FLASH}, "fused_update": 5}
    assert cc.retrace_count() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("clip", ["value", "norm", "global_norm"])
def test_each_clip_captures(cuda_device, clip):
    """The three clips compute on the device with no host sync, so each
    captures: 2 replays equal the eager loop's steps within 1e-5."""
    from paddle_tpu_torch.nn import ClipGradByNorm, ClipGradByValue
    make = {"value": lambda: ClipGradByValue(1e-3),
            "norm": lambda: ClipGradByNorm(1e-2),
            "global_norm": lambda: ClipGradByGlobalNorm(1e-2)}[clip]
    card, twin = tiny_pair()
    twin = twin.to(cuda_device)
    ids, labels = (x.to(cuda_device) for x in train_batch())
    opts = [AdamW(learning_rate=1e-3, parameters=m.parameters(),
                  grad_clip=make()) for m in (card, twin)]
    step = TrainStepCapture(card, opts[0], lm_loss)
    for _ in range(2):
        got = step(ids, labels).item()
        loss = lm_loss(twin, ids, labels)
        loss.backward()
        opts[1].step()
        opts[1].clear_grad()
        assert abs(got - loss.item()) <= CAPTURE_RTOL * abs(loss.item())
    params = dict(twin.named_parameters())
    for n, p in card.named_parameters():
        assert rel(p, params[n]) <= CAPTURE_RTOL, n
    assert step.graphs()[0].replays == 2


@pytest.mark.gpu
def test_scaler_steps_run_without_a_host_sync(cuda_device):
    """O2 float16 with dynamic loss scaling on the card: step 1 overflows
    at 2^40 and leaves every parameter, moment and the step counter
    bitwise; steps 2-4 (scale, backward, unscale_, step, update) run under
    torch.cuda.set_sync_debug_mode("error"), their losses finite and
    falling; f32 moments (the (float16, float32) group)."""
    from paddle_tpu_torch import amp
    card, _ = tiny_pair()
    amp.decorate(card, level="O2", dtype="float16")
    opt = AdamW(learning_rate=1e-3, parameters=card.parameters(),
                weight_decay=0.01, multi_precision=True)
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 40,
                            decr_ratio=2.0 ** -30)
    ids, labels = (x.to(cuda_device) for x in train_batch())

    def step():
        loss = lm_loss(card, ids, labels)
        scaler.scale(loss).backward()
        scaler.unscale_(opt)
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss.detach()

    before = [p.detach().clone() for p in card.parameters()]
    step()
    assert scaler._found_inf and int(opt._global_step) == 0
    for p, old in zip(card.parameters(), before):
        assert torch.equal(p, old)
    assert scaler.get_init_loss_scaling() == 2.0 ** 10
    losses = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            losses.append(step())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    losses = [x.item() for x in losses]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert int(opt._global_step) == 3 and not scaler._found_inf
    assert all(m.dtype == torch.float32
               for m in opt._accumulators["moment1"].values())


@pytest.mark.gpu
def test_captured_train_step_passes_no_overflow_flag(cuda_device,
                                                     monkeypatch):
    """TrainStepCapture's update takes no flag (the reference captures no
    scaler), so its replay launches the kernels it launched before the
    flag existed."""
    from paddle_tpu_torch.ops.cuda import fused_update as fu
    seen = []
    real = fu.fused_update

    def spy(*args, **kwargs):
        seen.append(kwargs.get("skip"))
        return real(*args, **kwargs)

    monkeypatch.setattr(fu, "fused_update", spy)
    card, _ = tiny_pair()
    ids, labels = (x.to(cuda_device) for x in train_batch())
    step = TrainStepCapture(card, optimizer_for(card), lm_loss)
    step(ids, labels)
    assert seen and all(s is None for s in seen)


@pytest.mark.gpu
def test_captured_train_step_warmup_moves_no_state(cuda_device):
    card, _ = tiny_pair()
    opt = optimizer_for(card)
    step = TrainStepCapture(card, opt, lm_loss)
    before = {n: p.detach().clone() for n, p in card.named_parameters()}
    step.warmup([((2, 128), "int64"), ((2, 128), "int64")])
    torch.cuda.synchronize()
    for n, p in card.named_parameters():
        assert torch.equal(p, before[n]), n
    for name in opt._STATE_NAMES:
        for p in card.parameters():
            assert not opt._get_state(name, p).any()
    assert opt._global_step == 0 and len(step.graphs()) == 1
    step(*train_batch())                      # CPU batches are copied in
    assert cc.trace_counts() == {"train_step[LlamaForCausalLM]": 1}


@pytest.mark.gpu
def test_captured_train_step_matches_the_cpu(cuda_device):
    """The card's graph against the CPU's eager body (the kernels' plain
    versions) over 3 steps, within 1e-5: f32 on both sides, sums in other
    orders (chip_smoke's eager card-vs-CPU parity reads about 3e-6)."""
    card, cpu = tiny_pair()
    ids, labels = train_batch()
    steps = [TrainStepCapture(m, optimizer_for(m), lm_loss)
             for m in (card, cpu)]
    losses = [[s(ids, labels).item() for _ in range(3)] for s in steps]
    np.testing.assert_allclose(losses[0], losses[1], rtol=CAPTURE_RTOL)
    params = dict(cpu.named_parameters())
    for n, p in card.named_parameters():
        assert rel(p, params[n]) <= CAPTURE_RTOL, n


@pytest.mark.gpu
def test_a_capture_refuses_a_host_sync(cuda_device):
    """No fallback: a body that reads a value back fails its capture."""
    x = torch.ones(4, device=cuda_device)
    with pytest.raises(RuntimeError):
        CapturedGraph(lambda: torch.tensor(x.sum().item()),
                      torch.cuda.graph_pool_handle())


SERVE_KW = dict(block_size=4, num_blocks=64, max_batch=3, prefill_chunk=8,
                max_seq_len=40)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [7, 8, 9], list(range(11, 30)),
           [1, 2, 3, 4, 5, 6, 7, 8, 30, 31],
           [1, 2, 3, 4, 5, 6, 40, 41, 42, 43, 44]]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant,prefix,blocks", [
    ("off", "on", 64), ("off", "off", 64), ("int8", "on", 64),
    ("off", "on", 12)], ids=["bf16_pool", "no_prefix_cache", "int8_pool",
                             "preemption"])
def test_captured_engine_tokens_equal_the_cpu_engine(cuda_device, kv_quant,
                                                     prefix, blocks):
    """Every step a replay of one of the two graphs: tokens equal the CPU
    engine's; each decode replay launches the decode kernel once a layer;
    nothing recaptures after warmup."""
    flags.set_flags({"serving_kv_quant": kv_quant,
                     "serving_prefix_cache": prefix})
    card, cpu = tiny_pair(max_position_embeddings=64)
    kw = dict(SERVE_KW, num_blocks=blocks)
    want = ServingEngine(cpu, device="cpu", **kw).generate(
        PROMPTS, max_new_tokens=6)
    eng = ServingEngine(card, **kw)
    assert eng._use_kernel
    eng.warmup()
    got = eng.generate(PROMPTS, max_new_tokens=6)
    assert got == want
    graphs = eng.graphs()
    rpa = "rpa_decode_quant" if kv_quant == "int8" else "rpa_decode"
    assert graphs["decode"].launches == {rpa: card.config.num_hidden_layers}
    assert graphs["prefill"].launches == {}
    assert graphs["decode"].replays == eng.stats["decode_steps"]
    assert graphs["prefill"].replays == eng.stats["prefill_steps"]
    assert eng.health_snapshot()["retraces_after_warmup"] == 0
    if blocks == 12:
        assert sum(r.preemptions for r in eng.last_requests) >= 1


@pytest.mark.gpu
def test_replay_equals_the_eager_body_on_its_inputs(cuda_device):
    card, _ = tiny_pair(max_position_embeddings=64)
    eng = ServingEngine(card, **SERVE_KW)
    eng.warmup()
    for p in PROMPTS[:3]:
        eng.submit(p, 4)
    while eng.stats["decode_steps"] == 0:
        eng.step()
    replayed = eng.last_logits.clone()
    eager = eng._run_eagerly("decode")
    assert torch.equal(replayed, eager)


@pytest.mark.gpu
def test_captured_engine_warmup_on_a_thread(cuda_device):
    card, cpu = tiny_pair(max_position_embeddings=64)
    want = ServingEngine(cpu, device="cpu", **SERVE_KW).generate(
        PROMPTS, max_new_tokens=5)
    eng = ServingEngine(card, **SERVE_KW)
    eng.warmup(block=False)
    assert eng.generate(PROMPTS, max_new_tokens=5) == want
    assert eng.health_snapshot()["retraces_after_warmup"] == 0


@pytest.mark.gpu
def test_captured_engine_recovers_a_failed_step_in_place(cuda_device,
                                                         monkeypatch):
    card, cpu = tiny_pair(max_position_embeddings=64)
    want = ServingEngine(cpu, device="cpu", **SERVE_KW).generate(
        PROMPTS, max_new_tokens=5)
    eng = ServingEngine(card, **SERVE_KW)
    eng.warmup()
    before = [t.data_ptr() for layer in eng.kv.layer_pools() for t in layer]
    reqs = [eng.submit(p, 5) for p in PROMPTS]
    while not any(r.out_tokens for r in reqs):
        eng.step()
    real = eng._stage_copies

    def failing(host):
        monkeypatch.setattr(eng, "_stage_copies", real)
        raise RuntimeError("injected step failure")
    monkeypatch.setattr(eng, "_stage_copies", failing)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    assert eng.health_snapshot()["healthy"] is False
    assert [t.data_ptr() for layer in eng.kv.layer_pools()
            for t in layer] == before
    while any(not r.done for r in reqs):
        eng.step()
    assert [r.output_tokens for r in reqs] == want
    assert eng.generate(PROMPTS, max_new_tokens=5) == want


@pytest.mark.gpu
def test_profiler_sees_the_kernels_of_a_replay(cuda_device):
    """The wrapper counts run at the capture only; the profiler shows
    that each replay launches the recorded kernels: the decode kernel once
    a layer a decode replay."""
    import re

    from torch.profiler import ProfilerActivity, profile
    card, _ = tiny_pair(max_position_embeddings=64)
    eng = ServingEngine(card, **SERVE_KW)
    eng.warmup()
    reqs = [eng.submit(p, 8) for p in PROMPTS[:3]]
    while any(r.state != "running" for r in reqs):
        eng.step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            assert eng.step() == "decode"
        torch.cuda.synchronize()
    count = sum(e.count for e in prof.key_averages()
                if re.search("rpa_decode_kernel", e.key))
    assert count == 3 * card.config.num_hidden_layers
