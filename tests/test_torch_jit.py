"""The port's captured train step (paddle_tpu_torch.jit) against the JAX
package's ``TrainStepCapture`` on the same weights and batches, and the
recapture bookkeeping against ``paddle_tpu/jit/compile_cache.py``.

On the CPU the port's step runs its body eagerly each call (nothing to
capture); the card's captured step is held to it in
``tests/test_torch_cuda_capture.py``.  At seq 64 the reference's attention
takes its plain ``sdpa``."""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import random_state
from paddle_tpu.jit import TrainStepCapture as JaxStep
from paddle_tpu.jit import compile_cache as jcc
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStepCapture
from paddle_tpu_torch.jit import compile_cache as cc
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           load_reference_arrays)

NAME = "train_step[LlamaForCausalLM]"


@pytest.fixture(autouse=True)
def _restore_state():
    """Neither package's seed nor the recapture counters may leak."""
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    random_state.seed(seed)
    random_state.set_rng_state(key)
    cc.reset_trace_counts()
    jcc.reset_trace_counts()
    tflags.set_flags({"retrace_warn_threshold": 8})


def models(layers=2, max_pos=64, seed=7, dtype="float32"):
    """The reference tiny Llama (GQA 4/2) and the port's with its weights."""
    paddle.seed(seed)
    cfg = dict(num_hidden_layers=layers, max_position_embeddings=max_pos,
               dtype=dtype)
    jmodel = jllama.LlamaForCausalLM(jllama.llama_tiny_config(**cfg))
    port = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu")
    load_reference_arrays(port, {
        n: np.asarray(p.numpy()).astype(np.float32)
        for n, p in jmodel.named_parameters()})
    return jmodel, port


def batch(seq=64, batch_size=2, seed=5):
    r = np.random.RandomState(seed)
    return (r.randint(0, 256, (batch_size, seq)),
            r.randint(0, 256, (batch_size, seq)))


def lm_loss(model, ids, labels):
    return model.compute_loss(model(ids), labels)


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def params_of(model):
    return {n: p.detach().float().numpy().copy()
            for n, p in model.named_parameters()}


def ref_params_of(jmodel):
    return {n: np.asarray(p.numpy()).astype(np.float32)
            for n, p in jmodel.named_parameters()}


def adamw_pair(jmodel, port, lr=1e-3, clip=True, sched=False):
    """AdamW(weight_decay=0.01) in both packages, with the global-norm clip
    and a LinearWarmup learning rate when asked."""
    kw_j, kw_t = {}, {}
    if clip:
        kw_j["grad_clip"] = jclip.ClipGradByGlobalNorm(1.0)
        kw_t["grad_clip"] = tnn.ClipGradByGlobalNorm(1.0)
    lr_j = lr_t = lr
    if sched:
        lr_j = jopt.lr.LinearWarmup(lr, warmup_steps=3, start_lr=lr / 10,
                                    end_lr=lr)
        lr_t = topt.lr.LinearWarmup(lr, warmup_steps=3, start_lr=lr / 10,
                                    end_lr=lr)
    jo = jopt.AdamW(learning_rate=lr_j, parameters=jmodel.parameters(),
                    weight_decay=0.01, **kw_j)
    to = topt.AdamW(learning_rate=lr_t, parameters=port.parameters(),
                    weight_decay=0.01, **kw_t)
    return jo, to


# ---------------------------------------------------------------------------
# the step against the reference's
# ---------------------------------------------------------------------------

def test_train_step_capture_matches_reference():
    """4 steps with the global-norm clip, AdamW's decoupled decay and a
    LinearWarmup learning rate stepped between calls (so every step has
    another rate and bias correction): losses within 1e-5 relative, every
    parameter within 1e-5 relative L2 (f32 on both sides, sums in another
    order, as the eager loop's parity)."""
    jmodel, port = models()
    jo, to = adamw_pair(jmodel, port, sched=True)
    jstep = JaxStep(jmodel, jo, lm_loss)
    tstep = TrainStepCapture(port, to, lm_loss)
    ids, labels = batch()
    jlosses, tlosses, lrs = [], [], []
    for _ in range(4):
        jlosses.append(float(jstep(paddle.to_tensor(ids),
                                   paddle.to_tensor(labels)).numpy()))
        tlosses.append(tstep(torch.from_numpy(ids),
                             torch.from_numpy(labels)).item())
        assert to.get_lr() == jo.get_lr()
        lrs.append(to.get_lr())
        jo._learning_rate.step()
        to._learning_rate.step()
    assert len(set(lrs)) == 4
    assert to._global_step == jo._global_step == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    want = ref_params_of(jmodel)
    for n, got in params_of(port).items():
        assert rel_l2(got, want[n]) <= 1e-5, n
    for acc in to._STATE_NAMES:
        for jp, tp in zip(jmodel.parameters(), port.parameters()):
            jm = np.asarray(jo._accumulators[acc][id(jp)])
            tm = to._accumulators[acc][id(tp)].numpy()
            assert rel_l2(tm, jm) <= 1e-5, acc


def test_train_step_matches_the_eager_loop():
    """The step body is the eager loop's: forward, compute_loss,
    backward, clip, AdamW.  Only the update's learning rate and bias
    corrections come as f32 tensors here and as Python floats (f64) there,
    one f32 ulp apart, which the parameters carry into later losses:
    within 1e-5, the eager loop's own bar against the reference."""
    _, port = models()
    _, twin = models()
    opt = topt.AdamW(learning_rate=1e-3, parameters=port.parameters(),
                     weight_decay=0.01,
                     grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    eager = topt.AdamW(learning_rate=1e-3, parameters=twin.parameters(),
                       weight_decay=0.01,
                       grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    step = TrainStepCapture(port, opt, lm_loss)
    ids, labels = (torch.from_numpy(a) for a in batch())
    for _ in range(3):
        got = step(ids, labels).item()
        loss = lm_loss(twin, ids, labels)
        loss.backward()
        eager.step()
        eager.clear_grad()
        assert abs(got - loss.item()) <= 1e-5 * abs(loss.item())
    want = params_of(twin)
    for n, got in params_of(port).items():
        assert rel_l2(got, want[n]) <= 1e-5, n


def test_after_a_call_grads_are_none_and_the_step_advanced():
    _, port = models()
    opt = topt.AdamW(learning_rate=1e-3, parameters=port.parameters())
    step = TrainStepCapture(port, opt, lm_loss)
    ids, labels = batch()
    # a leftover gradient does not leak into the step (the reference
    # computes its grads afresh)
    port.lm_head.weight.grad = torch.full_like(port.lm_head.weight, 1e3)
    loss = step(ids, labels)        # numpy arrays are taken too
    assert loss.shape == () and torch.isfinite(loss)
    assert all(p.grad is None for p in port.parameters())
    assert opt._global_step == 1
    step(ids, labels)
    assert opt._global_step == 2


def test_held_losses_keep_their_own_values():
    """A list of returned losses does not read the last step's value."""
    _, port = models()
    opt = topt.AdamW(learning_rate=1e-2, parameters=port.parameters())
    step = TrainStepCapture(port, opt, lm_loss)
    ids, labels = (torch.from_numpy(a) for a in batch())
    held, seen = [], []
    for _ in range(3):
        held.append(step(ids, labels))
        seen.append(held[-1].item())
    assert [x.item() for x in held] == seen
    assert len(set(seen)) == 3


def test_distributed_arguments_raise_naming_the_queue():
    _, port = models(layers=1)
    opt = topt.AdamW(parameters=port.parameters())
    for kw in ({"grad_reducer": object()}, {"partition_rules": "tp"},
               {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="queue A7"):
            TrainStepCapture(port, opt, lm_loss, **kw)


# ---------------------------------------------------------------------------
# warmup and the recapture counters (tests/test_compile_cache.py's)
# ---------------------------------------------------------------------------

def moments_of(opt, model):
    return {(n, i): opt._get_state(n, p).clone()
            for n in opt._STATE_NAMES
            for i, p in enumerate(model.parameters())}


@pytest.mark.parametrize("through", ["method", "jit.warmup"])
def test_warmup_then_first_step_captures_once_and_moves_nothing(through):
    """As the reference's ``test_train_step_warmup_compiles_before_first_
    step``: warmup builds the signature (one trace), the first real step
    adds none.  Parameters and moments are bitwise unchanged by the
    warmup, and the reference's counters read the same."""
    jmodel, port = models()
    jo, to = adamw_pair(jmodel, port)
    jstep = JaxStep(jmodel, jo, lm_loss)
    tstep = TrainStepCapture(port, to, lm_loss)
    spec = [((2, 64), "int64"), ((2, 64), "int64")]
    before_p = params_of(port)
    before_m = moments_of(to, port)
    if through == "method":
        tstep.warmup(spec)
    else:
        assert tjit.warmup(tstep, [spec]) is None
    paddle.jit.warmup(jstep, [spec])
    for n, v in params_of(port).items():
        assert np.array_equal(v, before_p[n]), n
    for k, v in moments_of(to, port).items():
        assert torch.equal(v, before_m[k]), k
    assert to._global_step == 0
    assert all(p.grad is None for p in port.parameters())
    assert cc.trace_counts() == {NAME: 1}
    assert jcc.trace_counts().get(NAME) == 1
    ids, labels = batch()
    loss = tstep(torch.from_numpy(ids), torch.from_numpy(labels))
    jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))
    assert torch.isfinite(loss)
    assert cc.trace_counts() == {NAME: 1} and cc.retrace_count() == 0
    assert jcc.trace_counts().get(NAME) == 1


def test_warmup_on_a_background_thread_joins():
    _, port = models(layers=1)
    step = TrainStepCapture(port, topt.SGD(parameters=port.parameters()),
                            lm_loss)
    t = tjit.warmup(step, [[((1, 16), "int64"), ((1, 16), "int64")]],
                    block=False)
    t.join(timeout=120)
    assert not t.is_alive()
    assert cc.trace_counts() == {NAME: 1}


def test_a_new_batch_signature_is_a_recapture():
    """As ``test_retrace_counter_increments_on_shape_change``: the first
    signature is free, a second one counts, a known one does not."""
    _, port = models(layers=1)
    step = TrainStepCapture(port, topt.SGD(parameters=port.parameters()),
                            lm_loss)
    a, b = batch(seq=16), batch(seq=24)
    step(*a)
    assert cc.trace_counts() == {NAME: 1} and cc.retrace_count() == 0
    step(*b)
    assert cc.trace_counts() == {NAME: 2}
    assert cc.retrace_count(NAME) == cc.retrace_count() == 1
    step(*a)
    step(*b)
    assert cc.retrace_count() == 1


def test_recapture_warning_trips_at_the_threshold():
    tflags.set_flags({"retrace_warn_threshold": 2})
    sig = [torch.zeros(2, 3)]
    cc.note_trace("train_step", "step[x]", sig)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cc.note_trace("train_step", "step[x]", [torch.zeros(4, 3)])
        cc.note_trace("train_step", "step[x]", [torch.zeros(5, 3)])
    msgs = [str(w.message) for w in caught]
    assert len(msgs) == 1 and "captured 2 times" in msgs[0]
    assert "float32[2,3] -> float32[4,3]" in msgs[0]
    # per-op recaptures never warn
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for n in range(3):
            cc.note_trace("op", "op[y]", [torch.zeros(n + 1)])
    assert not caught


def test_counted_notes_a_trace_per_call():
    f = cc.counted("serving", "body[z]", lambda x: x * 2)
    assert f(3) == 6 and f(4) == 8
    assert cc.trace_counts()["body[z]"] == 2
    assert cc.retrace_count("body[z]") == 1
    assert cc.retrace_count("missing") == 0
    cc.reset_trace_counts()
    assert cc.trace_counts() == {}


def test_pad_to_batch_matches_reference():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    y = np.asarray([1, 2])
    for b in ({"x": x, "y": y}, {"x": torch.from_numpy(x),
                                 "y": torch.from_numpy(y)}):
        padded, mask = cc.pad_to_batch(b, 5)
        jpadded, jmask = jcc.pad_to_batch({"x": x, "y": y}, 5)
        assert mask.tolist() == jmask.tolist() == [True, True, False,
                                                   False, False]
        for k in ("x", "y"):
            assert np.array_equal(np.asarray(padded[k]), jpadded[k])
        same, none_mask = cc.pad_to_batch(b, 2)
        assert none_mask is None and same is b


def test_as_struct_takes_the_reference_spec_forms():
    cases = [(((4, 6), "float32"), ((4, 6), torch.float32)),
             (((4,), "int64"), ((4,), torch.int64)),
             ((3, 2), ((3, 2), torch.float32)),
             (np.zeros((2, 2), np.int32), ((2, 2), torch.int32)),
             (torch.zeros(1, 5, dtype=torch.bfloat16),
              ((1, 5), torch.bfloat16))]
    for spec, (shape, dtype) in cases:
        got = cc.as_struct(spec)
        assert got.shape == shape and got.dtype == dtype
        if not isinstance(spec, torch.Tensor):
            want = jcc.as_struct(spec)
            assert tuple(want.shape) == shape
    with pytest.raises(TypeError):
        cc.as_struct("nope")


def test_warmup_of_a_module_restores_its_buffers():
    """A callable that is not a train step runs once per signature on
    zeros, in no_grad, and its module's buffers come back."""
    m = torch.nn.BatchNorm1d(3)
    seen = []
    m.register_forward_hook(lambda mod, a, out: seen.append(
        (cc.in_warmup(), torch.is_grad_enabled())))
    before = m.running_mean.clone()
    tjit.warmup(m, [[((4, 3), "float32")]])
    assert seen == [(True, False)] and not cc.in_warmup()
    assert torch.equal(m.running_mean, before)


# ---------------------------------------------------------------------------
# bf16 training against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_train_steps_track_reference(seed):
    """Tiny Llama in bf16, 3 AdamW steps through both packages' captured
    step on the same weights and batch.  Both round to bf16 after every
    matmul, norm and update, in other places (XLA fuses; the port rounds
    each op), so the two drift by bf16 roundings, not by an error of the
    algorithm.  Measured over seeds 0, 1, 2: losses at most 1.74e-4 apart
    (relative), parameters at most 2.35e-3 (relative L2): elements one
    bf16 rounding apart (2^-9 = 1.95e-3 is half an ulp).  Bounds: losses
    1e-3, parameters 2^-7 = 7.8e-3 (two bf16 ulps); an f32-sized error of
    the update or the loss (a wrong bias correction, a lost clip) moves
    both by far more."""
    jmodel, port = models(seed=seed, dtype="bfloat16")
    jo, to = adamw_pair(jmodel, port, clip=False)
    jstep = JaxStep(jmodel, jo, lm_loss)
    tstep = TrainStepCapture(port, to, lm_loss)
    ids, labels = batch(seed=seed + 10)
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(jstep(paddle.to_tensor(ids),
                              paddle.to_tensor(labels)).numpy()))
        tl.append(tstep(torch.from_numpy(ids),
                        torch.from_numpy(labels)).item())
    assert all(p.dtype == torch.bfloat16 for p in port.parameters())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(tl, jl))
    want = ref_params_of(jmodel)
    worst = max(rel_l2(got, want[n]) for n, got in params_of(port).items())
    print(f"bf16 seed {seed}: losses {loss_rel:.3e} apart, parameters "
          f"{worst:.3e} (relative L2)")
    assert loss_rel <= 1e-3, (tl, jl)
    assert tl[-1] < tl[0]
    assert worst <= 2.0 ** -7, worst
