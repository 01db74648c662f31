"""The port's optimizer surface against the JAX package's: set_lr,
set_lr_scheduler, minimize, clear_gradients, state_dict (the reference's
keys and values) and set_state_dict, and parameter groups.  f32; values
within 1e-5 relative (the same update in other summation orders)."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import random_state
from paddle_tpu.models import llama as jllama
from paddle_tpu.optimizer import lr as jlr
import paddle_tpu_torch as P
from paddle_tpu_torch.core import place
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           load_reference_arrays)
from paddle_tpu_torch.optimizer import lr as tlr


@pytest.fixture(autouse=True)
def _cpu_and_reference_rng():
    P.set_device("cpu")
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    place._current = None
    random_state.seed(seed)
    random_state.set_rng_state(key)


def models(seed=7):
    paddle.seed(seed)
    cfg = dict(num_hidden_layers=2, max_position_embeddings=64)
    jmodel = jllama.LlamaForCausalLM(jllama.llama_tiny_config(**cfg))
    port = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu")
    load_reference_arrays(port, {n: np.asarray(p.numpy())
                                 for n, p in jmodel.named_parameters()})
    return jmodel, port


def batch(seed=5):
    r = np.random.RandomState(seed)
    return r.randint(0, 256, (2, 32)), r.randint(0, 256, (2, 32))


def train(jmodel, port, jo, to, steps=3):
    ids, labels = batch()
    for _ in range(steps):
        jl = jmodel.compute_loss(jmodel(paddle.to_tensor(ids)),
                                 paddle.to_tensor(labels))
        jo.minimize(jl)
        jo.clear_gradients()
        tl = port.compute_loss(port(torch.from_numpy(ids)),
                               torch.from_numpy(labels))
        to.minimize(tl)
        to.clear_gradients()
        np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-5)


def assert_params_close(jmodel, port, rel=1e-5):
    want = {n: np.asarray(p.numpy()) for n, p in jmodel.named_parameters()}
    for n, p in port.named_parameters():
        got = p.detach().numpy()
        err = np.linalg.norm(got - want[n]) / np.linalg.norm(want[n])
        assert err <= rel, (n, err)


def test_state_dict_keys_and_values_match_reference():
    """After 3 AdamW steps through minimize/clear_gradients: the same
    keys (global_step, param_<i>_moment1/2, LR_Scheduler) and values."""
    jmodel, port = models()
    jsched = jlr.StepDecay(1e-3, step_size=2, gamma=0.5)
    tsched = tlr.StepDecay(1e-3, step_size=2, gamma=0.5)
    jo = jopt.AdamW(learning_rate=jsched, parameters=jmodel.parameters())
    to = topt.AdamW(learning_rate=tsched, parameters=port.parameters())
    train(jmodel, port, jo, to)
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert list(tsd) == list(jsd)
    assert tsd["global_step"] == jsd["global_step"] == 3
    assert tsd["LR_Scheduler"] == jsd["LR_Scheduler"]
    for k in jsd:
        if k.endswith(("_moment1", "_moment2")):
            want = np.asarray(jsd[k].numpy())
            err = np.linalg.norm(tsd[k].numpy() - want) / \
                np.linalg.norm(want)
            assert err <= 1e-5, (k, err)
    assert_params_close(jmodel, port)


def test_set_state_dict_resumes_bitwise(tmp_path):
    """A state_dict saved with paddle_tpu_torch.save and loaded into a
    fresh model and optimizer: the next step is bitwise the original's;
    existing moments are overwritten in place."""
    _, port = models()
    to = topt.AdamW(learning_rate=1e-3, parameters=port.parameters())
    ids, labels = (torch.from_numpy(a) for a in batch())
    for _ in range(2):
        port.compute_loss(port(ids), labels).backward()
        to.step()
        to.clear_grad()
    path = os.path.join(tmp_path, "ckpt.pdopt")
    P.save({"model": port.state_dict(), "opt": to.state_dict()}, path)
    _, fresh = models(seed=11)
    fo = topt.AdamW(learning_rate=1e-3, parameters=fresh.parameters())
    fresh.compute_loss(fresh(ids), labels).backward()
    fo.step()              # moments exist: set_state_dict writes in place
    fo.clear_grad()
    ptrs = [m.data_ptr() for m in fo._accumulators["moment1"].values()]
    ck = P.load(path, device="cpu")
    fresh.set_state_dict(ck["model"])
    fo.set_state_dict(ck["opt"])
    assert [m.data_ptr() for m in
            fo._accumulators["moment1"].values()] == ptrs
    for model, opt in ((port, to), (fresh, fo)):
        model.compute_loss(model(ids), labels).backward()
        opt.step()
        opt.clear_grad()
    assert fo._global_step == to._global_step == 3
    for (n, a), (_, b) in zip(port.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b), n
    for name in ("moment1", "moment2"):
        for a, b in zip(to._accumulators[name].values(),
                        fo._accumulators[name].values()):
            assert torch.equal(a, b)


def test_set_lr_and_scheduler_as_reference():
    w = torch.nn.Parameter(torch.ones(2))
    jw = paddle.nn.Parameter(np.ones(2, np.float32))
    for mod, p in ((topt, w), (jopt, jw)):
        opt = mod.SGD(learning_rate=0.1, parameters=[p])
        opt.set_lr(0.25)
        assert opt.get_lr() == 0.25
        sched = (tlr if mod is topt else jlr).StepDecay(0.5, step_size=1)
        opt.set_lr_scheduler(sched)
        assert opt.get_lr() == 0.5
        with pytest.raises(RuntimeError, match="scheduler"):
            opt.set_lr(0.1)


def test_parameter_groups_per_group_lr_and_decay():
    """Three AdamW steps with two groups (the first at half the learning
    rate and weight decay 0.1, the second the defaults) equal the
    reference's two optimizers, one a group, with those settings."""
    jmodel, port = models()
    jp, tp = list(jmodel.parameters()), list(port.parameters())
    cut = len(tp) // 2
    to = topt.AdamW(learning_rate=1e-3, weight_decay=0.01, parameters=[
        {"params": tp[:cut], "learning_rate": 0.5, "weight_decay": 0.1},
        {"params": tp[cut:]}])
    jo_a = jopt.AdamW(learning_rate=5e-4, weight_decay=0.1,
                      parameters=jp[:cut])
    jo_b = jopt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                      parameters=jp[cut:])
    ids, labels = batch()
    for _ in range(3):
        jl = jmodel.compute_loss(jmodel(paddle.to_tensor(ids)),
                                 paddle.to_tensor(labels))
        jl.backward()
        jo_a.step()
        jo_b.step()
        jmodel.clear_gradients()
        tl = port.compute_loss(port(torch.from_numpy(ids)),
                               torch.from_numpy(labels))
        tl.backward()
        to.step()
        to.clear_grad()
        np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-5)
    assert_params_close(jmodel, port)


def test_parameter_groups_without_options_match_reference_groups():
    """Groups that set nothing: the reference's flattening, step for
    step (SGD with the optimizer's L2 decay)."""
    jmodel, port = models()
    jp, tp = list(jmodel.parameters()), list(port.parameters())
    jo = jopt.SGD(learning_rate=0.05, weight_decay=0.01,
                  parameters=[{"params": jp[:3]}, {"params": jp[3:]}])
    to = topt.SGD(learning_rate=0.05, weight_decay=0.01,
                  parameters=[{"params": tp[:3]}, {"params": tp[3:]}])
    train(jmodel, port, jo, to)
    assert_params_close(jmodel, port)


def test_group_weight_decay_float_is_l2_for_sgd():
    """A non-decoupled optimizer takes a group's float weight_decay as
    L2Decay: SGD with it equals SGD with L2Decay on that parameter."""
    a = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    b = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    ga = topt.SGD(learning_rate=0.1, parameters=[
        {"params": [a], "weight_decay": 0.5}])
    gb = topt.SGD(learning_rate=0.1, parameters=[b],
                  weight_decay=P.regularizer.L2Decay(0.5))
    for p, o in ((a, ga), (b, gb)):
        p.grad = torch.tensor([0.25, 0.25])
        o.step()
    assert torch.equal(a, b)
