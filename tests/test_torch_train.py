"""The port's training path (paddle_tpu_torch: cross_entropy, the
optimizers and clips, the Llama backward through flash_sdpa) against the
JAX package's, on the same numpy inputs and the same weights.

On the CPU the port's attention runs the flash kernels' plain versions
through the same autograd Function as on the card.  At seq 128 the
reference runs its plain ``sdpa``; at seq 1024, with its
``_PALLAS_INTERPRET`` set, its Pallas kernels ``_fwd_kernel``,
``_dq_kernel`` and ``_dkv_kernel``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.core import random_state
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn import clip as jclip
from paddle_tpu.nn.functional import attention as jfa
from paddle_tpu.ops.pallas import attention as pa
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           load_reference_arrays)
from paddle_tpu_torch.nn import functional as F


@pytest.fixture(autouse=True)
def _restore_reference_rng():
    """paddle.seed below must not leak: later files in the same worker
    derive their random streams from the reference's global seed."""
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    random_state.seed(seed)
    random_state.set_rng_state(key)


def rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------

CE_CASES = {
    "mean_ignore_index": dict(),
    "sum": dict(reduction="sum"),
    "none": dict(reduction="none"),
    "label_smoothing": dict(label_smoothing=0.1),
    "soft_label": dict(soft_label=True),
    "axis1": dict(axis=1),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_matches_reference(case):
    """Loss and d(loss)/d(logits) in f32 within 1e-6 (same formula,
    logsumexp in another summation order)."""
    kw = CE_CASES[case]
    r = rng(1)
    axis = kw.get("axis", -1)
    logits = (r.standard_normal((6, 7, 11)) * 3).astype(np.float32)
    if kw.get("soft_label"):
        label = r.random((6, 7, 11)).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    elif axis == 1:
        label = r.integers(0, 7, (6, 11))
    else:
        label = r.integers(0, 11, (6, 7))
        label[0, :3] = -100                     # ignored positions
    jx = paddle.to_tensor(logits, stop_gradient=False)
    jl = JF.cross_entropy(jx, paddle.to_tensor(label), **kw)
    jl.sum().backward()
    tx = torch.from_numpy(logits).requires_grad_()
    tl = F.cross_entropy(tx, torch.from_numpy(label), **kw)
    tl.sum().backward()
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(tl.detach().numpy(), jl.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               rtol=1e-6, atol=1e-6)


def test_cross_entropy_refuses_what_it_leaves_out():
    """Class weights and use_softmax=False compute now (C7; held to the
    reference in tests/test_torch_nn_functional.py); an unknown reduction
    still raises."""
    x, y = torch.zeros(2, 3), torch.zeros(2, dtype=torch.long)
    np.testing.assert_allclose(
        F.cross_entropy(x, y, weight=torch.ones(3)).item(), np.log(3),
        rtol=1e-6)
    np.testing.assert_allclose(
        F.cross_entropy(torch.full((2, 3), 0.25), y, use_softmax=False)
        .item(), np.log(4), rtol=1e-6)
    with pytest.raises(ValueError, match="reduction"):
        F.cross_entropy(x, y, reduction="avg")


# ---------------------------------------------------------------------------
# optimizers and clips: 5-step trajectories on hand-set gradients
# ---------------------------------------------------------------------------

SHAPES = {"w0": (8, 5), "w1": (5, 3), "bias": (3,)}


def no_bias(name):
    return name != "bias"


OPT_CASES = {
    "sgd": (lambda m, **kw: m.SGD(learning_rate=0.1, **kw), {}),
    "adam": (lambda m, **kw: m.Adam(learning_rate=0.01, **kw), {}),
    "adam_multi_precision": (lambda m, **kw: m.Adam(
        learning_rate=0.01, multi_precision=True, **kw), {}),
    "adamw_decay_mask": (lambda m, **kw: m.AdamW(
        learning_rate=0.01, weight_decay=0.1,
        apply_decay_param_fun=no_bias, **kw), {}),
    "adamw_multi_precision_global_norm_clip": (lambda m, **kw: m.AdamW(
        learning_rate=0.01, weight_decay=0.1, multi_precision=True,
        apply_decay_param_fun=no_bias, **kw), {"clip": "global"}),
    "adam_l2_decay_clip_by_norm": (lambda m, **kw: m.Adam(
        learning_rate=0.01, weight_decay=0.05, **kw), {"clip": "norm"}),
    "sgd_clip_by_value_scheduler": (lambda m, **kw: m.SGD(**kw),
                                    {"clip": "value", "sched": True}),
    "sgd_l1_decay": (lambda m, **kw: m.SGD(learning_rate=0.1, **kw),
                     {"l1": 0.05}),
}


def make_clip(kind, nn_mod):
    return {None: None,
            "global": lambda: nn_mod.ClipGradByGlobalNorm(1.0),
            "norm": lambda: nn_mod.ClipGradByNorm(0.5),
            "value": lambda: nn_mod.ClipGradByValue(0.3)}[kind]


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_trajectory_matches_reference(case):
    """Five steps on the same f32 parameters and gradients: parameters and
    moments within 1e-6 (the same arithmetic in the same order; scalars
    such as the bias corrections are formed in f64 here and in f32 there,
    one f32 ulp apart)."""
    build, opts = OPT_CASES[case]
    r = rng(2)
    init = {n: r.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
    grads = [{n: (r.standard_normal(s) * 2).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(5)]
    jparams = [JParameter(jnp.asarray(a), name=n) for n, a in init.items()]
    tnamed = [(n, torch.nn.Parameter(torch.from_numpy(a.copy())))
              for n, a in init.items()]
    tparams = [p for _, p in tnamed]
    kw_j, kw_t = {}, {}
    clip = make_clip(opts.get("clip"), jclip)
    if clip:
        kw_j["grad_clip"] = clip()
        kw_t["grad_clip"] = make_clip(opts["clip"], tnn)()
    if opts.get("l1"):
        kw_j["weight_decay"] = jreg.L1Decay(opts["l1"])
        kw_t["weight_decay"] = treg.L1Decay(opts["l1"])
    if opts.get("sched"):
        kw_j["learning_rate"] = jopt.lr.CosineAnnealingDecay(0.2, T_max=4)
        kw_t["learning_rate"] = topt.lr.CosineAnnealingDecay(0.2, T_max=4)
    jo = build(jopt, parameters=jparams, **kw_j)
    to = build(topt, parameters=tnamed, **kw_t)
    for step in grads:
        for jp, tp in zip(jparams, tparams):
            jp._grad = jnp.asarray(step[jp.name])
            tp.grad = torch.from_numpy(step[jp.name].copy())
        jo.step()
        to.step()
        if opts.get("sched"):
            jo._learning_rate.step()
            to._learning_rate.step()
        assert to.get_lr() == jo.get_lr()
    assert to._global_step == jo._global_step == 5
    for jp, tp in zip(jparams, tparams):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp.numpy()),
                                   rtol=1e-6, atol=1e-6, err_msg=jp.name)
        for acc in jo._STATE_NAMES:
            jm = np.asarray(jo._accumulators[acc][id(jp)])
            tm = to._accumulators[acc][id(tp)]
            assert str(tm.dtype)[6:] == str(jm.dtype), (acc, tm.dtype)
            np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{jp.name} {acc}")
    to.clear_grad()
    assert all(p.grad is None for p in tparams)


def test_optimizer_refuses_parameter_groups():
    """Parameter groups are ported: a group without its 'params' list is
    what the optimizer refuses now."""
    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(TypeError, match="parameter group"):
        topt.AdamW(parameters=[{"learning_rate": 0.5}])
    opt = topt.AdamW(parameters=[{"params": [p]}])
    assert opt._parameter_list == [p]


def test_moments_follow_multi_precision():
    bf = torch.nn.Parameter(torch.zeros(3, dtype=torch.bfloat16))
    bf.grad = torch.ones(3, dtype=torch.bfloat16)
    for mp, want in ((False, torch.bfloat16), (True, torch.float32)):
        opt = topt.AdamW(parameters=[bf], multi_precision=mp)
        opt.step()
        assert opt._accumulators["moment1"][id(bf)].dtype == want


# ---------------------------------------------------------------------------
# tiny Llama: loss and every parameter's gradient, and an AdamW trajectory
# ---------------------------------------------------------------------------

def models(layers, max_pos, seed=7):
    """The reference tiny Llama (f32) and the port's with its weights."""
    paddle.seed(seed)
    cfg = dict(num_hidden_layers=layers, max_position_embeddings=max_pos)
    jmodel = jllama.LlamaForCausalLM(jllama.llama_tiny_config(**cfg))
    port = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu")
    load_reference_arrays(port, {n: np.asarray(p.numpy())
                                 for n, p in jmodel.named_parameters()})
    return jmodel, port


def batch(seq, batch_size, seed):
    r = np.random.RandomState(seed)
    return (r.randint(0, 256, (batch_size, seq)),
            r.randint(0, 256, (batch_size, seq)))


def loss_and_grads(jmodel, port, ids, labels):
    jloss = jmodel.compute_loss(jmodel(paddle.to_tensor(ids)),
                                paddle.to_tensor(labels))
    jloss.backward()
    tloss = port.compute_loss(port(torch.from_numpy(ids)),
                              torch.from_numpy(labels))
    tloss.backward()
    jgrads = {n: np.asarray(p.grad.numpy())
              for n, p in jmodel.named_parameters()}
    tgrads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    return float(jloss.numpy()), tloss.item(), jgrads, tgrads


def assert_grads_close(jgrads, tgrads, rel):
    """Every parameter's gradient: ||port - ref|| <= rel ||ref||."""
    assert set(jgrads) == set(tgrads)
    for n, want in jgrads.items():
        err = np.linalg.norm(tgrads[n] - want) / np.linalg.norm(want)
        assert err <= rel, (n, err)


def test_llama_loss_and_grads_match_reference_sdpa_seq128():
    """seq 128, 2 layers, GQA 4/2: the reference runs its plain sdpa.
    f32: loss within 1e-6 relative, each grad within 1e-5 relative L2 (two
    f32 backward passes in different summation orders)."""
    jmodel, port = models(layers=2, max_pos=128)
    jl, tl, jg, tg = loss_and_grads(jmodel, port, *batch(128, 2, seed=3))
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    assert_grads_close(jg, tg, 1e-5)


def test_llama_loss_and_grads_match_reference_pallas_seq1024(monkeypatch):
    """seq 1024, 1 layer: with ``_PALLAS_INTERPRET`` the reference's loss
    and grads come through its Pallas flash kernels (counted below).
    Same tolerances as at seq 128."""
    monkeypatch.setattr(jfa, "_PALLAS_INTERPRET", True)
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("_flash_fwd", "fwd"), ("_flash_bwd", "bwd")):
        real = getattr(pa, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(pa, name, counted)
    jmodel, port = models(layers=1, max_pos=1024)
    jl, tl, jg, tg = loss_and_grads(jmodel, port, *batch(1024, 1, seed=4))
    assert calls == {"fwd": 1, "bwd": 1}
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    assert_grads_close(jg, tg, 1e-5)


def test_llama_adamw_three_steps_match_reference():
    """bench_llama's loop, eagerly: loss.backward(); opt.step();
    opt.clear_grad() with AdamW(weight_decay=0.01), 3 steps on one batch.
    Losses within 1e-5 relative, parameters within 1e-5 relative L2."""
    jmodel, port = models(layers=2, max_pos=64)
    ids, labels = batch(64, 2, seed=5)
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jmodel.parameters(),
                    weight_decay=0.01)
    to = topt.AdamW(learning_rate=1e-3, parameters=port.parameters(),
                    weight_decay=0.01)
    jlosses, tlosses = [], []
    for _ in range(3):
        jl = jmodel.compute_loss(jmodel(paddle.to_tensor(ids)),
                                 paddle.to_tensor(labels))
        jl.backward()
        jo.step()
        jo.clear_grad()
        tl = port.compute_loss(port(torch.from_numpy(ids)),
                               torch.from_numpy(labels))
        tl.backward()
        to.step()
        to.clear_grad()
        jlosses.append(float(jl.numpy()))
        tlosses.append(tl.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    assert_grads_close({n: np.asarray(p.numpy())
                        for n, p in jmodel.named_parameters()},
                       {n: p.detach().numpy()
                        for n, p in port.named_parameters()}, 1e-5)
