"""The port's amp package (paddle_tpu_torch/amp) against the JAX
package's: the O1 lists and the custom lists scoped to their guard, O2
``decorate``, and ``GradScaler``'s scale trajectory, state_dict and
device-side skip on a 2-layer, width-64 Llama with an injected inf, on
the same numpy weights.  Tolerances: f32 losses and parameters within
1e-5 relative (two f32 passes in other summation orders); the scale, the
counters and a skipped step exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import random_state
from paddle_tpu.models import llama as jllama
import paddle_tpu_torch as P
from paddle_tpu_torch.core import place
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           load_reference_arrays)


@pytest.fixture(autouse=True)
def _cpu_and_reference_rng():
    """The port on the CPU; paddle.seed below must not leak into later
    files of the worker."""
    P.set_device("cpu")
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    place._current = None
    random_state.seed(seed)
    random_state.set_rng_state(key)


# ---------------------------------------------------------------------------
# O1: the lists and their scope
# ---------------------------------------------------------------------------

def test_o1_lists_and_aliases_are_the_references():
    assert tamp.white_list == jamp.white_list
    assert tamp.black_list == jamp.black_list
    assert tamp._OP_ALIASES == jamp._OP_ALIASES


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_autocast_at_linear_and_matmul(dtype):
    """Under the guard linear and matmul compute in its dtype, as the
    reference's do; outside it float32; the values agree with the
    reference's in that dtype (1e-2 relative: 16-bit products)."""
    r = np.random.default_rng(0)
    x = r.standard_normal((3, 4)).astype(np.float32)
    w = r.standard_normal((4, 5)).astype(np.float32)
    jx, jw = paddle.to_tensor(x), paddle.to_tensor(w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    with jamp.auto_cast(dtype=dtype):
        jy = paddle.matmul(jx, jw)
        jl = jnn.functional.linear(jx, jw)
    with tamp.auto_cast(dtype=dtype):
        ty = P.matmul(tx, tw)
        tl = P.nn.functional.linear(tx, tw)
    want = getattr(torch, dtype)
    assert ty.dtype == tl.dtype == want
    assert str(jy.dtype).endswith(dtype) and str(jl.dtype).endswith(dtype)
    for t, j in ((ty, jy), (tl, jl)):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j.astype("float32").numpy()),
                                   rtol=1e-2, atol=1e-2)
    assert P.matmul(tx, tw).dtype == torch.float32


def test_amp_autocast_bf16():
    lin = P.nn.Linear(4, 4)
    x = torch.randn(2, 4)
    with tamp.auto_cast(dtype="bfloat16"):
        assert lin(x).dtype == torch.bfloat16
    assert lin(x).dtype == torch.float32


def test_amp_custom_lists_scoped_to_guard():
    """As tests/test_optimizer.py holds the reference: a custom list holds
    inside its guard only, and the module lists never change."""
    lin = P.nn.Linear(4, 4)
    x = torch.randn(2, 4)
    with tamp.auto_cast(dtype="bfloat16", custom_black_list={"linear"}):
        assert lin(x).dtype == torch.float32
        assert "linear" in tamp.amp_state().custom_black
    assert tamp.amp_state().custom_black == frozenset()
    assert "linear" not in tamp.black_list
    with tamp.auto_cast(dtype="bfloat16"):
        assert lin(x).dtype == torch.bfloat16
    assert "linear" in tamp.white_list


def test_amp_custom_lists_nested_guards():
    with tamp.auto_cast(custom_black_list={"linear"}):
        with tamp.auto_cast(custom_black_list={"matmul"}):
            assert tamp.amp_state().custom_black == {"linear", "matmul"}
        assert tamp.amp_state().custom_black == {"linear"}
    assert tamp.amp_state().custom_black == frozenset()


def test_custom_black_list_alias_vetoes_matmul():
    """'matmul_v2' (Paddle's op type) reaches the matmul call site in both
    packages; overlapping custom lists raise in both."""
    x = np.ones((2, 2), np.float32)
    with jamp.auto_cast(dtype="float16", custom_black_list={"matmul_v2"}):
        jy = paddle.matmul(paddle.to_tensor(x), paddle.to_tensor(x))
    with tamp.auto_cast(dtype="float16", custom_black_list={"matmul_v2"}):
        ty = P.matmul(torch.from_numpy(x), torch.from_numpy(x))
    assert str(jy.dtype).endswith("float32") and ty.dtype == torch.float32
    for mod in (jamp, tamp):
        with pytest.raises(ValueError, match="overlap"):
            mod.auto_cast(custom_white_list={"exp"},
                          custom_black_list={"exp"})


# ---------------------------------------------------------------------------
# O2: decorate
# ---------------------------------------------------------------------------

def models(layers=2, seed=7):
    """The reference tiny Llama (f32, width 64) and the port's with its
    weights."""
    paddle.seed(seed)
    cfg = dict(num_hidden_layers=layers, max_position_embeddings=64)
    jmodel = jllama.LlamaForCausalLM(jllama.llama_tiny_config(**cfg))
    port = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu")
    load_reference_arrays(port, {n: np.asarray(p.numpy())
                                 for n, p in jmodel.named_parameters()})
    return jmodel, port


def batch(seq=32, batch_size=2, seed=5):
    r = np.random.RandomState(seed)
    return (r.randint(0, 256, (batch_size, seq)),
            r.randint(0, 256, (batch_size, seq)))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_decorate_o2_casts_parameters_in_place(dtype):
    """Every float32 parameter becomes ``dtype`` with the same values
    rounded as the reference rounds them; the Parameter objects stay, so
    an optimizer built before keeps its list; O1 changes nothing."""
    jmodel, port = models()
    params = list(port.parameters())
    opt = topt.AdamW(parameters=params)
    out = tamp.decorate(port, opt, level="O2", dtype=dtype)
    assert out == (port, opt)
    jamp.decorate(jmodel, level="O2", dtype=dtype)
    assert list(port.parameters()) == params == opt._parameter_list
    assert port._casted_by_pure_fp16
    want = {n: np.asarray(p.astype("float32").numpy())
            for n, p in jmodel.named_parameters()}
    for n, p in port.named_parameters():
        assert p.dtype == getattr(torch, dtype), n
        np.testing.assert_array_equal(p.float().detach().numpy(), want[n])
    _, o1 = models()
    tamp.decorate(o1, level="O1")
    assert all(p.dtype == torch.float32 for p in o1.parameters())


# ---------------------------------------------------------------------------
# GradScaler
# ---------------------------------------------------------------------------

def _inject_inf(jmodel, port) -> None:
    """An inf in the first element of the first parameter's grad, in both
    packages."""
    jp = next(iter(jmodel.parameters()))
    jp._grad = jp._grad.reshape(-1).at[0].set(jnp.inf).reshape(
        jp._grad.shape)
    tp = next(iter(port.parameters()))
    tp.grad.view(-1)[0] = float("inf")


def test_grad_scaler_trajectory_matches_reference_on_llama():
    """Six scaled AdamW steps of the tiny Llama on one batch, an inf
    injected into the grads at step 2: the losses (1e-5), the scale after
    every update and the scaler's state_dict (exact), the optimizer's step
    count (the applied updates) and every parameter (1e-5) agree."""
    jmodel, port = models()
    ids, labels = batch()
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_ratio=0.25)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jmodel.parameters(),
                    weight_decay=0.01)
    to = topt.AdamW(learning_rate=1e-3, parameters=port.parameters(),
                    weight_decay=0.01)
    jl_all, tl_all, jscale, tscale = [], [], [], []
    for step in range(6):
        jl = jmodel.compute_loss(jmodel(paddle.to_tensor(ids)),
                                 paddle.to_tensor(labels))
        js.scale(jl).backward()
        tl = port.compute_loss(port(torch.from_numpy(ids)),
                               torch.from_numpy(labels))
        ts.scale(tl).backward()
        if step == 2:
            _inject_inf(jmodel, port)
        js.step(jo)
        js.update()
        ts.step(to)
        ts.update()
        jo.clear_grad()
        to.clear_grad()
        jl_all.append(float(jl.numpy()))
        tl_all.append(tl.item())
        jscale.append(float(js._scale))
        tscale.append(ts.get_init_loss_scaling())
    assert tscale == jscale
    assert tscale[2] == tscale[1] * 0.25
    np.testing.assert_allclose(tl_all, jl_all, rtol=1e-5)
    assert ts.state_dict() == js.state_dict()
    assert int(to._global_step) == int(jo._global_step) == 5
    want = {n: np.asarray(p.numpy()) for n, p in jmodel.named_parameters()}
    for n, p in port.named_parameters():
        got = p.detach().numpy()
        err = np.linalg.norm(got - want[n]) / np.linalg.norm(want[n])
        assert err <= 1e-5, (n, err)


def test_grad_scaler_device_side_skip():
    """As the reference's test of the same name: an overflowed step keeps
    the parameters, the moments AND the step counter, bitwise; the scale
    halves; the next finite step applies with bias correction at step 1
    (bitwise the update of a fresh Adam's first step)."""
    w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    opt = topt.Adam(learning_rate=0.1, parameters=[w])
    scaler = tamp.GradScaler(init_loss_scaling=4.0)
    opt._get_state("moment1", w)
    opt._get_state("moment2", w)
    before = [t.clone() for t in (w.detach(), opt._get_state("moment1", w),
                                  opt._get_state("moment2", w))]
    w.grad = torch.tensor([float("inf"), 1.0])
    scaler.step(opt)
    scaler.update()
    after = (w.detach(), opt._get_state("moment1", w),
             opt._get_state("moment2", w))
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    assert isinstance(opt._global_step, torch.Tensor)
    assert int(opt._global_step) == 0
    assert scaler.get_init_loss_scaling() == 2.0
    assert int(scaler._good_steps) == 0 and scaler._found_inf
    w.grad = torch.tensor([4.0, 4.0])        # 2.0 each, unscaled
    scaler.step(opt)
    scaler.update()
    assert int(opt._global_step) == 1 and int(scaler._good_steps) == 1
    fresh = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    ref = topt.Adam(learning_rate=0.1, parameters=[fresh])
    fresh.grad = torch.tensor([2.0, 2.0])
    ref.step()
    assert torch.equal(w.detach(), fresh.detach())
    assert opt.state_dict()["global_step"] == 1


def test_grad_scaler_skip_matches_reference_state():
    """The same overflow through both packages: the reference's kept
    params and moments equal the port's, and so do both state dicts."""
    x = np.array([1.0, 2.0], np.float32)
    jw = paddle.nn.Parameter(x.copy())
    jo = jopt.Adam(learning_rate=0.1, parameters=[jw])
    js = jamp.GradScaler(init_loss_scaling=4.0)
    tw = torch.nn.Parameter(torch.from_numpy(x.copy()))
    to = topt.Adam(learning_rate=0.1, parameters=[tw])
    ts = tamp.GradScaler(init_loss_scaling=4.0)
    for g in ([np.inf, 1.0], [2.0, 2.0], [4.0, -8.0]):
        jw._grad = jnp.asarray(np.array(g, np.float32) * 4.0)
        tw.grad = torch.tensor(g) * 4.0
        js.step(jo)
        js.update()
        ts.step(to)
        ts.update()
        np.testing.assert_allclose(tw.detach().numpy(), jw.numpy(),
                                   rtol=1e-5)
    assert ts.state_dict() == js.state_dict()
    jsd, tsd = jo.state_dict(), to.state_dict()
    assert set(jsd) == set(tsd) and tsd["global_step"] == 2
    for k in jsd:
        if k != "global_step":
            np.testing.assert_allclose(tsd[k].numpy(),
                                       np.asarray(jsd[k].numpy()),
                                       rtol=1e-5)


def test_grad_scaler_unscales_in_place():
    """The grads keep their storage (the update table holds their
    addresses) and take the reference's values, f32 and f16."""
    for dt in (torch.float32, torch.float16):
        w = torch.nn.Parameter(torch.ones(5, dtype=dt))
        g = torch.tensor([3.0, -5.0, 0.5, 65504.0, 1e-3], dtype=dt)
        w.grad = g.clone()
        ptr = w.grad.data_ptr()
        ts = tamp.GradScaler(init_loss_scaling=3.0)
        ts.unscale_(topt.SGD(parameters=[w]))
        assert w.grad.data_ptr() == ptr and not ts._found_inf
        want = (jnp.asarray(g.float().numpy()) * (1.0 / jnp.float32(3.0))) \
            .astype("float16" if dt == torch.float16 else "float32")
        np.testing.assert_array_equal(w.grad.float().numpy(),
                                      np.asarray(want, np.float32))


def test_scaler_state_dict_round_trip_and_disabled_scaler():
    ts = tamp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=3)
    assert ts.state_dict()["scale"] == 8.0
    w = torch.nn.Parameter(torch.ones(2))
    opt = topt.SGD(learning_rate=0.5, parameters=[w])
    (ts.scale(w.sum()) * 1.0).backward()
    ts.minimize(opt, None)
    sd = ts.state_dict()
    assert sd["good_steps"] == 1 and sd["scale"] == 8.0
    # the ratios and periods are the constructor's, as in the reference
    fresh = tamp.GradScaler(incr_every_n_steps=3)
    fresh.load_state_dict(sd)
    assert fresh.state_dict() == sd
    off = tamp.GradScaler(enable=False)
    loss = w.sum()
    assert off.scale(loss) is loss and not off.is_enable()


def test_o2_float16_llama_skips_then_trains():
    """O2 in float16 (the card's amp train phase, at width 64): step 1
    overflows at 2^40 and changes nothing, bitwise; the scale falls by
    2^-30; three applied steps give finite, falling losses; f32 moments
    (the (float16, float32) group of the update)."""
    _, port = models()
    tamp.decorate(port, level="O2", dtype="float16")
    opt = topt.AdamW(learning_rate=1e-3, parameters=port.parameters(),
                     weight_decay=0.01, multi_precision=True)
    scaler = tamp.GradScaler(init_loss_scaling=2.0 ** 40,
                             decr_ratio=2.0 ** -30)
    ids, labels = (torch.from_numpy(a) for a in batch())
    losses = []
    for step in range(4):
        loss = port.compute_loss(port(ids), labels)
        scaler.scale(loss).backward()
        if step == 0:
            before = {n: p.detach().clone()
                      for n, p in port.named_parameters()}
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        if step == 0:
            assert scaler._found_inf
            for n, p in port.named_parameters():
                assert torch.equal(p.detach(), before[n]), n
            assert all(not m.any() for m in
                       opt._accumulators["moment1"].values())
            assert int(opt._global_step) == 0
            assert scaler.get_init_loss_scaling() == 2.0 ** 10
        else:
            losses.append(loss.item())
    m = next(iter(opt._accumulators["moment1"].values()))
    assert m.dtype == torch.float32
    assert int(opt._global_step) == 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
