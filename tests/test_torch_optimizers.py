"""The port's Momentum, Adagrad, Adamax, RMSProp, Lamb, Adadelta, Rprop,
NAdam, RAdam and ASGD (``paddle_tpu_torch/optimizer/optimizer.py``, whose
update on the CPU is the plain version of ``ops/cuda/fused_update.py``)
against the reference's (``paddle_tpu/optimizer/optimizer.py``).

Both packages take the same parameters and the same grads, made with numpy
from a seed and set on the parameters directly (so no forward pass enters
the comparison), with a regularizer, ``ClipGradByGlobalNorm`` and two
parameter groups, over 8 steps (RAdam's rectified branch starts at step 6).
Bounds, per tensor, ``max|port - ref| <= rtol * max|ref|``:

* float32: 1e-6.  Both compute in float32 in the same order; the port
  forms the step's scalars in float64 as the reference's eager step does,
  and a few operations may round one ulp apart (XLA's ``pow``, its sums).
  Lamb 1e-5: its trust ratio divides two norms summed in another order.
* bfloat16 parameters with float32 states (``multi_precision``): the
  reference rounds to bfloat16 after each operation and the port once per
  output, so parameters and states are held to 2^-7 relative L2 (two
  bfloat16 ulps), the bound of ``test_bf16_train_steps_track_reference``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStepCapture as JaxStep
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.regularizer import L2Decay as JL2

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStepCapture
from paddle_tpu_torch.nn import Linear as TLinear
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm as TClip
from paddle_tpu_torch.ops.cuda import fused_update as fu
from paddle_tpu_torch.regularizer import L2Decay as TL2

SHAPES = [(4, 3), (3,), (5,), (2, 2)]
STEPS = 8
F32_RTOL = 1e-6
LAMB_RTOL = 1e-5
BF16_REL_L2 = 2.0 ** -7

# name -> (constructor kwargs, takes weight_decay, takes multi_precision)
CASES = {
    "Momentum": (dict(learning_rate=0.05, momentum=0.9), True, True),
    "Momentum_nesterov": (dict(learning_rate=0.05, momentum=0.9,
                               use_nesterov=True), True, True),
    "Adagrad": (dict(learning_rate=0.1, initial_accumulator_value=0.1),
                True, True),
    "Adamax": (dict(learning_rate=0.05), True, False),
    "RMSProp": (dict(learning_rate=0.01, momentum=0.5), True, False),
    "RMSProp_centered": (dict(learning_rate=0.01, momentum=0.5,
                              centered=True), True, False),
    "Lamb": (dict(learning_rate=0.05, lamb_weight_decay=0.01), False, True),
    "Adadelta": (dict(learning_rate=1.0), True, False),
    "Rprop": (dict(learning_rate=0.01), False, False),
    "NAdam": (dict(learning_rate=0.05), True, True),
    "RAdam": (dict(learning_rate=0.05), True, True),
    "ASGD": (dict(learning_rate=0.05), True, True),
}


def cls_of(name):
    return name.split("_")[0]


def data(seed=0, steps=STEPS):
    r = np.random.RandomState(seed)
    params = [r.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(0.5 * r.randn(*s)).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    # a grad that flips sign each step on one tensor: Rprop's shrink branch
    for k, gs in enumerate(grads):
        gs[2] = np.abs(gs[2]) * (1 if k % 2 else -1)
    return params, grads


def kwargs_for(name, reg, clip, mp, pkg):
    kw, takes_wd, takes_mp = CASES[name]
    kw = dict(kw)
    if name.startswith("RMSProp_centered"):
        kw["centered"] = True
    if reg and takes_wd:
        kw["weight_decay"] = (JL2 if pkg == "ref" else TL2)(0.01)
    if clip:
        kw["grad_clip"] = (JClip if pkg == "ref" else TClip)(1.0)
    if mp and takes_mp:
        kw["multi_precision"] = True
    return kw


def groups(params):
    return [{"params": params[:2]}, {"params": params[2:]}]


def run_ref(name, params, grads, dtype="float32", reg=True, clip=True,
            mp=False, steps=STEPS):
    ps = [paddle.nn.Parameter(p, dtype=dtype) for p in params]
    opt = getattr(jopt, cls_of(name))(parameters=groups(ps),
                                      **kwargs_for(name, reg, clip, mp,
                                                   "ref"))
    for gs in grads[:steps]:
        for p, g in zip(ps, gs):
            p._grad = jnp.asarray(g).astype(p._array.dtype)
        opt.step()
        opt.clear_grad()
    return ps, opt


def run_port(name, params, grads, dtype=torch.float32, reg=True, clip=True,
             mp=False, steps=STEPS, opt=None, ps=None):
    if ps is None:
        ps = [torch.nn.Parameter(torch.from_numpy(p).to(dtype))
              for p in params]
    if opt is None:
        opt = getattr(topt, cls_of(name))(parameters=groups(ps),
                                          **kwargs_for(name, reg, clip, mp,
                                                       "port"))
    for gs in grads[:steps]:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g).to(p.dtype)
        opt.step()
        opt.clear_grad()
    return ps, opt


def np_of(x):
    """A port tensor or a reference Tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype("float32").numpy())


def ref_states(opt, ps):
    return {n: [np.asarray(jnp.asarray(opt._accumulators[n][id(p)],
                                       jnp.float32)) for p in ps]
            for n in opt._STATE_NAMES}


def port_states(opt, ps):
    return {n: [opt._accumulators[n][id(p)].float().numpy() for p in ps]
            for n in opt._STATE_NAMES}


def worst_rel(got, want):
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
               for g, w in zip(got, want))


def worst_rel_l2(got, want):
    return max(float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
               for g, w in zip(got, want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_float32_steps_match_reference(name):
    """8 steps with an L2 regularizer (where the optimizer takes one), the
    global-norm clip and two parameter groups: parameters and every state
    within F32_RTOL (Lamb LAMB_RTOL) of the reference's."""
    params, grads = data(seed=sorted(CASES).index(name))
    jps, jo = run_ref(name, params, grads)
    tps, to = run_port(name, params, grads)
    rtol = LAMB_RTOL if name == "Lamb" else F32_RTOL
    got = worst_rel([np_of(p) for p in tps], [np_of(p) for p in jps])
    print(f"{name}: parameters {got:.3e} apart (relative to max)")
    assert got <= rtol, got
    js, ts = ref_states(jo, jps), port_states(to, tps)
    assert sorted(js) == sorted(ts)
    for n in js:
        err = worst_rel(ts[n], js[n])
        assert err <= rtol, (n, err)
    assert to.state_dict()["global_step"] == STEPS


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if c[2]))
def test_bf16_multi_precision_tracks_reference(name):
    """bfloat16 parameters, float32 states (``multi_precision``): within
    BF16_REL_L2 of the reference's, states float32 on both sides."""
    params, grads = data(seed=40 + sorted(CASES).index(name))
    jps, jo = run_ref(name, params, grads, dtype="bfloat16", mp=True)
    tps, to = run_port(name, params, grads, dtype=torch.bfloat16, mp=True)
    assert all(p.dtype == torch.bfloat16 for p in tps)
    got = worst_rel_l2([np_of(p) for p in tps], [np_of(p) for p in jps])
    assert got <= BF16_REL_L2, got
    ts = port_states(to, tps)
    for n, lst in to._accumulators.items():
        if cls_of(name) != "ASGD":
            assert all(t.dtype == torch.float32 for t in lst.values()), n
    js = ref_states(jo, jps)
    for n in js:
        assert worst_rel_l2(ts[n], js[n]) <= BF16_REL_L2, n


QUADRATIC = [
    ("Momentum", {"learning_rate": 0.1, "momentum": 0.9}),
    ("Adagrad", {"learning_rate": 0.5}),
    ("RMSProp", {"learning_rate": 0.05}),
    ("Adamax", {"learning_rate": 0.2}),
    ("Lamb", {"learning_rate": 0.05}),
    ("Adadelta", {"learning_rate": 50.0}),
]


@pytest.mark.parametrize("name,kwargs", QUADRATIC,
                         ids=[n for n, _ in QUADRATIC])
def test_optimizers_converge_on_the_quadratic(name, kwargs):
    """``tests/test_optimizer.py``'s 150-step convergence cases on the
    port: ``(w * w).sum()`` from (5, -3) below 0.5."""
    w = torch.nn.Parameter(torch.tensor([5.0, -3.0]))
    opt = getattr(topt, name)(parameters=[w], **kwargs)
    for _ in range(150):
        loss = (w * w).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
    assert float((w * w).sum().detach()) < 0.5, name


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_carries_from_the_reference(name):
    """The reference takes 3 steps; its weights and ``state_dict()`` (as
    numpy arrays) load into the port; both take a 4th step on the same
    grads and agree within F32_RTOL (Lamb LAMB_RTOL)."""
    params, grads = data(seed=80 + sorted(CASES).index(name), steps=4)
    jps, jo = run_ref(name, params, grads, steps=3)
    sd = {k: (v if k in ("global_step", "LR_Scheduler")
              else np.asarray(v.numpy())) for k, v in jo.state_dict().items()}
    tps = [torch.nn.Parameter(torch.from_numpy(np_of(p).copy()))
           for p in jps]
    to = getattr(topt, cls_of(name))(
        parameters=groups(tps), **kwargs_for(name, True, True, False,
                                             "port"))
    to.set_state_dict(sd)
    assert to._global_step == 3
    assert sorted(to._accumulators) == sorted(jo._STATE_NAMES)
    for p, g in zip(jps, grads[3]):
        p._grad = jnp.asarray(g)
    jo.step()
    run_port(name, None, grads[3:4], opt=to, ps=tps)
    rtol = LAMB_RTOL if name == "Lamb" else F32_RTOL
    assert worst_rel([np_of(p) for p in tps], [np_of(p) for p in jps]) \
        <= rtol
    js, ts = ref_states(jo, jps), port_states(to, tps)
    for n in js:
        assert worst_rel(ts[n], js[n]) <= rtol, n


# the plain versions' rules and their constants
RULE_KW = {
    fu.MOMENTUM: dict(momentum=0.9, nesterov=True),
    fu.ADAGRAD: dict(epsilon=1e-6),
    fu.ADAMAX: dict(beta1=0.9, beta2=0.999, epsilon=1e-8),
    fu.RMSPROP: dict(rho=0.95, epsilon=1e-6, momentum=0.5),
    fu.RMSPROP_CENTERED: dict(rho=0.95, epsilon=1e-6, momentum=0.5),
    fu.ADADELTA: dict(rho=0.95, epsilon=1e-6),
    fu.RPROP: dict(etas=(0.5, 1.2), lr_range=(1e-5, 50.0)),
    fu.NADAM: dict(beta1=0.9, beta2=0.999, epsilon=1e-8),
    fu.RADAM: dict(beta1=0.9, beta2=0.999, epsilon=1e-8),
    fu.ASGD: dict(),
    fu.LAMB: dict(beta1=0.9, beta2=0.999, epsilon=1e-6, coeff=0.01),
}


def rule_tensors(kind, dtype=torch.float32, n=37, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(n, generator=g).to(dtype)
    gr = (0.1 * torch.randn(n, generator=g)).to(dtype)
    states = [(1e-3 * torch.rand(n, generator=g) + 1e-4).to(dtype)
              for _ in range(fu.N_STATES[kind])]
    return p, gr, states


@pytest.mark.parametrize("kind", sorted(RULE_KW),
                         ids=[fu.RULES[k] for k in sorted(RULE_KW)])
def test_overflow_flag_leaves_each_rule_bitwise_unchanged(kind):
    """The plain version of every later rule with the loss scaler's flag
    set keeps p and each state bitwise; with it clear, its result is
    bitwise the null flag's, and p moved."""
    p, g, st = rule_tensors(kind)
    old = [t.clone() for t in [p] + st]
    lr, step = torch.tensor(0.01), torch.tensor(7.0)
    ms = (st + [None] * 3)[:3]
    flag = torch.ones(())
    fu.fused_update(kind, [p], [g], *[[m] if m is not None else None
                                      for m in ms[:2]], [True], lr, step,
                    skip=flag, m3s=[ms[2]] if ms[2] is not None else None,
                    **RULE_KW[kind])
    for got, was in zip([p] + st, old):
        assert torch.equal(got, was)
    flag.zero_()
    q, _, st2 = rule_tensors(kind)
    for skip in (flag, None):
        tgt = (p, st) if skip is not None else (q, st2)
        ms = (tgt[1] + [None] * 3)[:3]
        fu.fused_update(kind, [tgt[0]], [g],
                        *[[m] if m is not None else None for m in ms[:2]],
                        [True], lr, step, skip=skip,
                        m3s=[ms[2]] if ms[2] is not None else None,
                        **RULE_KW[kind])
    assert torch.equal(p, q) and not torch.equal(p, old[0])
    for a, b in zip(st, st2):
        assert torch.equal(a, b)


def test_radam_rectification_is_formed_in_float64():
    """RAdam's rectification at step 6: rho_t = rho_inf - 2 t b2^t / bc2
    is 1999 - 1993.0..., a few units out of two thousand; formed in
    float32 it keeps no digit.  The plain version's update equals the
    float64 formula rounded to float32 once."""
    p = torch.tensor([1.0, -2.0, 0.5])
    g = torch.tensor([0.1, -0.2, 0.3])
    m1, m2 = torch.zeros(3), torch.zeros(3)
    step = 6.0
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 0.01
    want = p.double().clone()
    a = (1 - b1) * g.double()
    b = (1 - b2) * g.double() ** 2
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    rho_inf = 2 / (1 - b2) - 1
    rho_t = rho_inf - 2 * step * b2 ** step / bc2
    assert 5 < rho_t < 7
    rect = np.sqrt((rho_t - 4) * (rho_t - 2) * rho_inf
                   / ((rho_inf - 4) * (rho_inf - 2) * rho_t))
    want -= lr * (a / bc1) * rect / torch.sqrt(b / bc2 + eps ** 2)
    fu.fused_update(fu.RADAM, [p], [g], [m1], [m2], [False],
                    torch.tensor(lr), torch.tensor(step), beta1=b1,
                    beta2=b2, epsilon=eps)
    np.testing.assert_allclose(p.numpy(), want.float().numpy(), rtol=1e-6)


def test_rmsprop_uncentered_keeps_mean_grad_untouched():
    """Uncentered RMSProp allocates ``mean_grad`` (the reference keeps
    it), and the update neither reads nor writes it."""
    w = torch.nn.Parameter(torch.ones(3))
    opt = topt.RMSProp(learning_rate=0.1, parameters=[w])
    w.grad = torch.full((3,), 0.5)
    opt.step()
    assert torch.equal(opt._accumulators["mean_grad"][id(w)],
                       torch.zeros(3))
    assert opt._KIND == fu.RMSPROP
    assert topt.RMSProp(learning_rate=0.1, parameters=[w],
                        centered=True)._KIND == fu.RMSPROP_CENTERED


def test_asgd_average_is_a_copy_and_rprop_sizes_start_at_lr():
    w = torch.nn.Parameter(torch.ones(3))
    asgd = topt.ASGD(learning_rate=0.1, parameters=[w])
    w.grad = torch.ones(3)
    asgd.step()
    avg = asgd._accumulators["avg_param"][id(w)]
    assert avg.data_ptr() != w.data_ptr()
    # step 1: the average is the new parameter (a + (p - a) / 1)
    np.testing.assert_allclose(avg.numpy(), w.detach().numpy())
    v = torch.nn.Parameter(torch.ones(2))
    rp = topt.Rprop(learning_rate=0.25, parameters=[v])
    v.grad = torch.ones(2)
    rp.step()
    assert torch.equal(rp._accumulators["step_size"][id(v)],
                       torch.full((2,), 0.25))
    np.testing.assert_allclose(v.detach().numpy(), 0.75)


def test_lamb_exclude_fn_takes_the_parameter_in_both_steps():
    """``exclude_from_weight_decay_fn(p)`` gets the parameter and turns
    off ``wd * p`` for it, in the port's eager step as in the
    reference's."""
    r = np.random.RandomState(3)
    w0, b0 = r.randn(4, 4).astype(np.float32), r.randn(4).astype(np.float32)
    g = [np.full((4, 4), 0.1, np.float32), np.full(4, 0.1, np.float32)]
    jw, jb = paddle.nn.Parameter(w0), paddle.nn.Parameter(b0)
    jo = jopt.Lamb(learning_rate=0.1, lamb_weight_decay=0.5,
                   parameters=[jw, jb],
                   exclude_from_weight_decay_fn=lambda p: p is jb)
    jw._grad, jb._grad = jnp.asarray(g[0]), jnp.asarray(g[1])
    jo.step()
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tb = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    seen = []

    def excl(p):
        seen.append(p)
        return p is tb

    to = topt.Lamb(learning_rate=0.1, lamb_weight_decay=0.5,
                   parameters=[tw, tb], exclude_from_weight_decay_fn=excl)
    tw.grad, tb.grad = torch.from_numpy(g[0]), torch.from_numpy(g[1])
    to.step()
    assert any(p is tw for p in seen) and any(p is tb for p in seen)
    for t, j in ((tw, jw), (tb, jb)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j.numpy()),
                                   rtol=LAMB_RTOL, atol=LAMB_RTOL)


def test_captured_lamb_keeps_exclude_fn_unlike_the_reference():
    """Known difference (ROADMAP queue C, beside C5).  Lamb(lr 0.1,
    lamb_weight_decay 0.5, exclude_from_weight_decay_fn -> True), one step
    on zero gradients, so only the decay can move a weight.  The
    reference's captured step ignores the function: its ``_update`` reads
    ``self._wd_mask or (True, ...)``, which only ``step()`` sets, and
    ``TrainStepCapture`` calls ``_update`` directly.  So it decays: r =
    0.5 w, trust ||w|| / ||r|| = 2, w - 0.1 * 2 * 0.5 w = 0.9 w.  Its eager
    ``step()`` leaves w (1.0).  The port's captured and eager steps both
    equal the reference's eager step."""
    w0 = np.random.RandomState(0).standard_normal((4, 3)).astype(np.float32)
    x = np.ones((2, 4), np.float32)
    kw = dict(learning_rate=0.1, lamb_weight_decay=0.5,
              exclude_from_weight_decay_fn=lambda p: True)

    def zero_loss(model, x):
        return (model(x) * 0.0).sum()

    def ref_linear():
        lin = paddle.nn.Linear(4, 3, bias_attr=False)
        lin.weight.set_value(paddle.to_tensor(w0))
        return lin

    jcap = ref_linear()
    JaxStep(jcap, jopt.Lamb(parameters=jcap.parameters(), **kw),
            zero_loss)(paddle.to_tensor(x))
    jeag = ref_linear()
    jo = jopt.Lamb(parameters=jeag.parameters(), **kw)
    zero_loss(jeag, paddle.to_tensor(x)).backward()
    jo.step()
    np.testing.assert_allclose(np.asarray(jcap.weight.numpy()) / w0, 0.9,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jeag.weight.numpy()) / w0, 1.0,
                               rtol=1e-6)

    def port_linear():
        lin = TLinear(4, 3, bias=False, device="cpu")
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w0))
        return lin

    tcap = port_linear()
    TrainStepCapture(tcap, topt.Lamb(parameters=tcap.parameters(), **kw),
                     zero_loss)(torch.from_numpy(x))
    teag = port_linear()
    to = topt.Lamb(parameters=teag.parameters(), **kw)
    zero_loss(teag, torch.from_numpy(x)).backward()
    to.step()
    for lin in (tcap, teag):
        np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                      np.asarray(jeag.weight.numpy()))
