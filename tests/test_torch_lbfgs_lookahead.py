"""The port's LBFGS (``paddle_tpu_torch/optimizer/lbfgs.py``) and
LookAhead/ModelAverage (``paddle_tpu_torch/incubate/lookahead.py``)
against the reference's, on the reference's own cases
(``tests/test_incubate_and_functional_autograd.py``'s LBFGS problems,
``tests/test_api_parity_batch.py``'s incubate surface).

LBFGS: each problem's answer (least squares, Rosenbrock's minimum, the
decayed stationary point) within the reference test's bound, and the
port's iterate within ITERATE_ATOL of the reference's on the same
problem.  Both run in float32 and branch on the host on the same
readings, but their dot products are sums in another order, and near a
minimum the stopping test (a loss change below 1e-9) reads rounding: the
least-squares runs stop a few iterations apart, 1.3e-4 from each other
and each within 1e-4 of the answer, so that problem is held to its own
bound (1e-3) and its loss to 1e-5 relative of the reference's; the others
to 1e-4.  LookAhead and
ModelAverage do elementwise float32 arithmetic in the same order as the
reference: within 1e-6.  Every parameter keeps its address
(``data_ptr()``) through them: the port writes iterates in place.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import incubate as jinc
from paddle_tpu import optimizer as jopt

import paddle_tpu_torch as P
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch import optimizer as topt

ITERATE_ATOL = {"lsq": 1e-3, "rosenbrock": 1e-4, "decay": 1e-4}
LSQ_LOSS_RTOL = 1e-5


def ref_param(a):
    x = paddle.to_tensor(np.asarray(a, np.float32))
    x.stop_gradient = False
    return x


def port_param(a):
    return torch.nn.Parameter(torch.tensor(np.asarray(a, np.float32)))


def lsq(rs=6):
    r = np.random.RandomState(rs)
    return r.randn(10, 4).astype("float32"), r.randn(10).astype("float32")


def run_lbfgs(pkg, problem, steps, **kw):
    """``problem`` in {"lsq", "rosenbrock", "decay"}; returns x."""
    if problem == "lsq":
        A, b = lsq()
        start = np.zeros(4, np.float32)
    elif problem == "rosenbrock":
        start = np.array([-1.2, 1.0], np.float32)
    else:
        start = np.array([5.0], np.float32)
    if pkg == "ref":
        x = ref_param(start)
        opt = jopt.LBFGS(parameters=[x], **kw)
        T = paddle.to_tensor
    else:
        x = port_param(start)
        opt = topt.LBFGS(parameters=[x], **kw)
        T = torch.from_numpy
    ptr = None if pkg == "ref" else x.data_ptr()

    def closure():
        if problem == "lsq":
            r = T(A) @ x - T(b)
            loss = (r * r).sum()
        elif problem == "rosenbrock":
            a = x[1] - x[0] * x[0]
            c = 1.0 - x[0]
            loss = 100.0 * (a * a) + c * c
        else:
            loss = ((x - 5.0) ** 2).sum()
        opt.clear_grad()
        loss.backward()
        return loss

    for _ in range(steps):
        opt.step(closure)
    if ptr is not None:
        assert x.data_ptr() == ptr
        return x.detach().numpy()
    return np.asarray(x.numpy())


LBFGS_CASES = {
    "lsq": (3, dict(learning_rate=1.0, max_iter=30,
                    line_search_fn="strong_wolfe")),
    "rosenbrock": (10, dict(learning_rate=1.0, max_iter=50,
                            line_search_fn="strong_wolfe")),
    "decay": (5, dict(learning_rate=0.5, max_iter=5, weight_decay=1.0)),
}


@pytest.mark.parametrize("problem", sorted(LBFGS_CASES))
def test_lbfgs_solves_the_reference_problems_as_the_reference(problem):
    steps, kw = LBFGS_CASES[problem]
    got = run_lbfgs("port", problem, steps, **kw)
    want = run_lbfgs("ref", problem, steps, **kw)
    if problem == "lsq":
        A, b = lsq()
        x_star = np.linalg.lstsq(A.astype(np.float64), b.astype(np.float64),
                                 rcond=None)[0]
        np.testing.assert_allclose(got, x_star, atol=1e-3)
        loss = [float(np.sum((A.astype(np.float64) @ v - b) ** 2))
                for v in (got, want)]
        np.testing.assert_allclose(loss[0], loss[1], rtol=LSQ_LOSS_RTOL)
    elif problem == "rosenbrock":
        np.testing.assert_allclose(got, [1.0, 1.0], atol=1e-2)
    else:
        # with wd = 1 the stationary point is 2 (x - 5) + x = 0: x = 10/3
        np.testing.assert_allclose(got, [10.0 / 3.0], atol=1e-2)
    np.testing.assert_allclose(got, want, atol=ITERATE_ATOL[problem])


def test_lbfgs_history_is_bounded_and_iterates_move_in_place():
    """``history_size`` bounds the (s, y) pairs; every closure call sees
    the parameter at the same address."""
    A, b = lsq(7)
    x = port_param(np.zeros(4))
    opt = topt.LBFGS(learning_rate=1.0, max_iter=12, history_size=2,
                     parameters=[x])
    ptrs = set()

    def closure():
        ptrs.add(x.data_ptr())
        r = torch.from_numpy(A) @ x - torch.from_numpy(b)
        loss = (r * r).sum()
        opt.clear_grad()
        loss.backward()
        return loss

    first = opt.step(closure)
    assert len(opt._s_hist) <= 2 and len(opt._y_hist) == len(opt._s_hist)
    assert ptrs == {x.data_ptr()}
    assert float(closure().detach()) < float(first.detach())


def test_lbfgs_requires_a_closure():
    x = port_param([1.0])
    with pytest.raises(ValueError, match="closure"):
        topt.LBFGS(parameters=[x]).step()


def incubate_inputs(seed=11):
    r = np.random.RandomState(seed)
    return (r.randn(4, 4).astype(np.float32), r.randn(4).astype(np.float32),
            r.randn(2, 4).astype(np.float32))


@pytest.mark.parametrize("k", [2, 3])
def test_lookahead_matches_reference(k):
    """``LookAhead(SGD(0.1), alpha=0.5, k)`` over 5 steps of the
    reference test's loss ``mean(linear(x) ** 2)``: weights within 1e-6 of
    the reference's, at the same addresses."""
    w0, b0, x = incubate_inputs()
    jl = paddle.nn.Linear(4, 4)
    jl.weight.set_value(paddle.to_tensor(w0))
    jl.bias.set_value(paddle.to_tensor(b0))
    jo = jinc.LookAhead(jopt.SGD(learning_rate=0.1,
                                 parameters=jl.parameters()),
                        alpha=0.5, k=k)
    tl = P.nn.Linear(4, 4, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w0))
        tl.bias.copy_(torch.from_numpy(b0))
    to = tinc.LookAhead(topt.SGD(learning_rate=0.1,
                                 parameters=tl.parameters()),
                        alpha=0.5, k=k)
    ptrs = [p.data_ptr() for p in tl.parameters()]
    for _ in range(5):
        loss = (jl(paddle.to_tensor(x)) ** 2).mean()
        loss.backward()
        jo.step()
        jo.clear_grad()
        tloss = (tl(torch.from_numpy(x)) ** 2).mean()
        tloss.backward()
        to.step()
        to.clear_grad()
        np.testing.assert_allclose(tloss.item(), float(loss.numpy()),
                                   rtol=1e-6)
    for t, j in ((tl.weight, jl.weight), (tl.bias, jl.bias)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j.numpy()),
                                   rtol=1e-6, atol=1e-6)
    assert [p.data_ptr() for p in tl.parameters()] == ptrs
    sd = to.state_dict()
    assert sd["lookahead_step"] == 5
    to.set_state_dict(sd)
    assert to._step_count == 5 and "lookahead_step" in sd


def test_lookahead_slow_copy_is_taken_after_the_first_step():
    """As the reference's: the slow weights start from the parameters
    after the first inner step, as a copy (not the parameter itself)."""
    w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    opt = tinc.LookAhead(topt.SGD(learning_rate=0.5, parameters=[w]),
                         alpha=0.5, k=2)
    w.grad = torch.ones(2)
    opt.step()
    slow = opt._slow[id(w)]
    assert slow.data_ptr() != w.data_ptr()
    np.testing.assert_allclose(slow.numpy(), [0.5, 1.5])
    w.grad = torch.ones(2)
    opt.step()
    # fast 0, 1 -> slow 0.5 + 0.5 * (0 - 0.5) = 0.25, 1.25; fast reset
    np.testing.assert_allclose(w.detach().numpy(), [0.25, 1.25])
    np.testing.assert_allclose(slow.numpy(), [0.25, 1.25])


def test_model_average_matches_reference():
    """``ModelAverage`` over parameters updated between its steps: the
    averaged weights under ``apply()`` within 1e-6 of the reference's,
    put back by ``restore`` (the context manager) bitwise, at the same
    addresses; ``apply(need_restore=False)`` keeps the average."""
    w0, b0, _ = incubate_inputs(12)
    jw, jb = ref_param(w0), ref_param(b0)
    tw, tb = port_param(w0), port_param(b0)
    jma = jinc.ModelAverage(parameters=[jw, jb], max_average_window=3)
    tma = tinc.ModelAverage(parameters=[tw, tb], max_average_window=3)
    ptrs = [tw.data_ptr(), tb.data_ptr()]
    for k in range(5):
        for p in (jw, jb):
            p.set_value(p * 0.9 + 0.1 * (k + 1))
        with torch.no_grad():
            for p in (tw, tb):
                p.copy_(p * 0.9 + 0.1 * (k + 1))
        jma.step()
        tma.step()
    assert tma._count == jma._count
    before = [tw.detach().clone(), tb.detach().clone()]
    with jma.apply():
        javg = [np.asarray(jw.numpy()), np.asarray(jb.numpy())]
    with tma.apply():
        tavg = [tw.detach().numpy().copy(), tb.detach().numpy().copy()]
        assert [tw.data_ptr(), tb.data_ptr()] == ptrs
    for a, b in zip(tavg, javg):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert torch.equal(tw, before[0]) and torch.equal(tb, before[1])
    assert tma.apply(need_restore=False) is None
    np.testing.assert_allclose(tw.detach().numpy(), tavg[0])
    tma.restore()
    assert torch.equal(tw, before[0])


def test_incubate_surface_as_the_reference_test():
    """``tests/test_api_parity_batch.py``'s incubate case on the port:
    LookAhead over SGD for 4 steps, then ModelAverage's apply leaves the
    weights as they were once restored."""
    m = P.nn.Linear(4, 4, device="cpu")
    opt = tinc.LookAhead(topt.SGD(learning_rate=0.1,
                                  parameters=m.parameters()), alpha=0.5, k=2)
    x = torch.randn(2, 4)
    for _ in range(4):
        loss = (m(x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    ma = tinc.ModelAverage(parameters=m.parameters())
    for _ in range(3):
        ma.step()
    w = m.weight.detach().clone()
    with ma.apply():
        pass
    assert torch.equal(m.weight.detach(), w)
