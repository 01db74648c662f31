"""The fused optimizer update's plain version and its wrapper
(``paddle_tpu_torch/ops/cuda/fused_update.py``) on the CPU.

The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py`` holds SGD/Adam/AdamW to this plain
version, the ``gpu``-marked cases at the end of this file the later
rules); here the plain version is held to the update written out in
float64 numpy, rounded once, and the optimizer's use of it is checked: lr
and step as 0-dim float32 tensors, AdamW's decay flags from
``apply_decay_param_fun``, nothing built for CPU tensors.  This file
imports neither jax nor paddle_tpu, so on the card:

    python -m pytest --noconftest tests/test_torch_fused_update.py -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.ops.cuda import fused_update as fu
from paddle_tpu_torch.ops.cuda.attention import LAUNCH_COUNTS

MANT = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}


def ulps_apart(got, want):
    """|got - want| in ulps of ``want``'s value in got's dtype."""
    mant = MANT[got.dtype]
    w = want.double().abs().clamp_min(2.0 ** -24)
    ulp = torch.exp2(torch.floor(torch.log2(w)) - mant)
    return ((got.double() - want.double()).abs() / ulp).max().item()


def numpy_adamw(p, g, m1, m2, lr, step, decay, b1=0.9, b2=0.999, eps=1e-8,
                coeff=0.0):
    p, g, m1, m2 = (np.asarray(t, np.float64) for t in (p, g, m1, m2))
    if decay:
        p = p * (1 - lr * coeff)
    m1 = b1 * m1 + (1 - b1) * g
    m2 = b2 * m2 + (1 - b2) * g * g
    p = p - lr * (m1 / (1 - b1 ** step)) / (
        np.sqrt(m2 / (1 - b2 ** step)) + eps)
    return p, m1, m2


def tensors(n, dtype, mdtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    vals = (torch.randn(n, generator=g), 0.1 * torch.randn(n, generator=g),
            0.01 * torch.randn(n, generator=g),
            1e-3 * torch.rand(n, generator=g))
    return [vals[0].to(dtype), vals[1].to(dtype), vals[2].to(mdtype),
            vals[3].to(mdtype)]


@pytest.mark.parametrize("dtype,mdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float16, torch.float32)],
    ids=["f32", "bf16", "bf16_f32", "f16_f32"])
@pytest.mark.parametrize("decay", [False, True])
def test_plain_version_rounds_each_output_once(dtype, mdtype, decay):
    """One AdamW update from the same inputs: the plain version's 16-bit
    p, m1 and m2 within one ulp of the float64 update rounded once; f32
    outputs within 1e-6 of the tensor's largest value (f32 arithmetic
    inside: a moment's terms may cancel, so its error is relative to the
    terms, not to the result)."""
    p, g, m1, m2 = tensors(4099, dtype, mdtype)
    want = numpy_adamw(p.float(), g.float(), m1.float(), m2.float(), 1e-2,
                       3.0, decay, coeff=0.1)
    lr, step = torch.tensor(1e-2), torch.tensor(3.0)
    fu.fused_update(fu.ADAM, [p], [g], [m1], [m2], [decay], lr, step,
                    coeff=0.1)
    for got, w in zip((p, m1, m2), want):
        if got.dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max())
        else:
            assert ulps_apart(got, torch.from_numpy(w)) <= 1


def test_sgd_plain_version():
    p, g, _, _ = tensors(100, torch.bfloat16, torch.bfloat16)
    want = (p.double() - 0.5 * g.double()).to(torch.bfloat16)
    fu.fused_update(fu.SGD, [p], [g], None, None, None, torch.tensor(0.5),
                    torch.tensor(1.0))
    assert ulps_apart(p, want.double()) <= 1


def test_the_cpu_takes_the_plain_version_and_builds_no_table():
    p, g, m1, m2 = tensors(10, torch.float32, torch.float32)
    cache = {}
    fu.fused_update(fu.ADAM, [p], [g], [m1], [m2], [True],
                    torch.tensor(0.1), torch.tensor(1.0), cache=cache)
    assert cache == {}
    assert fu.prepare(fu.ADAM, [p], [m1], [m2], [True], cache) is None
    assert cache == {}


def test_kernel_argument_checks():
    """What the CUDA route refuses, checked on any device: a grad in
    another dtype than its parameter, a moment group the kernel has no
    instance for, lr given as a Python number, float64."""
    p = torch.zeros(4)
    lr, st = torch.tensor(0.1), torch.tensor(1.0)
    with pytest.raises(TypeError, match="grad"):
        fu._check_args(fu.SGD, [p], [p.half()], None, None, lr, st)
    with pytest.raises(TypeError, match="group"):
        fu._check_args(fu.ADAM, [p.half()], [p.half()], [p.bfloat16()],
                       [p.bfloat16()], lr, st)
    with pytest.raises(TypeError, match="0-dim float32"):
        fu._check_args(fu.SGD, [p], [p], None, None, 0.1, st)
    with pytest.raises(TypeError, match="float32"):
        fu._check_args(fu.SGD, [p.double()], [p.double()], None, None, lr,
                       st)
    with pytest.raises(ValueError, match="contiguous"):
        q = torch.zeros(4, 4).t()
        fu._check_args(fu.SGD, [q], [q], None, None, lr, st)
    fu._check_args(fu.ADAM, [p.bfloat16()], [p.bfloat16()], [p], [p], lr,
                   st)


def test_step_passes_lr_and_step_as_float32_tensors(monkeypatch):
    seen = {}

    def spy(kind, params, grads, m1s, m2s, decay, lr, step, **kw):
        seen.update(kind=kind, lr=lr, step=step, decay=list(decay), kw=kw)

    monkeypatch.setattr(fu, "fused_update", spy)
    w = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.ones(2))
    opt = topt.AdamW(learning_rate=0.25, weight_decay=0.5,
                     parameters=[("w", w), ("bias", b)],
                     apply_decay_param_fun=lambda n: n != "bias")
    (w.sum() + b.sum()).backward()
    opt.step()
    assert seen["kind"] == fu.ADAM
    assert seen["lr"].dtype == seen["step"].dtype == torch.float32
    assert seen["lr"].dim() == seen["step"].dim() == 0
    assert seen["lr"].item() == 0.25 and seen["step"].item() == 1.0
    assert seen["decay"] == [True, False]
    assert seen["kw"]["coeff"] == 0.5
    # no decay anywhere when the coefficient is 0
    opt0 = topt.AdamW(learning_rate=0.25, weight_decay=0.0,
                      parameters=[w, b])
    opt0.step()
    assert seen["decay"] == [False, False]
    sgd = topt.SGD(learning_rate=0.5, parameters=[w])
    sgd.step()
    assert seen["kind"] == fu.SGD and seen["step"].item() == 1.0


def test_adam_l2_decay_stays_in_the_grads():
    """Adam's L2 ``weight_decay`` is folded into the grads before the
    update (``_prepare_grads``), not into the kernel's decay flags."""
    w = torch.nn.Parameter(torch.full((3,), 2.0))
    opt = topt.Adam(learning_rate=0.1, parameters=[w], weight_decay=0.5)
    assert opt._decay_flags([w]) == [False]
    (w * 0).sum().backward()
    opt.step()
    # g = 0 + 0.5 * 2 = 1: Adam's first step moves by lr
    np.testing.assert_allclose(w.detach().numpy(), 1.9, rtol=1e-6)


def test_an_optimizer_with_its_own_update_prepares_no_table(monkeypatch):
    """A subclass that overrides ``_update`` and leaves ``_KIND`` None
    (one accumulator, as a momentum optimizer has) builds no fused table
    before a capture, and its own update still runs."""

    def refuse(*args, **kwargs):
        raise AssertionError("fused_update.prepare called")

    class Heavy(topt.Optimizer):
        _STATE_NAMES = ["velocity"]

        def _update(self, lr, params, grads, states, step, skip=None,
                    group=0):
            for p, g, v in zip(params, grads, states[0]):
                v.mul_(0.9).add_(g)
                p.sub_(lr * v)

    monkeypatch.setattr(fu, "prepare", refuse)
    w = torch.nn.Parameter(torch.ones(3))
    opt = Heavy(learning_rate=0.5, parameters=[w])
    opt._prepare_update([w])
    w.sum().backward()
    opt.step()
    np.testing.assert_allclose(w.detach().numpy(), 0.5, rtol=1e-6)


# -- the later rules on the card (gpu-marked: they skip without a card) -------

# the later rules' constants, as the optimizers pass them
CARD_RULES = {
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
CARD_GROUPS = {"f32": (torch.float32, torch.float32),
               "f16": (torch.float16, torch.float16),
               "bf16": (torch.bfloat16, torch.bfloat16),
               "f16_f32": (torch.float16, torch.float32),
               "bf16_f32": (torch.bfloat16, torch.float32)}
# Lamb's trust ratio: the kernel sums its norms a chunk at a time (f32
# partials, an f64 total), the plain version in one f64 reduction; the
# ratio agrees to ~1e-7, so p may differ by that share of its step on top
# of one output rounding (1e-5 of the step bounds it)
LAMB_STEP_RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def card_bound(want, mant):
    if mant is None:
        return 1e-6 * want.abs() + 1e-30
    return torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -24))) - mant)


def card_close(got, want, what, old=None):
    """16-bit within one ulp of the plain version's, f32 within 1e-6;
    with ``old`` (Lamb's p before the step) also LAMB_STEP_RTOL of the
    step."""
    mant = None if got.dtype == torch.float32 else MANT[got.dtype]
    got, want = got.float(), want.float()
    bound = card_bound(want, mant)
    if old is not None:
        bound = bound + LAMB_STEP_RTOL * (want - old.float()).abs()
    bad = (got - want).abs() > bound
    assert not bad.any(), f"{what}: {int(bad.sum())} elements off"


def rule_case(device, kind, p_dtype, m_dtype, sizes, seed=0):
    """Two identical sets (kernel, plain) of params (the second an odd
    view, so its addresses are not 16-byte aligned), grads and the rule's
    states, U(1e-4, 1.1e-3) (positive, so centered RMSProp's a - c^2
    stays positive and Rprop's sizes are sizes)."""
    g = torch.Generator().manual_seed(seed)
    n = fu.N_STATES[kind]
    vals = [(torch.randn(s, generator=g), 0.1 * torch.randn(s, generator=g),
             [1e-4 + 1e-3 * torch.rand(s, generator=g) for _ in range(n)])
            for s in sizes]
    out = []
    for _ in range(2):
        ps, gs, st = [], [], [[] for _ in range(3)]
        for i, (p, gr, ms) in enumerate(vals):
            if i == 1:
                pb = torch.zeros(p.numel() + 1, dtype=p_dtype, device=device)
                gb = torch.zeros_like(pb)
                pb[1:].copy_(p)
                gb[1:].copy_(gr)
                ps.append(pb[1:])
                gs.append(gb[1:])
            else:
                ps.append(p.to(device, p_dtype))
                gs.append(gr.to(device, p_dtype))
            for j, m in enumerate(ms):
                st[j].append(m.to(device, m_dtype))
        out.append((ps, gs, [s if s else None for s in st]))
    return out


def call_rule(kind, case, decay, lr, step, kernel=True, **kw):
    ps, gs, (m1, m2, m3) = case
    f = fu.fused_update if kernel else fu.fused_update_ref
    f(kind, ps, gs, m1, m2, decay, lr, step, m3s=m3,
      **dict(CARD_RULES[kind], **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(CARD_RULES),
                         ids=[fu.RULES[k] for k in sorted(CARD_RULES)])
@pytest.mark.parametrize("group", sorted(CARD_GROUPS))
def test_rule_kernel_matches_plain_version(cuda_device, kind, group):
    """Odd sizes (1, 4099 as an unaligned view, 7, 4095, 65541: tails,
    chunk boundaries), three steps at steps 5, 6, 7 (RAdam's rectified
    branch from 6) with mixed decay flags: p and every state within one
    ulp (16-bit) or 1e-6 (f32) of the plain version's, Lamb's p also
    within LAMB_STEP_RTOL of its step; one launch a call (Lamb two)."""
    p_dtype, m_dtype = CARD_GROUPS[group]
    sizes = [1, 4099, 7, 4095, 65541]
    a, b = rule_case(cuda_device, kind, p_dtype, m_dtype, sizes)
    decay = [i % 2 == 0 for i in range(len(sizes))]
    cache = {}
    key = fu.count_key(kind)
    for step in (5, 6, 7):
        lr = torch.tensor(1e-2, device=cuda_device)
        st = torch.tensor(float(step), device=cuda_device)
        old = [p.clone() for p in b[0]]
        before = LAUNCH_COUNTS[key]
        call_rule(kind, a, decay, lr, st, cache=cache)
        assert LAUNCH_COUNTS[key] - before == (2 if kind == fu.LAMB else 1)
        call_rule(kind, b, decay, lr, st, kernel=False)
        torch.cuda.synchronize()
        for i in range(len(sizes)):
            card_close(a[0][i], b[0][i], f"p[{i}] step {step}",
                       old[i] if kind == fu.LAMB else None)
            # the next step starts from the same values on both sides
            a[0][i].copy_(b[0][i])
            for j in range(fu.N_STATES[kind]):
                card_close(a[2][j][i], b[2][j][i], f"m{j + 1}[{i}]")
                a[2][j][i].copy_(b[2][j][i])
    assert len(cache) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(CARD_RULES),
                         ids=[fu.RULES[k] for k in sorted(CARD_RULES)])
@pytest.mark.parametrize("group", ["f32", "bf16", "f16_f32"])
def test_rule_overflow_flag_on_the_card(cuda_device, kind, group):
    """The loss scaler's flag set: every p and state bitwise unchanged
    (both of Lamb's passes return first); clear: bitwise the null flag's
    result."""
    p_dtype, m_dtype = CARD_GROUPS[group]
    sizes = [1, 4099, 65541]
    a, c = rule_case(cuda_device, kind, p_dtype, m_dtype, sizes)
    decay = [True] * len(sizes)
    lr = torch.tensor(1e-2, device=cuda_device)
    st = torch.tensor(6.0, device=cuda_device)
    flag = torch.ones((), device=cuda_device)
    tensors = lambda t: t[0] + [m for s in t[2] if s for m in s]  # noqa: E731
    old = [x.clone() for x in tensors(a)]
    call_rule(kind, a, decay, lr, st, skip=flag)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(tensors(a), old))
    flag.zero_()
    call_rule(kind, a, decay, lr, st, skip=flag)
    call_rule(kind, c, decay, lr, st)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(c)))
    assert not torch.equal(a[0][2], old[2])


@pytest.mark.gpu
def test_lamb_reruns_bitwise_and_optimizers_step_on_the_card(cuda_device):
    """Lamb's two passes give the same bits from run to run (no atomics);
    each optimizer's step() on the card launches its rule."""
    a, b = rule_case(cuda_device, fu.LAMB, torch.bfloat16, torch.bfloat16,
                     [5 * 32768 + 11, 3])
    lr = torch.tensor(1e-2, device=cuda_device)
    st = torch.tensor(2.0, device=cuda_device)
    call_rule(fu.LAMB, a, [True, False], lr, st)
    call_rule(fu.LAMB, b, [True, False], lr, st)
    torch.cuda.synchronize()
    for x, y in zip(a[0] + a[2][0] + a[2][1], b[0] + b[2][0] + b[2][1]):
        assert torch.equal(x, y)
    cases = [(topt.Momentum, {}), (topt.Adagrad, {"learning_rate": 0.1}),
             (topt.Adamax, {}), (topt.RMSProp, {"learning_rate": 0.1}),
             (topt.Lamb, {}), (topt.Adadelta, {}), (topt.Rprop, {}),
             (topt.NAdam, {}), (topt.RAdam, {}), (topt.ASGD, {})]
    for cls, kw in cases:
        w = torch.nn.Parameter(torch.randn(300, device=cuda_device))
        opt = cls(parameters=[w], **kw)
        key = fu.count_key(opt._KIND)
        before = LAUNCH_COUNTS[key]
        w.grad = torch.randn(300, device=cuda_device)
        opt.step()
        torch.cuda.synchronize()
        assert LAUNCH_COUNTS[key] - before == (2 if cls is topt.Lamb else 1)
        assert torch.isfinite(w).all()
