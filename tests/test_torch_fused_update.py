"""The fused optimizer update's plain version and its wrapper
(``paddle_tpu_torch/ops/cuda/fused_update.py``) on the CPU.

The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py`` holds it to this plain version);
here the plain version is held to the update written out in float64
numpy, rounded once, and the optimizer's use of it is checked: lr and
step as 0-dim float32 tensors, AdamW's decay flags from
``apply_decay_param_fun``, nothing built for CPU tensors."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.ops.cuda import fused_update as fu

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
