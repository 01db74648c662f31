"""The port's flash attention (paddle_tpu_torch/ops/cuda/flash_attention.py
and nn/functional/attention.py) against the JAX package's Pallas kernels
run in interpret mode, on the same numpy inputs.

On the CPU the wrappers compute their plain versions, so these tests hold
the plain forward and backward (which the CUDA kernels are held to on the
card, tests/test_torch_cuda_kernels.py and chip_smoke.py) to the TPU
kernels ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` themselves."""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.nn.functional import attention as jfa
from paddle_tpu.ops.op import apply as japply
from paddle_tpu.ops.pallas import attention as pa
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
    flash_attention_fwd_ref)

# plain version vs the Pallas kernel.  float32: both f32 throughout, apart
# only in summation order (measured <= 2.4e-6 absolute on values of O(1)).
# bfloat16: same f32 sums, then one rounding of each output to bf16 — one
# bf16 ulp (2^-8 relative) apart at most, so 1e-2 of max(|ref|, 1).
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

CASES = [(s, d, causal, dt)
         for s, d in ((128, 16), (256, 64), (128, 256))
         for causal in (False, True)
         for dt in (torch.float32, torch.bfloat16)]
IDS = [f"s{s}-d{d}-{'causal' if c else 'full'}-{str(dt)[6:]}"
       for s, d, c, dt in CASES]


def inputs(s, d, heads=2, kv_heads=2, batch=1, seed=0):
    """q, k, v, dO as numpy f32 (B, H, S, D); k/v with kv_heads heads."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((batch, heads, s, d)).astype(np.float32)
    k = r.standard_normal((batch, kv_heads, s, d)).astype(np.float32)
    v = r.standard_normal((batch, kv_heads, s, d)).astype(np.float32)
    do = r.standard_normal((batch, heads, s, d)).astype(np.float32)
    return q, k, v, do


def to_np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def pallas_reference(s, d, causal, dt):
    """The Pallas kernels (interpret mode) on one case: out, lse (column
    0 of the lane-replicated lse), dq, dk, dv as f32 numpy."""
    q, k, v, do = (jnp.asarray(x, JNP[dt]) for x in inputs(s, d))
    scale = 1.0 / math.sqrt(d)
    out, lse = pa._flash_fwd(q, k, v, causal, scale, True)
    dq, dk, dv = pa._flash_bwd(q, k, v, out, lse[..., :1], do, causal,
                               scale, True)
    return tuple(to_np(x) for x in (out, lse[..., 0], dq, dk, dv))


def assert_close(got, want, dt, name):
    got = got.float().numpy()
    tol = TOL[dt]
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("s,d,causal,dt", CASES, ids=IDS)
def test_plain_forward_matches_pallas_fwd_kernel(s, d, causal, dt):
    q, k, v, _ = (torch.from_numpy(x).to(dt) for x in inputs(s, d))
    want_out, want_lse = pallas_reference(s, d, causal, dt)[:2]
    out, lse = flash_attention_fwd(q, k, v, causal)
    assert out.dtype == dt and lse.dtype == torch.float32
    assert lse.shape == (1, 2, s)
    assert_close(out, want_out, dt, "out")
    # lse is f32 in both: f32 tolerance whatever the input type
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,d,causal,dt", CASES, ids=IDS)
def test_plain_backward_matches_pallas_dq_dkv_kernels(s, d, causal, dt):
    """From the Pallas forward's own out and lse, so that only the backward
    is compared."""
    q, k, v, do = (torch.from_numpy(x).to(dt) for x in inputs(s, d))
    out, lse, *want = pallas_reference(s, d, causal, dt)
    got = flash_attention_bwd(q, k, v, torch.from_numpy(out).to(dt),
                              torch.from_numpy(lse), do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dt
        assert_close(g, w, dt, name)


def test_backward_pre_pass_delta_is_used_by_both_kernels():
    """``flash_bwd_delta`` is rowsum(dO * O) in f32 (against numpy in
    f64, 1e-5); dq and dk/dv given it through ``delta=`` equal the same
    wrappers computing it themselves, and equal the whole backward; a
    wrong delta changes dq and dk (not dv, which needs no delta)."""
    q, k, v, do = (torch.from_numpy(x) for x in inputs(128, 16, heads=4,
                                                       kv_heads=2))
    out, lse = flash_attention_fwd_ref(q, k, v, True)
    delta = fa.flash_bwd_delta(out, do)
    want = (do.double() * out.double()).sum(-1)
    assert delta.dtype == torch.float32 and delta.shape == lse.shape
    np.testing.assert_allclose(delta.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    dq = fa.flash_attention_dq(q, k, v, out, lse, do, True, delta=delta)
    dk, dv = fa.flash_attention_dkv(q, k, v, out, lse, do, True,
                                    delta=delta)
    for got, ref in zip((dq, dk, dv),
                        flash_attention_bwd(q, k, v, out, lse, do, True)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert torch.equal(dq, fa.flash_attention_dq(q, k, v, out, lse, do,
                                                 True))
    bad_dq = fa.flash_attention_dq(q, k, v, out, lse, do, True,
                                   delta=delta + 1.0)
    bad_dk, bad_dv = fa.flash_attention_dkv(q, k, v, out, lse, do, True,
                                            delta=delta + 1.0)
    assert not torch.allclose(bad_dq, dq) and not torch.allclose(bad_dk, dk)
    torch.testing.assert_close(bad_dv, dv, rtol=0, atol=0)
    with pytest.raises(ValueError, match="delta must be float32"):
        fa.flash_attention_dq(q, k, v, out, lse, do, True,
                              delta=delta.double())


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 20),
                                     (torch.float32, 18)])
def test_pre_pass_refuses_rows_it_cannot_read_in_16_byte_vectors(dtype, d):
    """The delta kernel reads each row in 16-byte vectors, so its wrapper
    refuses a head_dim that is not a multiple of 8 (16-bit) or 4 (f32), on
    the CPU as on the card."""
    o = torch.zeros(2, 16, d, dtype=dtype)
    with pytest.raises(ValueError, match=f"head_dim {d} is not supported"):
        fa.flash_bwd_delta(o, o)


def test_plain_backward_is_not_autograd_of_the_forward():
    """The backward reads lse: a wrong lse gives wrong gradients (autograd
    of the forward would not notice)."""
    q, k, v, do = (torch.from_numpy(x) for x in inputs(128, 16))
    out, lse = flash_attention_fwd_ref(q, k, v, True)
    good = flash_attention_bwd_ref(q, k, v, out, lse, do, True)
    bad = flash_attention_bwd_ref(q, k, v, out, lse + 1.0, do, True)
    assert not torch.allclose(good[0], bad[0])


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The reference's flash_sdpa runs its Pallas kernels in interpret
    mode; monkeypatch puts the module flag back after the test."""
    monkeypatch.setattr(jfa, "_PALLAS_INTERPRET", True)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_sdpa_autograd_matches_reference_vjp_gqa(pallas_interpret,
                                                       causal):
    """(B, S, H, D) layout, 4 query heads over 2 kv heads: the port's
    dk/dv kernel sums each group itself, the reference repeats K/V and sums
    afterwards.  f32; outputs and grads within 1e-5."""
    s, d = 128, 16
    q, k, v, do = (np.swapaxes(x, 1, 2) for x in
                   inputs(s, d, heads=4, kv_heads=2, batch=2, seed=3))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = (paddle.to_tensor(x, stop_gradient=False)
                  for x in (q, k, v))
    jout, _ = japply("flash_sdpa", jq, jk, jv, scale=scale,
                     is_causal=causal)
    (jout * paddle.to_tensor(do)).sum().backward()
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = F.flash_sdpa(tq, tk, tv, scale, causal)
    assert out.shape == (2, s, 4, d) and lse.shape == (2, 4, s)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), jout.numpy(),
                               rtol=1e-5, atol=1e-5)
    for name, t, j in (("dq", tq, jq), ("dk", tk, jk), ("dv", tv, jv)):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad.numpy()),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_sdpa_dispatch_takes_flash_without_mask_or_dropout(monkeypatch):
    """No mask and no dropout: flash_sdpa at any length (no seq >= 1024
    gate); a mask or training dropout: the plain sdpa.  On the CPU the
    Function runs the plain versions, so no kernel launch is counted."""
    calls = []
    real = F.attention.flash_sdpa
    monkeypatch.setattr(F.attention, "flash_sdpa",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q, k, v, _ = (torch.from_numpy(np.swapaxes(x, 1, 2))
                  for x in inputs(16, 16, heads=4, kv_heads=2))
    before = dict(LAUNCH_COUNTS)
    flash = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert calls == [1]
    mask = torch.ones(16, 16, dtype=torch.bool).tril()
    plain = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    with torch.random.fork_rng():      # dropout draws from torch's RNG
        F.scaled_dot_product_attention(q, k, v, dropout_p=0.5,
                                       is_causal=True)
    F.scaled_dot_product_attention(q, k, v, dropout_p=0.5, is_causal=True,
                                   training=False)
    assert calls == [1, 1]
    # the causal mask as a bool mask gives the same attention
    torch.testing.assert_close(flash, plain, rtol=1e-5, atol=1e-5)
    assert LAUNCH_COUNTS == before


def test_plain_sdpa_matches_reference_sdpa_with_mask():
    """The plain path behind masks (additive float mask, GQA) against the
    reference's ``sdpa`` op; f32 within 1e-5."""
    q, k, v, _ = (np.swapaxes(x, 1, 2)
                  for x in inputs(24, 16, heads=4, kv_heads=2, seed=5))
    mask = np.random.default_rng(6).standard_normal((1, 1, 24, 24)) \
        .astype(np.float32)
    want = japply("sdpa", *(paddle.to_tensor(x) for x in (q, k, v, mask)),
                  scale=0.25, is_causal=True).numpy()
    got = F.sdpa(*(torch.from_numpy(x) for x in (q, k, v, mask)), scale=0.25,
                 is_causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad,match", [
    (dict(d=24), "multiple of 16 up to 256"),
    (dict(d=272), "multiple of 16 up to 256"),
    (dict(kv_heads=3), "multiple of kv heads"),
    (dict(causal_sk=8), "Sq == Sk"),
    (dict(dtype=torch.float64), "unsupported dtype"),
])
def test_wrappers_refuse_what_the_kernels_cannot_take(bad, match):
    d = bad.get("d", 16)
    q = torch.zeros(1, 4, 16, d, dtype=bad.get("dtype", torch.float32))
    k = torch.zeros(1, bad.get("kv_heads", 2), bad.get("causal_sk", 16), d,
                    dtype=q.dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        flash_attention_fwd(q, k, k, causal=True)
    with pytest.raises((ValueError, TypeError), match=match):
        flash_attention_bwd(q, k, k, q, torch.zeros(1, 4, 16), q,
                            causal=True)


def test_ragged_length_and_single_row_on_the_plain_path():
    """Any S (the reference needs S % 128 == 0): S = 1 and S = 200, causal,
    against plain softmax attention in f64."""
    for s in (1, 200):
        q, k, v, do = (torch.from_numpy(x) for x in inputs(s, 16))
        out, lse = flash_attention_fwd(q, k, v, True)
        qd, kd, vd = (x.double().requires_grad_() for x in (q, k, v))
        sc = (qd @ kd.transpose(-1, -2)) / 4.0
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                            float("-inf"))
        ref = torch.softmax(sc, -1) @ vd
        ref.backward(do.double())
        torch.testing.assert_close(out.double(), ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lse.double(), torch.logsumexp(sc, -1),
                                   rtol=1e-5, atol=1e-5)
        grads = flash_attention_bwd(q, k, v, out, lse, do, True)
        for g, t in zip(grads, (qd, kd, vd)):
            torch.testing.assert_close(g.double(), t.grad, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("scale", [0.0, None], ids=["zero", "none"])
def test_falsy_scale_means_the_default_as_in_the_reference(scale):
    """The reference's ``flash_attention_bhsd`` (and its VJP) reads ``scale
    or 1 / sqrt(d)``: scale=0.0 is the default there, and so in the dense
    wrappers here, forward and backward."""
    s, d = 128, 16
    q, k, v, do = inputs(s, d)
    out, vjp = jax.vjp(
        lambda a, b, c: pa.flash_attention_bhsd(a, b, c, True, scale, True),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = [to_np(out)] + [to_np(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    got, lse = flash_attention_fwd(tq, tk, tv, True, scale)
    grads = flash_attention_bwd(tq, tk, tv, got, lse, tdo, True, scale)
    for name, g, w in zip(("out", "dq", "dk", "dv"), (got, *grads), want):
        assert_close(g, w, torch.float32, name)
