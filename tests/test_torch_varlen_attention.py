"""The port's packed-sequence (varlen) and ragged-length flash attention
(paddle_tpu_torch/ops/cuda/flash_attention.py, nn/functional/attention.py)
against the JAX package on the same numpy inputs.

On the CPU the wrappers compute their plain versions, so these tests hold
the plain varlen forward, dq and dk/dv and the plain ragged forward (which
the CUDA kernels are held to on the card, tests/test_torch_cuda_kernels.py
and chip_smoke.py) to the TPU kernels ``_varlen_fwd_kernel``,
``_varlen_dq_kernel``, ``_varlen_dkv_kernel`` and ``_ragged_fwd_kernel``
run in interpret mode, and the port's ``flash_attn_unpadded`` to the
reference's.  They pin two behaviours of the reference that its prose
does not state (ROADMAP queue C): the ragged kernel's rows at or past the
length are not zeros, and a tail of tokens past ``cu_seqlens[-1]`` is a
segment of its own (the dense core; the reference's Pallas path pads it
into one segment with zero keys).

The reference's module flag ``_PALLAS_INTERPRET`` is set only through
``monkeypatch``; nothing here seeds the reference's global key or runs its
dropout path."""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.functional import attention as jfa
from paddle_tpu.ops.pallas import attention as pa
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS
from paddle_tpu_torch.ops.cuda import flash_attention as fa

# plain version vs the Pallas kernel (test_torch_flash_attention.py's
# tolerances).  float32: both f32 throughout, apart only in summation
# order.  bfloat16: the same f32 sums, then one rounding of each output to
# bf16 (and, with GQA, the reference rounds each head's dk/dv before the
# group sum), so 1e-2 of max(|ref|, 1).
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def to_np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, dt, name):
    tol = TOL[dt]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=name)


def packed(t, d, heads, kv_heads, seed=0):
    """q, k, v, dO as numpy f32 (H, T, D); k/v with kv_heads heads."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((heads, t, d)).astype(np.float32)
    k = r.standard_normal((kv_heads, t, d)).astype(np.float32)
    v = r.standard_normal((kv_heads, t, d)).astype(np.float32)
    do = r.standard_normal((heads, t, d)).astype(np.float32)
    return q, k, v, do


# (T, D, H, Hkv, cu): the reference kernels need T % 128 == 0 and equal
# heads (its op repeats kv heads; done here on the JAX side)
VARLEN = {
    "t256-d16": (256, 16, 2, 2, (0, 100, 256)),
    "t384-d64-gqa": (384, 64, 4, 2, (0, 1, 129, 300, 384)),
    "t256-d16-tail": (256, 16, 2, 2, (0, 100, 200)),
}
VARLEN_CASES = [(name, causal, dt)
                for name in VARLEN
                for causal in (False, True)
                for dt in (torch.float32, torch.bfloat16)
                if name != "t256-d16-tail" or dt == torch.float32]
VARLEN_IDS = [f"{n}-{'causal' if c else 'full'}-{str(dt)[6:]}"
              for n, c, dt in VARLEN_CASES]


@functools.lru_cache(maxsize=None)
def varlen_pallas(name, causal, dt):
    """The reference's varlen kernels (interpret mode): out, lse (column
    0), dq, dk, dv as f32 numpy; dk/dv summed over each kv group."""
    t, d, h, hkv, cu = VARLEN[name]
    q, k, v, do = (jnp.asarray(x, JNP[dt]) for x in packed(t, d, h, hkv))
    rep = h // hkv
    k, v = jnp.repeat(k, rep, axis=0), jnp.repeat(v, rep, axis=0)
    cu = jnp.asarray(cu, jnp.int32)
    scale = 1.0 / math.sqrt(d)
    out, lse = pa._varlen_flash_fwd(q, k, v, cu, causal, scale, True)
    dq, dk, dv = pa._varlen_flash_bwd(q, k, v, cu, out, lse[..., :1], do,
                                      causal, scale, True)
    dk, dv = (to_np(x).reshape(hkv, rep, t, d).sum(axis=1) for x in (dk, dv))
    return to_np(out), to_np(lse[..., 0]), to_np(dq), dk, dv


def varlen_inputs(name, dt):
    t, d, h, hkv, cu = VARLEN[name]
    q, k, v, do = (torch.from_numpy(x).to(dt) for x in packed(t, d, h, hkv))
    return q, k, v, do, torch.tensor(cu, dtype=torch.int32)


@pytest.mark.parametrize("name,causal,dt", VARLEN_CASES, ids=VARLEN_IDS)
def test_plain_varlen_forward_matches_pallas_varlen_fwd_kernel(name, causal,
                                                               dt):
    q, k, v, _, cu = varlen_inputs(name, dt)
    want_out, want_lse = varlen_pallas(name, causal, dt)[:2]
    out, lse = fa.varlen_flash_fwd_ref(q, k, v, cu, causal)
    assert out.dtype == dt and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    assert_close(out, want_out, dt, "out")
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,causal,dt", VARLEN_CASES, ids=VARLEN_IDS)
def test_plain_varlen_backward_matches_pallas_dq_dkv_kernels(name, causal,
                                                             dt):
    """From the Pallas forward's own out and lse, so that only the
    backward is compared; GQA dk/dv come back with the kv heads' shape."""
    q, k, v, do, cu = varlen_inputs(name, dt)
    out, lse, *want = varlen_pallas(name, causal, dt)
    out, lse = torch.from_numpy(out).to(dt), torch.from_numpy(lse)
    dq = fa.varlen_flash_dq_ref(q, k, v, cu, out, lse, do, causal)
    dk, dv = fa.varlen_flash_dkv_ref(q, k, v, cu, out, lse, do, causal)
    assert dk.shape == k.shape and dv.shape == v.shape
    for nm, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.dtype == dt
        assert_close(g, w, dt, nm)


def test_varlen_wrappers_on_the_cpu_are_the_plain_versions():
    q, k, v, do, cu = varlen_inputs("t384-d64-gqa", torch.float32)
    before = dict(LAUNCH_COUNTS)
    out, lse = fa.varlen_flash_fwd(q, k, v, cu, True)
    ro, rl = fa.varlen_flash_fwd_ref(q, k, v, cu, True)
    assert torch.equal(out, ro) and torch.equal(lse, rl)
    got = fa.varlen_flash_bwd(q, k, v, cu, out, lse, do, True)
    want = fa.varlen_flash_bwd_ref(q, k, v, cu, out, lse, do, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert LAUNCH_COUNTS == before



def test_varlen_backward_takes_the_pre_pass_delta():
    """The packed (H, T) delta of ``flash_bwd_delta`` given to the varlen
    dq and dk/dv through ``delta=`` gives the whole backward's gradients
    exactly (both plain versions on the CPU)."""
    q, k, v, do, cu = varlen_inputs("t384-d64-gqa", torch.float32)
    out, lse = fa.varlen_flash_fwd(q, k, v, cu, True)
    delta = fa.flash_bwd_delta(out, do)
    assert delta.shape == lse.shape == (q.shape[0], q.shape[1])
    got = (fa.varlen_flash_dq(q, k, v, cu, out, lse, do, True, delta=delta),
           *fa.varlen_flash_dkv(q, k, v, cu, out, lse, do, True,
                                delta=delta))
    want = fa.varlen_flash_bwd(q, k, v, cu, out, lse, do, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="delta must be float32"):
        fa.varlen_flash_dq(q, k, v, cu, out, lse, do, True,
                           delta=delta[:, :-1])


# (B, H, Sq, Sk, D, kv_lens): a length inside the last tile, a length of 0,
# a full row, a length of 1, and a rectangular non-causal case
RAGGED = {
    "s128-d16": (3, 2, 128, 128, 16, (100, 0, 128)),
    "s256-d64": (3, 2, 256, 256, 64, (256, 129, 1)),
    "rect-d16": (3, 2, 128, 256, 16, (200, 256, 3)),
}
RAGGED_CASES = [("s128-d16", c, dt) for c in (False, True)
                for dt in (torch.float32, torch.bfloat16)] + \
    [("s256-d64", True, torch.float32), ("rect-d16", False, torch.float32)]
RAGGED_IDS = [f"{n}-{'causal' if c else 'full'}-{str(dt)[6:]}"
              for n, c, dt in RAGGED_CASES]


def ragged_inputs(name, seed=1):
    b, h, sq, sk, d, lens = RAGGED[name]
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, sq, d)).astype(np.float32)
    k = r.standard_normal((b, h, sk, d)).astype(np.float32)
    v = r.standard_normal((b, h, sk, d)).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


@functools.lru_cache(maxsize=None)
def ragged_pallas(name, causal, dt):
    q, k, v, lens = ragged_inputs(name)
    out = pa.flash_attention_ragged_bhsd(
        *(jnp.asarray(x, JNP[dt]) for x in (q, k, v)), jnp.asarray(lens),
        causal, interpret=True)
    return to_np(out)


@pytest.mark.parametrize("name,causal,dt", RAGGED_CASES, ids=RAGGED_IDS)
def test_plain_ragged_forward_matches_pallas_ragged_kernel(name, causal, dt):
    """Every row, those at or past the length included."""
    q, k, v, lens = ragged_inputs(name)
    got = fa.flash_attention_ragged_bhsd_ref(
        *(torch.from_numpy(x).to(dt) for x in (q, k, v)),
        torch.from_numpy(lens), causal)
    assert got.dtype == dt and got.shape == q.shape
    assert_close(got, ragged_pallas(name, causal, dt), dt, "out")


@pytest.mark.parametrize("scale", [0.0, None], ids=["zero", "none"])
def test_ragged_falsy_scale_means_the_default_as_in_the_reference(scale):
    """The reference's ``flash_attention_ragged_bhsd`` reads ``scale or
    1 / sqrt(d)``: scale=0.0 is the default there, and so here."""
    q, k, v, lens = ragged_inputs("s128-d16")
    want = to_np(pa.flash_attention_ragged_bhsd(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(lens), True,
        scale, interpret=True))
    assert_close(torch.from_numpy(want), ragged_pallas(
        "s128-d16", True, torch.float32), torch.float32, "default")
    got = fa.flash_attention_ragged_bhsd(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(lens),
        True, scale)
    assert_close(got, want, torch.float32, "out")


def test_varlen_scale_zero_passes_through_as_in_the_reference():
    """The reference's varlen path passes the functional's scale through
    as it is: scale=0.0 gives uniform attention over each segment there,
    and here (only None means 1 / sqrt(d))."""
    t, d, h, hkv, cu = VARLEN["t256-d16"]
    q, k, v, _ = packed(t, d, h, hkv)
    out, lse = pa._varlen_flash_fwd(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(cu, jnp.int32),
        False, 0.0, True)
    got, got_lse = fa.varlen_flash_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.tensor(cu, dtype=torch.int32), False, 0.0)
    assert_close(got, to_np(out), torch.float32, "out")
    assert_close(got_lse, to_np(lse[..., 0]), torch.float32, "lse")
    seg = v[:, :cu[1]].mean(axis=1)              # uniform over segment 0
    np.testing.assert_allclose(got[:, 0].numpy(), seg, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ragged_rows_past_the_length_are_not_zeros(causal):
    """The reference's docstring (and an earlier ROADMAP) says rows at or
    past the length emit zeros; its kernel's mask is ``cols < length``
    (and ``cols <= rows``), so those rows attend to all ``length`` keys.
    Pinned on the Pallas kernel and on the port's wrapper: only a length
    of 0 gives zeros, and a row past the length equals plain softmax
    attention over keys [0, length) in f64."""
    q, k, v, lens = ragged_inputs("s128-d16")
    want = ragged_pallas("s128-d16", causal, torch.float32)
    got = fa.flash_attention_ragged_bhsd(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(lens),
        causal).numpy()
    n = int(lens[0])                              # 100 of 128
    assert np.abs(want[0, :, n:]).max() > 0.1
    assert np.abs(got[0, :, n:]).max() > 0.1
    assert not want[1].any() and not got[1].any()  # length 0
    qd, kd, vd = (torch.from_numpy(x[0]).double() for x in (q, k, v))
    sc = qd[:, n:] @ kd[:, :n].transpose(-1, -2) / 4.0
    ref = (torch.softmax(sc, -1) @ vd[:, :n]).numpy()
    np.testing.assert_allclose(got[0, :, n:], ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(want[0, :, n:], ref, rtol=1e-5, atol=1e-5)


# -- the public function ----------------------------------------------------

def unpadded_inputs(t, h, hkv, d, seed=2):
    """(T, H, D) q, dO and (T, Hkv, D) k, v as numpy f32."""
    q, k, v, do = packed(t, d, h, hkv, seed)
    return tuple(np.ascontiguousarray(np.swapaxes(x, 0, 1))
                 for x in (q, k, v, do))


def reference_unpadded(q, k, v, do, cu, causal, scale, dtype=jnp.float32):
    """The reference's F.flash_attn_unpadded forward and .backward(): out,
    dq, dk, dv as f32 numpy."""
    jq, jk, jv = (paddle.to_tensor(jnp.asarray(x, dtype), stop_gradient=False)
                  for x in (q, k, v))
    jcu = paddle.to_tensor(np.asarray(cu, np.int32))
    out, sm = JF.flash_attn_unpadded(jq, jk, jv, jcu, jcu, 0, 0, scale,
                                     causal=causal)
    assert sm is None
    (out * paddle.to_tensor(jnp.asarray(do, dtype))).sum().backward()
    return tuple(to_np(x._array if hasattr(x, "_array") else x.numpy())
                 for x in (out, jq.grad, jk.grad, jv.grad))


def port_unpadded(q, k, v, do, cu, causal, scale, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    tcu = torch.tensor(cu, dtype=torch.int32)
    out, sm = F.flash_attn_unpadded(tq, tk, tv, tcu, tcu, 0, 0, scale,
                                    causal=causal)
    assert sm is None and out.shape == tq.shape and out.dtype == dtype
    out.backward(torch.from_numpy(do).to(dtype))
    return out.detach(), tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("interpret", [True, False],
                         ids=["pallas", "dense"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attn_unpadded_matches_reference_f32(monkeypatch, interpret,
                                                   causal):
    """T = 200 (the reference's Pallas path pads it to 256), 4 query heads
    over 2 kv heads, three documents ending at T; outputs and q/k/v grads
    within 1e-5, with the reference on its Pallas path and on its dense
    core."""
    monkeypatch.setattr(jfa, "_PALLAS_INTERPRET", interpret)
    q, k, v, do = unpadded_inputs(200, 4, 2, 16)
    cu, scale = (0, 37, 120, 200), 0.25
    want = reference_unpadded(q, k, v, do, cu, causal, scale)
    got = port_unpadded(q, k, v, do, cu, causal, scale)
    for nm, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, nm
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=nm)


def test_flash_attn_unpadded_matches_reference_pallas_bf16(monkeypatch):
    monkeypatch.setattr(jfa, "_PALLAS_INTERPRET", True)
    q, k, v, do = unpadded_inputs(256, 2, 2, 64, seed=3)
    cu, scale = (0, 64, 65, 256), 0.125
    want = reference_unpadded(q, k, v, do, cu, True, scale, jnp.bfloat16)
    got = port_unpadded(q, k, v, do, cu, True, scale, torch.bfloat16)
    for nm, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert_close(g, w, torch.bfloat16, nm)


def test_documents_do_not_see_each_other():
    """Changing every token of one document changes no output or gradient
    of the others, and each document's output and gradients equal dense
    flash_sdpa on that document alone."""
    t, h, hkv, d = 96, 4, 2, 16
    cu = (0, 30, 31, 70, 96)
    q, k, v, do = unpadded_inputs(t, h, hkv, d, seed=4)
    base = port_unpadded(q, k, v, do, cu, True, 0.25)
    q2, k2, v2 = (x.copy() for x in (q, k, v))
    for x in (q2, k2, v2):
        x[31:70] = np.random.default_rng(5).standard_normal(x[31:70].shape)
    moved = port_unpadded(q2, k2, v2, do, cu, True, 0.25)
    others = np.r_[0:31, 70:96]
    for a, b in zip(base, moved):
        assert torch.equal(a[others], b[others])
        assert not torch.equal(a[31:70], b[31:70])
    for lo, hi in zip(cu[:-1], cu[1:]):
        xs = [torch.from_numpy(x[lo:hi][None]).requires_grad_()
              for x in (q, k, v)]
        out, _ = F.flash_sdpa(*xs, 0.25, True)
        out.backward(torch.from_numpy(do[lo:hi][None]))
        for a, b in zip(base, [out.detach()] + [x.grad for x in xs]):
            torch.testing.assert_close(a[lo:hi], b[0], rtol=1e-5, atol=1e-5)


def test_tail_past_the_last_cu_is_a_segment_of_its_own(monkeypatch):
    """T = 250 with cu = [0, 100, 200], non-causal: the port follows the
    reference's dense core on every row.  The reference's Pallas path pads
    T to 256 and makes tail and pad one segment, so its tail rows also
    see six zero keys: rows below 200 agree, rows 200-249 do not.  Under
    causal the pad keys come after every tail row and all three agree."""
    q, k, v, do = unpadded_inputs(250, 2, 2, 16, seed=6)
    cu, scale = (0, 100, 200), 0.25
    for causal in (False, True):
        got = port_unpadded(q, k, v, do, cu, causal, scale)[0].numpy()
        monkeypatch.setattr(jfa, "_PALLAS_INTERPRET", False)
        dense = reference_unpadded(q, k, v, do, cu, causal, scale)[0]
        monkeypatch.setattr(jfa, "_PALLAS_INTERPRET", True)
        pallas = reference_unpadded(q, k, v, do, cu, causal, scale)[0]
        np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[:200], pallas[:200], rtol=1e-5,
                                   atol=1e-5)
        tail_gap = np.abs(got[200:] - pallas[200:]).max()
        assert (tail_gap > 1e-3) if not causal else (tail_gap < 1e-5)


def test_cross_packing_takes_the_dense_core(monkeypatch):
    """cu_seqlens_q != cu_seqlens_k (q and k/v packed differently) is not
    the kernels' case: the port, like the reference, takes the dense core,
    and agrees with the reference's in outputs and grads.  Two cu tensors
    with equal values still take the kernels' Function."""
    calls = []
    real = F.attention._FlashVarlen.apply
    monkeypatch.setattr(F.attention._FlashVarlen, "apply",
                        lambda *a: calls.append(1) or real(*a))
    r = np.random.default_rng(7)
    q = r.standard_normal((30, 4, 16)).astype(np.float32)
    k, v = (r.standard_normal((40, 2, 16)).astype(np.float32)
            for _ in range(2))
    do = r.standard_normal((30, 4, 16)).astype(np.float32)
    cu_q, cu_k = np.array([0, 10, 30], np.int32), np.array([0, 22, 40],
                                                           np.int32)
    for causal in (False, True):
        jq, jk, jv = (paddle.to_tensor(x, stop_gradient=False)
                      for x in (q, k, v))
        jout, _ = JF.flash_attn_unpadded(jq, jk, jv, paddle.to_tensor(cu_q),
                                         paddle.to_tensor(cu_k), 0, 0, 0.25,
                                         causal=causal)
        (jout * paddle.to_tensor(do)).sum().backward()
        tq, tk, tv = (torch.from_numpy(x).requires_grad_()
                      for x in (q, k, v))
        out, _ = F.flash_attn_unpadded(tq, tk, tv, torch.from_numpy(cu_q),
                                       torch.from_numpy(cu_k), 0, 0, 0.25,
                                       causal=causal)
        out.backward(torch.from_numpy(do))
        for nm, g, j in (("out", out.detach(), jout), ("dq", tq.grad, jq.grad),
                         ("dk", tk.grad, jk.grad), ("dv", tv.grad, jv.grad)):
            np.testing.assert_allclose(g.numpy(), np.asarray(j.numpy()),
                                       rtol=1e-5, atol=1e-5, err_msg=nm)
    assert calls == []
    qq = torch.from_numpy(q)
    F.flash_attn_unpadded(qq, qq, qq, torch.tensor([0, 30]),
                          torch.tensor([0, 30]), 0, 0, 0.25)
    assert calls == [1]


def test_dropout_takes_the_dense_core_and_drops_probabilities():
    """Training dropout takes ``_varlen_core`` with torch's generator
    (never compared draw for draw with the reference's): with one-hot
    values each output is a row of probabilities, so every entry is either
    dropped (0) or kept and scaled by 1 / (1 - p), and about p of the
    visible ones are dropped.  Not training, or p = 0, is the flash path's
    output."""
    t, h, p = 64, 2, 0.5
    r = np.random.default_rng(8)
    q, k = (torch.from_numpy(r.standard_normal((t, h, t))
                             .astype(np.float32)) for _ in range(2))
    v = torch.eye(t).reshape(t, 1, t).expand(t, h, t).contiguous()
    cu = torch.tensor([0, 40, 64], dtype=torch.int32)
    probs, _ = F.flash_attn_unpadded(q, k, v, cu, cu, 0, 0, 0.125,
                                     causal=True)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        dropped, _ = F.flash_attn_unpadded(q, k, v, cu, cu, 0, 0, 0.125,
                                           dropout=p, causal=True)
    kept = dropped != 0
    np.testing.assert_allclose(dropped[kept].numpy(),
                               probs[kept].numpy() / (1 - p), rtol=1e-5)
    visible = probs > 0
    assert not bool((kept & ~visible).any())
    share = 1 - kept[visible].float().mean().item()
    assert abs(share - p) < 0.05, share          # 3-sigma ~ 0.02 here
    for kw in (dict(dropout=p, training=False), dict(dropout=0.0)):
        same, _ = F.flash_attn_unpadded(q, k, v, cu, cu, 0, 0, 0.125,
                                        causal=True, **kw)
        assert torch.equal(same, probs)


def test_flash_attention_shim_and_sdp_kernel(monkeypatch):
    """``flash_attention`` is scaled_dot_product_attention returning
    (out, None), as in the reference; ``sdp_kernel`` selects nothing."""
    monkeypatch.setattr(jfa, "_PALLAS_INTERPRET", False)
    r = np.random.default_rng(9)
    q, k, v = (r.standard_normal((2, 24, 4, 16)).astype(np.float32)
               for _ in range(3))
    want, wsm = JF.flash_attention(*(paddle.to_tensor(x) for x in (q, k, v)),
                                   causal=True)
    with F.sdp_kernel(enable_math=False):
        got, sm = F.flash_attention(*(torch.from_numpy(x)
                                      for x in (q, k, v)), causal=True)
    assert sm is None and wsm is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("call,match", [
    (lambda q, k, cu: fa.varlen_flash_fwd(q[0], k, k, cu), "(H, T, D)"),
    (lambda q, k, cu: fa.varlen_flash_fwd(q, k[:, :8], k[:, :8], cu),
     "same T"),
    (lambda q, k, cu: fa.varlen_flash_fwd(q, k, k, cu.float()),
     "1-D int32/int64"),
    (lambda q, k, cu: fa.varlen_flash_fwd(q, q[:3], q[:3], cu),
     "multiple of kv heads"),
    (lambda q, k, cu: fa.varlen_flash_fwd(q[..., :8], k[..., :8],
                                          k[..., :8], cu),
     "multiple of 16 up to 256"),
    (lambda q, k, cu: fa.varlen_flash_dq(q, k, k, cu, q, torch.zeros(4, 3),
                                         q), "lse must be float32"),
    (lambda q, k, cu: fa.flash_attention_ragged_bhsd(
        q[None], k[None], k[None], torch.tensor([16])), "head count"),
    (lambda q, k, cu: fa.flash_attention_ragged_bhsd(
        q[None], q[None], q[None], torch.tensor([16, 16])), "shape"),
    (lambda q, k, cu: fa.flash_attention_ragged_bhsd(
        q[None], q[None, :, :8], q[None, :, :8], torch.tensor([8])),
     "Sq == Sk"),
], ids=["varlen_rank", "varlen_t", "varlen_cu_dtype", "varlen_heads",
        "varlen_head_dim", "varlen_lse", "ragged_heads", "ragged_lens",
        "ragged_causal_rect"])
def test_varlen_and_ragged_wrappers_refuse_what_the_kernels_cannot_take(
        call, match):
    q = torch.zeros(4, 16, 16)
    k = torch.zeros(2, 16, 16)
    cu = torch.tensor([0, 16], dtype=torch.int32)
    with pytest.raises((ValueError, TypeError), match=match):
        call(q, k, cu)
