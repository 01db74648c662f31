"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither jax nor paddle_tpu, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Without a CUDA device every test here skips (decided in a fixture)."""

import importlib
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.functional import (ROUTE_COUNTS,
                                            flash_attn_unpadded,
                                            reset_route_counts,
                                            scaled_dot_product_attention,
                                            sdpa)
from paddle_tpu_torch.ops.cuda import attention as rpa
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda.attention import (
    LAUNCH_COUNTS, ragged_paged_attention_decode,
    ragged_paged_attention_decode_ref)
from paddle_tpu_torch.ops.cuda.quant_matmul import (qmm_route, quant_matmul,
                                                    quant_matmul_ref)
from paddle_tpu_torch.quantize.core import (quantize_kv_rows,
                                            quantize_weight)

# kernel vs plain version, both f32 inside: f32 differs by summation
# order; f16/bf16 outputs round once from f32 (one output ulp)
TOL = {torch.float32: 1e-5, torch.float16: 2e-3, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def rpa_inputs(device, dtype, heads, kv_heads, d, page, lens, seed=0,
               max_pages=24, num_pages=256):
    """Random q and pools; sequences own distinct random pages, table
    tails padded with page 0, which holds garbage the kernel must skip."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    k = rng.standard_normal((num_pages, page, kv_heads, d)).astype(np.float32)
    v = rng.standard_normal((num_pages, page, kv_heads, d)).astype(np.float32)
    k[0], v[0] = 300.0, -300.0
    bt = np.zeros((b, max_pages), np.int32)
    for i, n in enumerate(lens):
        owned = math.ceil(n / page)
        bt[i, :owned] = rng.choice(np.arange(1, num_pages), owned,
                                   replace=False)
    t = [torch.from_numpy(a).to(device) for a in
         (q, k, v, bt, np.asarray(lens, np.int32))]
    return [x.to(dtype) for x in t[:3]] + t[3:]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,heads,kv_heads,page,d", [
    (torch.bfloat16, 32, 32, 16, 128),
    (torch.bfloat16, 32, 8, 16, 128),
    (torch.float32, 8, 2, 16, 64),
    (torch.float16, 12, 4, 7, 100),
], ids=["bf16_mha", "bf16_gqa", "f32", "f16_odd_page_d100"])
def test_rpa_decode_kernel_matches_plain_version(cuda_device, dtype, heads,
                                                 kv_heads, page, d):
    # an inert row, length 1, at and past a page boundary, a full table
    lens = [0, 1, page, page + 1, 5 * page + 3, 24 * page]
    q, k, v, bt, sl = rpa_inputs(cuda_device, dtype, heads, kv_heads, d,
                                 page, lens)
    before = LAUNCH_COUNTS["rpa_decode"]
    got = ragged_paged_attention_decode(q, k, v, bt, sl)
    want = ragged_paged_attention_decode_ref(q, k, v, bt, sl)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["rpa_decode"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert bool((got[0] == 0).all())


@pytest.mark.gpu
def test_rpa_decode_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v, bt, sl = rpa_inputs(cuda_device, torch.float32, 8, 2, 64, 16,
                                 [3, 5])
    with pytest.raises(ValueError, match="one device"):
        ragged_paged_attention_decode(q, k.cpu(), v, bt, sl)
    strided = k.transpose(0, 1).contiguous().transpose(0, 1)
    assert strided.shape == k.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ragged_paged_attention_decode(q, strided, strided, bt, sl)


def split_lens(page):
    """Lengths around the kernel's split (rpa_decode_split_pages() pages):
    an inert row, 1, one split less one token, one split, one split and a
    token, three splits and five tokens, and a full table of 256 pages."""
    split = rpa._lib().split_pages * page
    return [0, 1, split - 1, split, split + 1, 3 * split + 5, 256 * page]


def decode_case(device, quant, heads, kv_heads, d, lens, seed, page=16,
                max_pages=256):
    """(kernel arguments, keyword arguments) of a bf16 decode over bf16
    pools or (quant) int8 pools with their scales; tables 256 pages wide
    unless given."""
    pages = sum(math.ceil(n / page) for n in lens) + 1
    if quant:
        q, k, v, bt, sl, ks, vs = quant_rpa_inputs(
            device, torch.bfloat16, heads, kv_heads, d, page, lens, seed,
            max_pages=max_pages, num_pages=pages)
        return (q, k, v, bt, sl), {"k_scales": ks, "v_scales": vs}
    return rpa_inputs(device, torch.bfloat16, heads, kv_heads, d, page,
                      lens, seed, max_pages=max_pages, num_pages=pages), {}


# pages of 16 tokens take the TMA loader, pages of 8 (rows of 16-byte
# multiples, a stage across two pages) the 16-byte cp.async one
@pytest.mark.gpu
@pytest.mark.parametrize("page", [16, 8], ids=["tma", "cp.async"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("heads,kv_heads,d", [
    (32, 32, 128), (64, 8, 128), (64, 8, 256)],
    ids=["mha", "gqa64q8kv", "gqa8_d256"])
def test_rpa_decode_splits_match_plain_version(cuda_device, page, quant,
                                                heads, kv_heads, d):
    """Lengths at and around the split boundaries; one launch a call, and
    two launches bitwise equal (each merge resets its counter and sums the
    splits in split order)."""
    args, kw = decode_case(cuda_device, quant, heads, kv_heads, d,
                           split_lens(page), 7, page)
    name = "rpa_decode_quant" if quant else "rpa_decode"
    before = dict(LAUNCH_COUNTS)
    got = ragged_paged_attention_decode(*args, **kw)
    again = ragged_paged_attention_decode(*args, **kw)
    want = ragged_paged_attention_decode_ref(*args, None, **kw)
    torch.cuda.synchronize()
    assert {n: LAUNCH_COUNTS[n] - before[n] for n in before} == \
        {n: 2 * (n == name) for n in before}
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])
    assert bool((got[0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_rpa_decode_workspace_takes_a_smaller_shape_after_a_larger(
        cuda_device, quant):
    """The split workspace of a (device, stream) is grown for a large call
    and reused, counters and all, by smaller ones after it."""
    large = decode_case(cuda_device, quant, 64, 8, 128, split_lens(16), 8)
    small = decode_case(cuda_device, quant, 8, 4, 64, [300, 0, 40], 9)
    for args, kw in (large, small, large, small):
        got = ragged_paged_attention_decode(*args, **kw)
        want = ragged_paged_attention_decode_ref(*args, None, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[torch.bfloat16],
                                   rtol=TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_rpa_decode_takes_tables_wider_than_a_split_row_each(cuda_device,
                                                             quant):
    """65 sequences over tables 8192 pages wide: one block row a split of
    a full table would be 65 x 1024 rows, past the 65535 a grid may have.
    Most rows are short, as a served decode's under the engine's padding
    to its longest context; one reaches past 1000 splits."""
    rng = np.random.default_rng(11)
    lens = [0, 1, 16 * 8192] + rng.integers(1, 3000, 62).tolist()
    args, kw = decode_case(cuda_device, quant, 8, 2, 64, lens, 12,
                           max_pages=8192)
    q, k, v, bt, sl = args
    got = ragged_paged_attention_decode(q, k, v, bt, sl, **kw)
    want = torch.cat([ragged_paged_attention_decode_ref(   # a row at a time
        q[i:i + 1], k, v, bt[i:i + 1], sl[i:i + 1], None, **kw)
        for i in range(len(lens))])
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


# flash kernels vs plain versions: f32 elementwise (summation order only);
# 16-bit relative L2 over the tensor (probability tiles round against a
# running max in the kernel, the final max in the plain version), plus an
# RMS floor of 1e-5 for gradients that vanish (S=1: dq = dk = 0)
FLASH_REL = {torch.float16: 2e-3, torch.bfloat16: 1e-2}


def flash_inputs(device, dtype, b, h, hkv, s, d, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    shapes = [(b, h, s, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, h, s, d)]
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            .to(device=device, dtype=dtype) for sh in shapes]


def flash_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        diff = (got.float() - want.float()).norm().item()
        bound = FLASH_REL[dtype] * want.float().norm().item() + \
            1e-5 * math.sqrt(want.numel())
        assert diff <= bound, (diff, bound)


# 16-bit D 64 and 128 take the wgmma/TMA kernels (the forward at 256
# too), other D (96, 144, 192; the backward at 256) the mma.sync ones,
# float32 the f32 ones: every route, at the training shape, GQA, partial
# last tiles of 64 and 128 rows (S=4000), Sq != Sk
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,h,hkv,s,d,causal,sk", [
    (torch.bfloat16, 1, 8, 8, 1024, 128, True, None),
    (torch.bfloat16, 2, 8, 2, 1000, 128, True, None),
    (torch.float16, 2, 4, 4, 1, 64, True, None),
    (torch.bfloat16, 1, 4, 2, 333, 64, False, None),
    (torch.float32, 2, 4, 2, 200, 64, True, None),
    (torch.float32, 1, 4, 4, 130, 16, False, None),
    (torch.bfloat16, 1, 32, 32, 4096, 128, True, None),
    (torch.bfloat16, 1, 32, 8, 2048, 128, True, None),
    (torch.bfloat16, 1, 4, 4, 4000, 128, True, None),
    (torch.bfloat16, 1, 4, 4, 1000, 128, False, 1500),
    (torch.float16, 2, 16, 16, 512, 64, True, None),
    (torch.bfloat16, 1, 4, 4, 333, 96, True, None),
    (torch.bfloat16, 1, 32, 8, 4000, 256, True, None),
    (torch.float16, 2, 4, 2, 1000, 256, False, None),
    (torch.bfloat16, 2, 8, 2, 1, 256, True, None),
    (torch.float16, 1, 4, 4, 777, 128, False, None),
    (torch.bfloat16, 1, 4, 2, 500, 144, True, None),
    (torch.float16, 1, 4, 4, 300, 192, False, 450),
    (torch.float32, 1, 4, 2, 130, 256, True, None),
], ids=["bf16_mha", "bf16_gqa_ragged", "f16_s1", "bf16_full_d64",
        "f32_gqa", "f32_full_d16", "bf16_training_shape", "bf16_gqa_32_8",
        "bf16_s4000", "bf16_full_sq1000_sk1500", "f16_b2_d64",
        "bf16_d96_mma_route", "bf16_d256_gqa_s4000", "f16_d256_full",
        "bf16_d256_s1", "f16_d128_full", "bf16_d144_mma_route",
        "f16_d192_full_rect", "f32_d256"])
def test_flash_kernels_match_plain_versions(cuda_device, dtype, b, h, hkv,
                                            s, d, causal, sk):
    q, k, v, do = flash_inputs(cuda_device, dtype, b, h, hkv, s, d, sk=sk)
    before = dict(LAUNCH_COUNTS)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ro, rl = fa.flash_attention_fwd_ref(q, k, v, causal)
    dq = fa.flash_attention_dq(q, k, v, ro, rl, do, causal)
    dk, dv = fa.flash_attention_dkv(q, k, v, ro, rl, do, causal)
    delta = fa.flash_bwd_delta(ro, do)
    torch.cuda.synchronize()
    # dq and dk/dv called alone launch the delta pre-pass each
    assert {n: LAUNCH_COUNTS[n] - before[n] for n in
            ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd_delta")} == \
        {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1, "flash_bwd_delta": 3}
    # f32 on both sides, summed in another order
    torch.testing.assert_close(delta, fa.flash_bwd_delta_ref(ro, do),
                               atol=1e-5, rtol=1e-5)
    flash_close(out, ro, dtype)
    torch.testing.assert_close(lse, rl, atol=1e-5, rtol=1e-5)
    flash_close(dq, fa.flash_attention_dq_ref(q, k, v, ro, rl, do, causal),
                dtype)
    rk, rv = fa.flash_attention_dkv_ref(q, k, v, ro, rl, do, causal)
    flash_close(dk, rk, dtype)
    flash_close(dv, rv, dtype)
    assert dk.shape == k.shape and dv.shape == v.shape


@pytest.mark.gpu
def test_sdpa_on_the_card_always_launches_the_flash_kernels(cuda_device):
    """No seq gate: a 16-token causal attention and its backward go
    through the kernels, never through the plain path."""
    q, k, v, do = (x.transpose(1, 2).contiguous().requires_grad_()
                   for x in flash_inputs(cuda_device, torch.bfloat16, 2, 4,
                                         2, 16, 64))
    before = dict(LAUNCH_COUNTS)
    out = scaled_dot_product_attention(q, k, v, is_causal=True)
    out.backward(do.detach())
    torch.cuda.synchronize()
    assert {n: LAUNCH_COUNTS[n] - before[n] for n in
            ("flash_fwd", "flash_dq", "flash_dkv")} == \
        {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    assert k.grad.shape == k.shape


@pytest.mark.gpu
def test_sdpa_on_the_card_routes_by_shape(cuda_device):
    """head_dim 72 and 136 take the flash kernels zero-padded to 80 and 144,
    head_dim 128 and 256 as they are: each launches the flash forward, dq
    and dk/dv once and the delta pre-pass once, and matches the plain sdpa
    in f32 (the bf16 flash tolerance).  Causal with Sq < Sk and head_dim
    272 go to the plain sdpa, launching nothing, as the reference routes
    them."""
    reset_route_counts()
    for d, sq in ((72, 64), (128, 64), (64, 32), (136, 64), (256, 64),
                  (272, 64)):
        q, k, v, do = (x.transpose(1, 2).contiguous().requires_grad_()
                       for x in flash_inputs(cuda_device, torch.bfloat16, 2,
                                             4, 2, 64, d))
        q = q[:, :sq].detach().requires_grad_()
        before = dict(LAUNCH_COUNTS)
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
        out.backward(do[:, :sq].detach())
        torch.cuda.synchronize()
        launched = {n: LAUNCH_COUNTS[n] - before[n] for n in
                    ("flash_fwd", "flash_dq", "flash_dkv", "flash_bwd_delta")}
        flash = sq == 64 and d <= 256
        assert launched == {n: int(flash) for n in launched}, (d, launched)
        assert out.shape == q.shape and k.grad.shape == k.shape
        assert torch.isfinite(q.grad.float()).all()
        want = sdpa(q.detach().float(), k.detach().float(),
                    v.detach().float(), scale=1.0 / math.sqrt(d),
                    is_causal=True)
        flash_close(out.detach(), want, torch.bfloat16)
    assert ROUTE_COUNTS == {"sdpa_flash_padded": 2, "sdpa_flash": 2,
                            "sdpa_plain:causal_rect": 1,
                            "sdpa_plain:head_dim": 1}
    reset_route_counts()


@pytest.mark.gpu
def test_flash_kernels_refuse_what_they_cannot_take(cuda_device):
    q, k, v, _ = flash_inputs(cuda_device, torch.float32, 1, 4, 2, 16, 64)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention_fwd(q, k.cpu(), v, True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa.flash_attention_fwd(q, k[:, :, :8], v[:, :, :8], True)
    # the delta pre-pass reads rows in 16-byte vectors: bf16 D=20 is not
    o = torch.zeros(1, 4, 16, 20, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_bwd_delta(o, o)
    # head_dim up to 256 (the reference's kernels' limit), not 272
    for d, ok in ((272, False), (256, True)):
        q, k, v, do = flash_inputs(cuda_device, torch.bfloat16, 1, 4, 2, 16,
                                   d)
        before = dict(LAUNCH_COUNTS)
        if not ok:
            with pytest.raises(ValueError, match="multiple of 16 up to 256"):
                fa.flash_attention_fwd(q, k, v, True)
            with pytest.raises(ValueError, match="multiple of 16 up to 256"):
                fa.flash_attention_bwd(q, k, v, q, q[..., 0].float(), do,
                                       True)
        else:
            out, lse = fa.flash_attention_fwd(q, k, v, True)
            fa.flash_attention_bwd(q, k, v, out, lse, do, True)
        torch.cuda.synchronize()
        assert {n: LAUNCH_COUNTS[n] - before[n] for n in
                ("flash_fwd", "flash_dq", "flash_dkv")} == \
            {n: int(ok) for n in ("flash_fwd", "flash_dq", "flash_dkv")}


def quant_rpa_inputs(device, dtype, heads, kv_heads, d, page, lens, seed=0,
                     **shape):
    """rpa_inputs' pools as int8 codes with one f32 scale per (token, kv
    head); page 0 holds garbage codes and scales."""
    q, k, v, bt, sl = rpa_inputs(device, torch.float32, heads, kv_heads, d,
                                 page, lens, seed, **shape)
    (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    kq[0], vq[0], ks[0], vs[0] = 127, -127, 300.0, 300.0
    return q.to(dtype), kq, vq, bt, sl, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,heads,kv_heads,page,d", [
    (torch.bfloat16, 32, 32, 16, 128),
    (torch.bfloat16, 32, 8, 16, 128),
    (torch.float32, 8, 2, 16, 64),
    (torch.float16, 12, 4, 7, 100),
], ids=["bf16_mha", "bf16_gqa", "f32", "f16_odd_page_d100"])
def test_rpa_decode_quant_kernel_matches_plain_version(cuda_device, dtype,
                                                       heads, kv_heads, page,
                                                       d):
    lens = [0, 1, page, page + 1, 5 * page + 3, 24 * page]
    q, kq, vq, bt, sl, ks, vs = quant_rpa_inputs(cuda_device, dtype, heads,
                                                 kv_heads, d, page, lens)
    before = dict(LAUNCH_COUNTS)
    got = ragged_paged_attention_decode(q, kq, vq, bt, sl, k_scales=ks,
                                        v_scales=vs)
    want = ragged_paged_attention_decode_ref(q, kq, vq, bt, sl, None, ks, vs)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["rpa_decode_quant"] == \
        before["rpa_decode_quant"] + 1
    assert LAUNCH_COUNTS["rpa_decode"] == before["rpa_decode"]
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert bool((got[0] == 0).all())


@pytest.mark.gpu
def test_rpa_decode_quant_kernel_refuses_what_it_cannot_take(cuda_device):
    q, kq, vq, bt, sl, ks, vs = quant_rpa_inputs(cuda_device, torch.float32,
                                                 8, 2, 64, 16, [3, 5])
    with pytest.raises(ValueError, match="one device"):
        ragged_paged_attention_decode(q, kq, vq, bt, sl, k_scales=ks.cpu(),
                                      v_scales=vs)
    strided = ks.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ragged_paged_attention_decode(q, kq, vq, bt, sl, k_scales=strided,
                                      v_scales=vs)


# quantized matmul kernel vs plain version, both f32 products and sums in
# another order: f32 relative L2 1e-5; 16-bit outputs round once from f32
# (half an ulp, 2^-9 of bf16), so a relative L2 of 4e-3
QMM_REL = {torch.float32: 1e-5, torch.float16: 4e-3, torch.bfloat16: 4e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,group", [
    (1, 512, 384, 128),
    (8, 4096, 1024, 128),
    (256, 1024, 512, 128),
    (8, 300, 77, 64),          # K padded to a group multiple, odd N
    (40, 160, 48, 8),          # the tiny model's group
    (3, 21, 10, 3),            # odd group: int4 pads one more group
], ids=["m1", "m8", "m256", "padded_k_odd_n", "m40_g8", "odd_group"])
def test_quant_matmul_kernel_matches_plain_version(cuda_device, bits, dtype,
                                                   m, k, n, group):
    g = torch.Generator(device=cuda_device).manual_seed(m * k + n)
    w = torch.randn(k, n, generator=g, device=cuda_device)
    x = torch.randn(m, k, generator=g, device=cuda_device).to(dtype)
    qw, s, grp = quantize_weight(w, bits=bits, group=group)
    before = dict(LAUNCH_COUNTS)
    got = quant_matmul(x, qw, s, bits=bits, group=grp)
    want = quant_matmul_ref(x, qw, s, bits=bits, group=grp)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS[f"qmm_i{bits}"] == before[f"qmm_i{bits}"] + 1
    assert got.dtype == dtype and got.shape == (m, n)
    diff = (got.float() - want.float()).norm().item()
    assert diff <= QMM_REL[dtype] * want.float().norm().item(), diff


def qmm_inputs(device, m, k, n, bits, group, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(k, n, generator=g, device=device) * 0.02
    x = torch.randn(m, k, generator=g, device=device).to(dtype)
    qw, s, grp = quantize_weight(w, bits=bits, group=group)
    return x, qw, s, grp


def qmm_close(got, want, dtype):
    diff = (got.float() - want.float()).norm().item()
    assert diff <= QMM_REL[dtype] * want.float().norm().item(), diff


# The tensor-core route keeps the reference's rounding: exact products and
# group sums scaled in f32, so kernel and plain version differ only where
# the f32 sums round to different 16-bit outputs (a few in a thousand).
# Codes scaled into 16 bits before the product (c * s rounded: every
# weight moved by up to 2^-9 in bf16, 2^-12 in fp16) read about 3e-3
# (bf16) and 4e-4 (fp16) here and fail.  Held where the output has at
# least QMM_TC_MIN_OUT values: one output that rounds the other way weighs
# up to 2^-7 of its value, too much in a few hundred.
QMM_TC_REL = {torch.float16: 1e-4, torch.bfloat16: 3e-4}
QMM_TC_MIN_OUT = 16384


def qmm_tc_close(got, want, dtype):
    rel = ((got.float() - want.float()).norm() /
           want.float().norm()).item()
    print(f"qmm_tc_rel {str(dtype).replace('torch.', '')} "
          f"{tuple(got.shape)} {rel:.3e}")
    assert rel <= QMM_TC_REL[dtype], rel


# the tensor-core route (16-bit x, group % 16 == 0): decode rows (M <= 32,
# one to four row tiles), the prefill shapes above it (the wgmma kernel
# where TMA reads x and the codes; mma.sync for K % 8 != 0 or a group not
# a multiple of 64), K in several splits (4096, 11008), K padded to a
# group multiple with a tail short of a 64-row stage, odd N (plain loads),
# the serve's widest N, four group ends in one 64-row stage (group 16) and
# groups that straddle stages (48)
@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,n,group", [
    (1, 4096, 32000, 128),
    (8, 4096, 11008, 128),
    (17, 4096, 1024, 128),
    (32, 11008, 4096, 128),
    (33, 4096, 1024, 128),
    (64, 4096, 4096, 128),
    (256, 4096, 11008, 128),
    (8, 300, 77, 64),
    (256, 300, 77, 64),
    (64, 512, 256, 32),
    (8, 512, 256, 16),
    (17, 480, 160, 48),
    (40, 480, 160, 48),
], ids=["m1_lm_head", "m8", "m17", "m32_down", "m33", "m64", "m256",
        "m8_padded_k_odd_n", "m256_padded_k_odd_n", "m64_group32",
        "m8_group16", "m17_group48", "m40_group48"])
def test_quant_matmul_tensor_cores_match_plain_version(cuda_device, bits,
                                                       dtype, m, k, n, group):
    x, qw, s, grp = qmm_inputs(cuda_device, m, k, n, bits, group, dtype,
                               m * k + n)
    assert qmm_route(dtype, grp) == "tensor_cores"
    before = dict(LAUNCH_COUNTS)
    got = quant_matmul(x, qw, s, bits=bits, group=grp)
    torch.cuda.synchronize()
    assert {n_: LAUNCH_COUNTS[n_] - before[n_] for n_ in before} == \
        {n_: int(n_ == f"qmm_i{bits}") for n_ in before}
    want = quant_matmul_ref(x, qw, s, bits=bits, group=grp)
    assert got.dtype == dtype and got.shape == (m, n)
    assert bool(torch.isfinite(got).all())
    qmm_close(got, want, dtype)
    if m * n >= QMM_TC_MIN_OUT:
        qmm_tc_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("group", [128, 96, 64, 16, 8, 3])
@pytest.mark.parametrize("m", [8, 256])
def test_quant_matmul_plan_takes_the_route_qmm_route_names(cuda_device,
                                                           dtype, group, m):
    """The library chooses the kernel (0 FMA, 1 mma.sync, 2 wgmma) by the
    rule ``qmm_route`` states; the wgmma kernel only for 16-byte aligned
    bases and groups of whole 128-row stages."""
    # the module (the package's name quant_matmul is the function)
    qm = importlib.import_module("paddle_tpu_torch.ops.cuda.quant_matmul")
    code = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}[dtype]
    lib = qm._lib()
    for aligned in (1, 0):
        kernel, splits, ks, counters = qm._plan(
            lib, cuda_device.index or 0, m, 4096, 4096, group, 8, code,
            aligned)
        tc = qmm_route(dtype, group) == "tensor_cores"
        assert (kernel != 0) == tc
        assert (kernel == 2) == (tc and m > 32 and group % 128 == 0 and
                                 bool(aligned))
        assert splits * ks >= 4096
        assert (counters > 0) == (tc and splits > 1)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_tensor_cores_on_a_second_card(cuda_device, bits):
    """A kernel's shared-memory limit is raised on each device it launches
    on: a prefill product on card 0, then on card 1 (the wgmma kernel
    takes about 196 KB, the 64-row mma.sync one about 55 KB)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        for group in (128, 64):  # wgmma; mma.sync at 64-row tiles
            x, qw, s, grp = qmm_inputs(dev, 256, 4096, 4096, bits, group,
                                       torch.bfloat16, 5)
            got = quant_matmul(x, qw, s, bits=bits, group=grp)
            torch.cuda.synchronize(dev)
            assert got.device == dev
            qmm_close(got, quant_matmul_ref(x, qw, s, bits=bits, group=grp),
                      torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [8, 256])
def test_quant_matmul_tensor_cores_take_a_misaligned_x(cuda_device, bits,
                                                       m):
    """x two bytes past a 16-byte boundary: no TMA or 16-byte copy can
    read it, so the kernels load it plainly."""
    x, qw, s, grp = qmm_inputs(cuda_device, m, 4096, 1024, bits, 128,
                               torch.bfloat16, 11)
    buf = torch.empty(m * 4096 + 1, dtype=x.dtype, device=cuda_device)
    xm = buf[1:].view(m, 4096)
    xm.copy_(x)
    assert xm.data_ptr() % 16
    qmm_close(quant_matmul(xm, qw, s, bits=bits, group=grp),
              quant_matmul_ref(x, qw, s, bits=bits, group=grp),
              torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [8, 256])
def test_quant_matmul_tensor_cores_rerun_bitwise_equal(cuda_device, bits, m):
    """The split merge adds the splits in split order inside the launch:
    two calls give the same bits."""
    x, qw, s, grp = qmm_inputs(cuda_device, m, 4096, 4096, bits, 128,
                               torch.bfloat16, 7)
    a = quant_matmul(x, qw, s, bits=bits, group=grp)
    b = quant_matmul(x, qw, s, bits=bits, group=grp)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_workspace_takes_a_smaller_shape_after_a_larger(
        cuda_device, bits):
    """The split workspace of a (device, stream) is grown for a large call
    and reused, counters and all, by smaller ones after it."""
    large = qmm_inputs(cuda_device, 256, 4096, 11008, bits, 128,
                       torch.bfloat16, 8)
    small = qmm_inputs(cuda_device, 8, 1024, 512, bits, 64, torch.bfloat16,
                       9)
    for x, qw, s, grp in (large, small, large, small):
        got = quant_matmul(x, qw, s, bits=bits, group=grp)
        want = quant_matmul_ref(x, qw, s, bits=bits, group=grp)
        torch.cuda.synchronize()
        qmm_close(got, want, torch.bfloat16)


@pytest.mark.gpu
def test_quant_matmul_kernel_refuses_what_it_cannot_take(cuda_device):
    w = torch.randn(64, 32, device=cuda_device)
    x = torch.randn(4, 64, device=cuda_device)
    qw, s, grp = quantize_weight(w, bits=8, group=16)
    before = dict(LAUNCH_COUNTS)
    with pytest.raises(ValueError, match="one device"):
        quant_matmul(x, qw.cpu(), s, bits=8, group=grp)
    with pytest.raises(ValueError, match="needs codes"):
        quant_matmul(x, qw, s, bits=4, group=grp)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(x, qw.t().contiguous().t(), s, bits=8, group=grp)
    assert LAUNCH_COUNTS == before


# the packed-training shape: T = 4096 tokens in six documents
PACKED_CU = [0, 1531, 2531, 3231, 3748, 4003, 4096]


# packed-sequence (varlen) kernels vs plain versions: the dense kernels'
# tolerances (flash_close).  The cases hold a one-token document, a tail
# past cu[-1] (a segment of its own), T not a multiple of 64, GQA.
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,hkv,t,d,causal,cu", [
    (torch.bfloat16, 8, 8, 1000, 128, True, [0, 300, 301, 700, 1000]),
    (torch.bfloat16, 8, 2, 777, 64, False, [0, 100, 400]),
    (torch.float16, 4, 4, 130, 64, True, [0, 1, 2, 3, 130]),
    (torch.float32, 4, 2, 200, 64, True, [0, 50, 120, 200]),
    (torch.float32, 4, 4, 97, 16, False, [0, 10, 97]),
    (torch.bfloat16, 32, 32, 4096, 128, True, PACKED_CU),
    (torch.bfloat16, 32, 32, 4096, 128, False, PACKED_CU),
    (torch.bfloat16, 32, 8, 4096, 128, True, PACKED_CU),
    (torch.bfloat16, 8, 2, 1000, 256, True, [0, 300, 301, 700, 1000]),
    (torch.float16, 4, 4, 777, 256, False, [0, 100, 400]),
    (torch.float32, 4, 2, 200, 256, True, [0, 50, 120, 200]),
], ids=["bf16_causal_one_token_doc", "bf16_gqa_full_tail",
        "f16_single_tokens", "f32_gqa", "f32_full_d16", "bf16_packed",
        "bf16_packed_full", "bf16_packed_gqa", "bf16_d256_gqa",
        "f16_d256_full_tail", "f32_d256"])
def test_varlen_kernels_match_plain_versions(cuda_device, dtype, h, hkv, t,
                                             d, causal, cu):
    q, k, v, do = (x[0] for x in flash_inputs(cuda_device, dtype, 1, h, hkv,
                                              t, d))
    cu = torch.tensor(cu, dtype=torch.int32, device=cuda_device)
    before = dict(LAUNCH_COUNTS)
    out, lse = fa.varlen_flash_fwd(q, k, v, cu, causal)
    ro, rl = fa.varlen_flash_fwd_ref(q, k, v, cu, causal)
    dq = fa.varlen_flash_dq(q, k, v, cu, ro, rl, do, causal)
    dk, dv = fa.varlen_flash_dkv(q, k, v, cu, ro, rl, do, causal)
    torch.cuda.synchronize()
    assert {n: LAUNCH_COUNTS[n] - before[n] for n in
            ("varlen_fwd", "varlen_dq", "varlen_dkv", "flash_fwd")} == \
        {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkv": 1, "flash_fwd": 0}
    flash_close(out, ro, dtype)
    torch.testing.assert_close(lse, rl, atol=1e-5, rtol=1e-5)
    flash_close(dq, fa.varlen_flash_dq_ref(q, k, v, cu, ro, rl, do, causal),
                dtype)
    rk, rv = fa.varlen_flash_dkv_ref(q, k, v, cu, ro, rl, do, causal)
    flash_close(dk, rk, dtype)
    flash_close(dv, rv, dtype)
    assert dk.shape == k.shape and dv.shape == v.shape


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,h,sq,sk,d,causal,lens", [
    (torch.bfloat16, 4, 4, 300, 300, 128, True, [300, 299, 1, 0]),
    (torch.float16, 3, 2, 200, 200, 64, True, [64, 130, 7]),
    (torch.float32, 3, 4, 100, 130, 64, False, [130, 64, 0]),
], ids=["bf16_causal", "f16_causal_d64", "f32_full_rect"])
def test_ragged_kernel_matches_plain_version(cuda_device, dtype, b, h, sq,
                                             sk, d, causal, lens):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d))
                                .astype(np.float32)).to(cuda_device, dtype)
               for s in (sq, sk, sk))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = LAUNCH_COUNTS["ragged_fwd"]
    got = fa.flash_attention_ragged_bhsd(q, k, v, kv_lens, causal)
    want = fa.flash_attention_ragged_bhsd_ref(q, k, v, kv_lens, causal)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["ragged_fwd"] == before + 1
    flash_close(got, want, dtype)
    for i, n in enumerate(lens):
        # a length of 0 gives zeros; rows past a length > 0 do not
        assert bool((got[i] == 0).all()) == (n == 0)


@pytest.mark.gpu
def test_flash_attn_unpadded_on_the_card_always_launches_varlen_kernels(
        cuda_device):
    """A 48-token pack of three documents: forward and backward through
    the varlen kernels (no length gate), never the plain path."""
    q, k, v, do = (x[0].transpose(0, 1).contiguous().requires_grad_()
                   for x in flash_inputs(cuda_device, torch.bfloat16, 1, 4,
                                         2, 48, 64))
    cu = torch.tensor([0, 5, 30, 48], dtype=torch.int32, device=cuda_device)
    before = dict(LAUNCH_COUNTS)
    out, _ = flash_attn_unpadded(q, k, v, cu, cu, 25, 25, 0.125,
                                 causal=True)
    out.backward(do.detach())
    torch.cuda.synchronize()
    assert {n: LAUNCH_COUNTS[n] - before[n] for n in
            ("varlen_fwd", "varlen_dq", "varlen_dkv")} == \
        {"varlen_fwd": 1, "varlen_dq": 1, "varlen_dkv": 1}
    assert out.shape == q.shape and k.grad.shape == k.shape


@pytest.mark.gpu
def test_varlen_and_ragged_kernels_refuse_what_they_cannot_take(cuda_device):
    q, k, v, _ = (x[0] for x in flash_inputs(cuda_device, torch.float32, 1,
                                             4, 2, 16, 64))
    cu = torch.tensor([0, 16], dtype=torch.int32, device=cuda_device)
    before = dict(LAUNCH_COUNTS)
    with pytest.raises(ValueError, match="one device"):
        fa.varlen_flash_fwd(q, k, v, cu.cpu())
    with pytest.raises(ValueError, match="same T"):
        fa.varlen_flash_fwd(q, k[:, :8], v[:, :8], cu)
    with pytest.raises(ValueError, match="1-D int32/int64"):
        fa.varlen_flash_fwd(q, k, v, cu.float())
    lens = torch.tensor([16], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head count"):
        fa.flash_attention_ragged_bhsd(q[None], k[None], v[None], lens)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_ragged_bhsd(q[None], q[None], q[None], lens[:0])
    assert LAUNCH_COUNTS == before


# -- the fused optimizer update ---------------------------------------------

FU_GROUPS = {"f32": (torch.float32, torch.float32),
             "f16": (torch.float16, torch.float16),
             "bf16": (torch.bfloat16, torch.bfloat16),
             "f16_f32": (torch.float16, torch.float32),
             "bf16_f32": (torch.bfloat16, torch.float32)}
# mantissa bits of each storage type: kernel and plain version compute the
# same f32 operations in the same order (powf aside), so a 16-bit output is
# within one ulp of the plain version's and an f32 one within 1e-6
FU_MANT = {torch.float32: None, torch.float16: 10, torch.bfloat16: 7}


def fu_close(got, want, what):
    mant = FU_MANT[got.dtype]
    got, want = got.float(), want.float()
    if mant is None:
        bound = 1e-6 * want.abs() + 1e-30
    else:
        bound = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(2.0 ** -24))) - mant)
    bad = (got - want).abs() > bound
    assert not bad.any(), f"{what}: {int(bad.sum())} elements off"


def fu_case(device, kind, p_dtype, m_dtype, sizes, seed=0):
    """Parameters (one an odd view, so its addresses are not 16-byte
    aligned), grads and moments: two copies, for the kernel and for the
    plain version."""
    from paddle_tpu_torch.ops.cuda import fused_update as fu
    g = torch.Generator(device="cpu").manual_seed(seed)
    sets = []
    for n in sizes:
        p = torch.randn(n, generator=g)
        gr = torch.randn(n, generator=g) * 0.1
        m1 = torch.randn(n, generator=g) * 0.01
        m2 = torch.rand(n, generator=g) * 1e-3
        sets.append((p, gr, m1, m2))
    out = []
    for _ in range(2):
        ps, gs, m1s, m2s = [], [], [], []
        for i, (p, gr, m1, m2) in enumerate(sets):
            if i == 1:       # an odd offset into a larger buffer
                base = torch.zeros(p.numel() + 1, dtype=p_dtype,
                                   device=device)
                pv = base[1:]
                pv.copy_(p)
                gb = torch.zeros_like(base)
                gv = gb[1:]
                gv.copy_(gr)
            else:
                pv = p.to(device, p_dtype)
                gv = gr.to(device, p_dtype)
            ps.append(pv)
            gs.append(gv)
            m1s.append(m1.to(device, m_dtype))
            m2s.append(m2.to(device, m_dtype))
        out.append((ps, gs, m1s, m2s))
    decay = [i % 2 == 0 for i in range(len(sizes))]
    return fu, out, decay


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("group", sorted(FU_GROUPS))
def test_fused_update_matches_plain_version(cuda_device, kind, group):
    """Odd sizes (1, 7, 4095, 4096 + 3, 65536 + 5: tails, a chunk
    boundary, an unaligned view), two steps with lr and step as 0-dim
    device tensors, mixed decay flags (AdamW): the kernel's p, m1, m2
    within one ulp (16-bit) or 1e-6 (f32) of the plain version's; one
    launch a call."""
    p_dtype, m_dtype = FU_GROUPS[group]
    if kind == "sgd" and m_dtype != p_dtype:
        pytest.skip("SGD keeps no moments")
    fu, (a, b), decay = fu_case(cuda_device, kind, p_dtype, m_dtype,
                                [1, 4099, 7, 4095, 65541])
    op = fu.SGD if kind == "sgd" else fu.ADAM
    if kind != "adamw":
        decay = [False] * len(decay)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8,
              coeff=0.1 if kind == "adamw" else 0.0)
    cache = {}
    for step in (1, 2):
        lr = torch.tensor(1e-2 * step, dtype=torch.float32,
                          device=cuda_device)
        st = torch.tensor(float(step), dtype=torch.float32,
                          device=cuda_device)
        before = LAUNCH_COUNTS["fused_update"]
        fu.fused_update(op, *a, decay, lr, st, cache=cache, **kw)
        assert LAUNCH_COUNTS["fused_update"] - before == 1
        fu.fused_update_ref(op, *b[:2], b[2] if op else None,
                            b[3] if op else None, decay, lr, st, **kw)
    torch.cuda.synchronize()
    for i in range(len(a[0])):
        fu_close(a[0][i], b[0][i], f"p[{i}]")
        if op == fu.ADAM:
            fu_close(a[2][i], b[2][i], f"m1[{i}]")
            fu_close(a[3][i], b[3][i], f"m2[{i}]")
    assert len(cache) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sgd", "adamw"])
@pytest.mark.parametrize("group", sorted(FU_GROUPS))
def test_fused_update_overflow_flag(cuda_device, kind, group):
    """The loss scaler's flag (a 0-dim f32 on the card): set, every p, m1
    and m2 stays bitwise as it was, in the kernel and in the plain
    version; clear, the kernel's result is bitwise the null flag's and
    within one ulp (16-bit) or 1e-6 (f32) of the plain version's."""
    p_dtype, m_dtype = FU_GROUPS[group]
    if kind == "sgd" and m_dtype != p_dtype:
        pytest.skip("SGD keeps no moments")
    sizes = [1, 4099, 7, 65541]
    fu, (a, b), decay = fu_case(cuda_device, kind, p_dtype, m_dtype, sizes)
    _, (c, _), _ = fu_case(cuda_device, kind, p_dtype, m_dtype, sizes)
    op = fu.SGD if kind == "sgd" else fu.ADAM
    ms = (lambda t: (t[2], t[3])) if op else (lambda t: (None, None))
    kw = dict(coeff=0.1)
    lr = torch.tensor(1e-2, device=cuda_device)
    st = torch.tensor(1.0, device=cuda_device)
    flag = torch.ones((), device=cuda_device)
    before = [[x.clone() for x in lst] for lst in a]
    fu.fused_update(op, a[0], a[1], *ms(a), decay, lr, st, skip=flag, **kw)
    fu.fused_update_ref(op, b[0], b[1], *ms(b), decay, lr, st, skip=flag,
                        **kw)
    torch.cuda.synchronize()
    for got_set in (a, b):
        for j in ((0, 2, 3) if op else (0,)):
            for got, old in zip(got_set[j], before[j]):
                assert torch.equal(got, old)
    flag.zero_()
    fu.fused_update(op, a[0], a[1], *ms(a), decay, lr, st, skip=flag, **kw)
    fu.fused_update(op, c[0], c[1], *ms(c), decay, lr, st, **kw)
    fu.fused_update_ref(op, b[0], b[1], *ms(b), decay, lr, st, skip=flag,
                        **kw)
    torch.cuda.synchronize()
    for j in ((0, 2, 3) if op else (0,)):
        for i in range(len(sizes)):
            assert torch.equal(a[j][i], c[j][i])
            fu_close(a[j][i], b[j][i], f"[{j}][{i}]")


@pytest.mark.gpu
def test_fused_update_at_a_llama_shape(cuda_device):
    """4096 x 11008 in bf16 (AdamW, decay) and with f32 moments: within one
    ulp of the plain version."""
    for m_dtype in (torch.bfloat16, torch.float32):
        fu, (a, b), _ = fu_case(cuda_device, "adamw", torch.bfloat16,
                                m_dtype, [4096 * 11008])
        lr = torch.tensor(3e-4, device=cuda_device)
        st = torch.tensor(3.0, device=cuda_device)
        kw = dict(coeff=0.01)
        fu.fused_update(fu.ADAM, *a, [True], lr, st, **kw)
        fu.fused_update_ref(fu.ADAM, *b, [True], lr, st, **kw)
        torch.cuda.synchronize()
        for j, name in ((0, "p"), (2, "m1"), (3, "m2")):
            fu_close(a[j][0], b[j][0], name)


@pytest.mark.gpu
def test_fused_update_groups_by_dtype_and_follows_moved_grads(cuda_device):
    """A call over f32 and bf16 parameters launches once a group; grads at
    new addresses on a later call are read there (the table's grad
    entries are rewritten)."""
    from paddle_tpu_torch.ops.cuda import fused_update as fu
    ps = [torch.randn(100, device=cuda_device),
          torch.randn(100, device=cuda_device).bfloat16(),
          torch.randn(33, device=cuda_device)]
    ref = [p.clone() for p in ps]
    lr = torch.tensor(0.5, device=cuda_device)
    st = torch.tensor(1.0, device=cuda_device)
    cache = {}
    for k in range(3):
        gs = [torch.full_like(p, float(k + 1)) for p in ps]
        before = LAUNCH_COUNTS["fused_update"]
        fu.fused_update(fu.SGD, ps, gs, None, None, None, lr, st,
                        cache=cache)
        assert LAUNCH_COUNTS["fused_update"] - before == 2
        fu.fused_update_ref(fu.SGD, ref, gs, None, None, None, lr, st)
        del gs
    torch.cuda.synchronize()
    for p, r in zip(ps, ref):
        assert torch.equal(p, r)


@pytest.mark.gpu
def test_fused_update_refuses_what_it_cannot_take(cuda_device):
    from paddle_tpu_torch.ops.cuda import fused_update as fu
    p = torch.zeros(8, device=cuda_device)
    lr = torch.tensor(0.1, device=cuda_device)
    st = torch.tensor(1.0, device=cuda_device)
    before = dict(LAUNCH_COUNTS)
    with pytest.raises(TypeError, match="grad"):
        fu.fused_update(fu.SGD, [p], [p.half()], None, None, None, lr, st)
    with pytest.raises(TypeError, match="group"):
        fu.fused_update(fu.ADAM, [p.half()], [p.half()], [p.bfloat16()],
                        [p.bfloat16()], [False], lr, st)
    with pytest.raises(TypeError, match="0-dim float32"):
        fu.fused_update(fu.SGD, [p], [p], None, None, None, 0.1, st)
    with pytest.raises(TypeError, match="float32"):
        fu.fused_update(fu.SGD, [p.double()], [p.double()], None, None,
                        None, lr, st)
    assert LAUNCH_COUNTS == before


# -- io/worker.py's DeviceStager: the pin-memory thread's copies --------------

def stager_batches(n=12, seed=0):
    """Host batches of the train cell's kind: token ids (1, 4096) and a
    float32 block, each distinct."""
    r = np.random.RandomState(seed)
    return [[r.randint(0, 32000, (1, 4096)).astype(np.int64),
             r.randn(256, 1024).astype(np.float32)] for _ in range(n)]


@pytest.mark.gpu
def test_device_stager_batches_equal_host_data_under_concurrent_work(
        cuda_device):
    """The default stream stays busy (a device spin before every read)
    while the stager copies ahead, and each batch is dropped at once after
    its read is enqueued: without the handed-over event the read would
    see memory before its copy lands, and without ``record_stream`` the
    stager's next copy could reuse the dropped batch's memory before the
    read ran."""
    from paddle_tpu_torch.io.worker import DeviceStager
    host = stager_batches()
    reads = []
    for batch in DeviceStager(cuda_device, depth=2).stage(iter(host)):
        assert all(t.device.type == "cuda" for t in batch)
        torch.cuda._sleep(20_000_000)          # ~10 ms of device work
        reads.append([t * 1 for t in batch])   # runs after the spin
        del batch
    torch.cuda.synchronize()
    assert len(reads) == len(host)
    for got, want in zip(reads, host):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w)


@pytest.mark.gpu
def test_device_stager_consumer_waits_for_the_copy(cuda_device):
    """The stager's stream spins before each copy, so the copy lands
    ~10 ms after the batch is handed over: a read enqueued at once on the
    consumer's stream must wait for the stager's event."""
    from paddle_tpu_torch.io.worker import DeviceStager

    class SlowStager(DeviceStager):
        def _to_device(self, tree):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                torch.cuda._sleep(20_000_000)
            return super()._to_device(tree)

    host = stager_batches(4, seed=1)
    sums = [batch[1].double().sum() for batch in
            SlowStager(cuda_device, depth=2).stage(iter(host))]
    torch.cuda.synchronize()
    for got, want in zip(sums, host):
        assert got.item() == pytest.approx(want[1].astype(np.float64).sum(),
                                           rel=1e-12)
