"""Ragged paged attention decode: the port's plain version and wrapper
(paddle_tpu_torch/ops/cuda/attention.py) against the JAX package's Pallas
kernel run in interpret mode, plus the wrapper's refusals and the edge
cases the CUDA kernel must meet.  The kernel itself runs only on a card
(tests/test_torch_cuda_kernels.py)."""

import math

import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.attention import \
    ragged_paged_attention_decode as jax_rpa
from paddle_tpu_torch.ops.cuda.attention import (
    LAUNCH_COUNTS, ragged_paged_attention_decode,
    ragged_paged_attention_decode_ref)

# f32 on both sides; they differ only in summation order
ATOL = RTOL = 1e-5


def make_case(seed, heads, kv_heads, lens, d=32, page=4, max_pages=6,
              num_pages=32, garbage=300.0):
    """numpy inputs: each sequence owns distinct random pages (never page
    0); table tails padded with page 0, which holds large garbage."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    shape = (num_pages, page, kv_heads, d)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    k[0] = garbage
    v[0] = -garbage
    bt = np.zeros((b, max_pages), np.int32)
    for i, n in enumerate(lens):
        owned = math.ceil(n / page)
        bt[i, :owned] = rng.choice(np.arange(1, num_pages), owned,
                                   replace=False)
    return q, k, v, bt, np.asarray(lens, np.int32)


def run_jax(q, k, v, bt, sl, scale=None):
    return np.asarray(jax_rpa(q, k, v, bt, sl, scale, interpret=True))


def run_port(fn, q, k, v, bt, sl):
    t = [torch.from_numpy(a) for a in (q, k, v, bt, sl)]
    return fn(*t).numpy()


def dense_reference(q, k, v, bt, sl):
    """Independent numpy per-sequence softmax attention over exactly the
    first len tokens (float64)."""
    b, h, d = q.shape
    page, hkv = k.shape[1], k.shape[2]
    out = np.zeros((b, h, d))
    for i in range(b):
        n = int(sl[i])
        if n == 0:
            continue
        rows = [(bt[i, p // page], p % page) for p in range(n)]
        kk = np.stack([k[pg, off] for pg, off in rows]).astype(np.float64)
        vv = np.stack([v[pg, off] for pg, off in rows]).astype(np.float64)
        for j in range(h):
            s = kk[:, j // (h // hkv)] @ q[i, j] / math.sqrt(d)
            p = np.exp(s - s.max())
            out[i, j] = p @ vv[:, j // (h // hkv)] / p.sum()
    return out


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 4)],
                         ids=["gqa4q2kv", "mha"])
def test_plain_version_matches_pallas_kernel(heads, kv_heads):
    # ragged: an inert row, length 1, lengths at and past a page boundary,
    # and a full table (6 pages x 4)
    case = make_case(0, heads, kv_heads, [0, 1, 4, 5, 13, 24])
    want = run_jax(*case)
    got = run_port(ragged_paged_attention_decode_ref, *case)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.all(got[0] == 0.0) and np.all(want[0] == 0.0)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    case = make_case(1, 4, 2, [3, 0, 17, 8])
    before = dict(LAUNCH_COUNTS)
    got = run_port(ragged_paged_attention_decode, *case)
    want = run_port(ragged_paged_attention_decode_ref, *case)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, run_jax(*case), atol=ATOL, rtol=RTOL)
    assert np.all(got[1] == 0.0)
    # the plain version is no kernel launch
    assert LAUNCH_COUNTS == before


@pytest.mark.parametrize("lens", [[4, 8, 24], [1, 1, 1], [24, 0, 1]],
                         ids=["page_boundaries", "length_one",
                              "full_table_and_inert"])
def test_edge_cases_against_dense_reference(lens):
    """The cases the CUDA kernel is held to on the card as well: lengths
    exactly at a page boundary, length 1, and tables whose padded tail
    points at page 0 full of garbage (300.0) that must never leak in."""
    case = make_case(2, 4, 2, lens)
    want = dense_reference(*case)
    got = run_port(ragged_paged_attention_decode, *case)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(run_jax(*case), want, atol=ATOL, rtol=RTOL)


def test_bfloat16_plain_version_rounds_once_from_f32():
    q, k, v, bt, sl = make_case(3, 4, 2, [5, 9, 0])
    t = [torch.from_numpy(a) for a in (q, k, v, bt, sl)]
    qb, kb, vb = (x.to(torch.bfloat16) for x in t[:3])
    got = ragged_paged_attention_decode(qb, kb, vb, t[3], t[4])
    assert got.dtype == torch.bfloat16
    want = ragged_paged_attention_decode_ref(qb.float(), kb.float(),
                                             vb.float(), t[3], t[4])
    assert torch.equal(got, want.to(torch.bfloat16))


def test_wrapper_refusals():
    q, k, v, bt, sl = (torch.from_numpy(a)
                       for a in make_case(4, 4, 2, [3, 5]))
    with pytest.raises(ValueError, match="head_dim 272"):
        big = torch.zeros(2, 4, 272)
        pages = torch.zeros(8, 4, 2, 272)
        ragged_paged_attention_decode(big, pages, pages, bt, sl)
    with pytest.raises(TypeError, match="one dtype"):
        ragged_paged_attention_decode(q, k.to(torch.bfloat16), v, bt, sl)
    with pytest.raises(TypeError, match="unsupported dtype"):
        ragged_paged_attention_decode(q.double(), k.double(), v.double(),
                                      bt, sl)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ragged_paged_attention_decode(q[:, :3], k, v, bt, sl)
    with pytest.raises(ValueError, match="block_tables"):
        ragged_paged_attention_decode(q, k, v, bt[:1], sl)
    with pytest.raises(ValueError, match="one device"):
        ragged_paged_attention_decode(q.to("meta"), k, v, bt, sl)


@pytest.mark.parametrize("scale", [0.0, None], ids=["zero", "none"])
def test_falsy_scale_means_the_default_as_in_the_reference(scale):
    """The reference reads ``scale or 1 / sqrt(d)``: scale=0.0 is the
    default there, and so in the wrapper and the plain version here."""
    case = make_case(5, 4, 4, [6, 11])
    t = [torch.from_numpy(a) for a in case]
    want = run_jax(*case, scale=scale)
    np.testing.assert_allclose(run_jax(*case), want, atol=0, rtol=0)
    for fn in (ragged_paged_attention_decode,
               ragged_paged_attention_decode_ref):
        got = fn(*t, scale=scale).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
