"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither jax nor paddle_tpu, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Without a CUDA device every test here skips (decided in a fixture)."""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda.attention import (
    LAUNCH_COUNTS, ragged_paged_attention_decode,
    ragged_paged_attention_decode_ref)

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
