"""The quantized matmul's route rule (ops/cuda/quant_matmul.py
``qmm_route``) and the argument that its tensor-core route keeps the
reference's result: integer codes are exact in bf16 and fp16, so 16-bit
products summed in f32 a group at a time, each group's sum then times its
scale, agree with the reference's Pallas kernel (interpret mode), which
multiplies x by code x scale in f32, up to f32 rounding.  The CUDA kernel
itself runs only on a card (tests/test_torch_cuda_kernels.py)."""

import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import quant_matmul as jqmm
from paddle_tpu.quantize import core as jcore
from paddle_tpu_torch.ops.cuda.quant_matmul import (qmm_route,
                                                    quant_matmul_ref)
from paddle_tpu_torch.quantize.core import dequantize_weight, quantize_weight
from test_torch_cuda_kernels import QMM_TC_MIN_OUT, QMM_TC_REL

# the tensor-core order against the reference's f32 order: both f32, the
# products exact in both; they differ in the order and place of rounding
# (about 3e-7 relative L2 at K = 512)
TC_ORDER_REL = 1e-5


@pytest.mark.parametrize("dtype,group,route", [
    (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 96, "tensor_cores"),
    (torch.bfloat16, 8, "fma"),
    (torch.bfloat16, 3, "fma"),
    (torch.float16, 128, "tensor_cores"),
    (torch.float16, 96, "tensor_cores"),
    (torch.float16, 8, "fma"),
    (torch.float16, 3, "fma"),
    (torch.float32, 128, "fma"),
    (torch.float32, 96, "fma"),
    (torch.float32, 8, "fma"),
    (torch.float32, 3, "fma"),
])
def test_qmm_route_by_dtype_and_group(dtype, group, route):
    assert qmm_route(dtype, group) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [8, 4])
def test_every_code_is_exact_in_16_bits(bits, dtype):
    codes = torch.arange(-128 if bits == 8 else -8, 128 if bits == 8 else 8,
                         dtype=torch.float32)
    assert torch.equal(codes.to(dtype).to(torch.float32), codes)


def tensor_core_order(x, q, s, bits, group, dtype):
    """The tensor-core kernel's arithmetic: codes (unscaled) and x in the
    16-bit type, each group's products summed in f32 (each product is
    exact: at most 8 + 11 significant bits), the group's scale applied to
    that sum, the groups added in f32."""
    k = x.shape[1]
    groups = s.shape[0]
    codes = dequantize_weight(torch.from_numpy(q),
                              torch.ones(groups, q.shape[1]), bits, group,
                              groups * group)
    c16 = codes.to(dtype).to(torch.float32)
    assert torch.equal(c16, codes)
    x16 = torch.zeros(x.shape[0], groups * group)
    x16[:, :k] = torch.from_numpy(x).to(dtype).to(torch.float32)
    scales = torch.from_numpy(s)
    out = torch.zeros(x.shape[0], q.shape[1])
    for g in range(groups):
        rows = slice(g * group, (g + 1) * group)
        out += scales[g] * (x16[:, rows] @ c16[rows])
    return out.numpy()


def qmm_case(bits, dtype, m=8, k=512, n=256, group=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    # x as the kernel sees it: already 16-bit
    x = torch.from_numpy(x).to(dtype).to(torch.float32).numpy()
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    q, s, g = jcore.quantize_weight(w, bits=bits, group=group)
    assert jqmm.fallback_reason(m, k, n, bits, g) is None
    return x, np.asarray(q), np.asarray(s), g


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [8, 4])
def test_tensor_core_order_matches_pallas_kernel(bits, dtype):
    x, q, s, g = qmm_case(bits, dtype)
    want = np.asarray(jqmm.quant_matmul_pallas(x, q, s, bits=bits, group=g,
                                               interpret=True))
    got = tensor_core_order(x, q, s, bits, g, dtype)
    assert rel_l2(got, want) <= TC_ORDER_REL, rel_l2(got, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_tensor_core_order_matches_registered_kernel_path(bits,
                                                          monkeypatch):
    """The same through the reference's registered forward with its
    kernel in interpret mode (the flag set only for this test)."""
    monkeypatch.setattr(jqmm, "_PALLAS_INTERPRET", True)
    x, q, s, g = qmm_case(bits, torch.bfloat16, seed=1)
    want = np.asarray(jqmm._quant_matmul_fwd(x, q, s, bits=bits, group=g,
                                             kernel=True))
    got = tensor_core_order(x, q, s, bits, g, torch.bfloat16)
    assert rel_l2(got, want) <= TC_ORDER_REL, rel_l2(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [8, 4])
def test_card_bar_separates_exact_codes_from_rounded_weights(bits, dtype):
    """The card's tighter bar on the tensor-core route (QMM_TC_REL, 16-bit
    outputs against the plain version's) passes the exact order and fails
    codes scaled into 16 bits before the product (c * s rounded: the
    usual weight-only kernels' order), at the bar's least output size."""
    m, k, n, group = 8, 4096, QMM_TC_MIN_OUT // 8, 128
    g = torch.Generator().manual_seed(bits)
    w = torch.randn(k, n, generator=g) * 0.02
    x = torch.randn(m, k, generator=g).to(dtype)
    qw, s, grp = quantize_weight(w, bits=bits, group=group)
    want = quant_matmul_ref(x, qw, s, bits=bits, group=grp).float()
    exact = torch.from_numpy(tensor_core_order(
        x.float().numpy(), qw.numpy(), s.numpy(), bits, grp,
        dtype)).to(dtype).float()
    w16 = dequantize_weight(qw, s, bits, grp, k).to(dtype).float()
    rounded = (x.float() @ w16).to(dtype).float()

    def rel(a):
        return ((a - want).norm() / want.norm()).item()
    print(f"int{bits} {str(dtype).replace('torch.', '')}: exact "
          f"{rel(exact):.3e}, rounded weights {rel(rounded):.3e}")
    assert rel(exact) <= QMM_TC_REL[dtype] < rel(rounded), (rel(exact),
                                                             rel(rounded))
