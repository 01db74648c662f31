"""The port's attention functionals route each call by shape and dtype, and
give the reference's result on every route.

``scaled_dot_product_attention`` and ``flash_attn_unpadded``
(paddle_tpu_torch/nn/functional/attention.py) against the reference's
functions of the same names on the same numpy inputs, forward and
gradients: head dims up to 256 that are not a multiple of 16 (zero-padded
into the flash path), head dims 129..256 (the flash path, as the
reference's kernel takes them), head dims above 256, causal with Sq < Sk
and float64 (the plain path); each call's route is read from
``ROUTE_COUNTS``.  The reference takes its plain paths here (its
Pallas gate needs a TPU); the port's flash path on CPU tensors is its
kernels' plain versions.

Tolerances: float32 1e-5 relative (and 1e-5 absolute on values of O(1)):
the same f32 sums in another order.  float64 1e-10 where both compute in
f64 (``sdpa`` promotes to at least f32, so f64 stays f64).  The packed
core computes logits and softmax in float32 whatever the input type, on
both sides (``_varlen_core``: ``.astype(jnp.float32)``), so its float64
case carries two f32 softmaxes that may differ in their last bits: 1e-5,
as float32."""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core import random_state
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           load_reference_arrays)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import (ROUTE_COUNTS, attention,
                                            reset_route_counts)
from paddle_tpu_torch.ops.cuda import LAUNCH_COUNTS

TOL = {np.float32: 1e-5, np.float64: 1e-10}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.fixture(autouse=True)
def _fresh_route_counts():
    reset_route_counts()
    yield
    reset_route_counts()


@pytest.fixture
def _restore_reference_rng():
    """paddle.seed must not leak: later files in the same worker derive
    their random streams from the reference's global seed."""
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    random_state.seed(seed)
    random_state.set_rng_state(key)


def arrays(shapes, dtype, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(dtype) for s in shapes]


def reference_grads(fn, xs, do):
    """The reference's output and gradients of sum(fn(*xs) * do)."""
    ts = [paddle.to_tensor(x, dtype=str(x.dtype), stop_gradient=False)
          for x in xs]
    out = fn(*ts)
    assert str(out.dtype).endswith(str(do.dtype))
    (out * paddle.to_tensor(do, dtype=str(do.dtype))).sum().backward()
    return np.asarray(out.numpy()), [np.asarray(t.grad.numpy()) for t in ts]


def port_grads(fn, xs, do, dtype):
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = fn(*ts)
    assert out.dtype == TORCH[dtype]
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def assert_same(got, want, tol):
    out, grads = got
    wout, wgrads = want
    for name, g, w in zip(("out", "dq", "dk", "dv"), [out] + grads,
                          [wout] + wgrads):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


# (Sq, Sk, D, causal, dtype, expected route); B=2, 4 query heads over 2
# kv heads
SDPA_CASES = {
    "causal-sq4-sk8-d64": (4, 8, 64, True, np.float32,
                           "sdpa_plain:causal_rect"),
    "d8": (16, 16, 8, True, np.float32, "sdpa_flash_padded"),
    "d72": (16, 16, 72, True, np.float32, "sdpa_flash_padded"),
    "d136": (16, 16, 136, True, np.float32, "sdpa_flash_padded"),
    "d192-full": (16, 16, 192, False, np.float32, "sdpa_flash"),
    "d256": (16, 16, 256, False, np.float32, "sdpa_flash"),
    "d256-causal": (16, 16, 256, True, np.float32, "sdpa_flash"),
    "d264": (16, 16, 264, True, np.float32, "sdpa_plain:head_dim"),
    "float64": (16, 16, 16, True, np.float64, "sdpa_plain:dtype"),
}


@pytest.mark.parametrize("case", list(SDPA_CASES), ids=list(SDPA_CASES))
def test_sdpa_routes_by_shape_and_dtype_and_matches_the_reference(case):
    sq, sk, d, causal, dtype, route = SDPA_CASES[case]
    q, k, v, do = arrays([(2, sq, 4, d), (2, sk, 2, d), (2, sk, 2, d),
                          (2, sq, 4, d)], dtype, seed=sq + sk + d)
    want = reference_grads(
        lambda a, b, c: JF.scaled_dot_product_attention(
            a, b, c, is_causal=causal), (q, k, v), do)
    before = dict(LAUNCH_COUNTS)
    got = port_grads(
        lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=causal, name=None), (q, k, v), do, dtype)
    assert ROUTE_COUNTS == {route: 1}
    assert LAUNCH_COUNTS == before
    assert_same(got, want, TOL[dtype])


def test_sdpa_causal_rectangle_is_bottom_right_aligned():
    """Sq=4 < Sk=8, causal: query i sees keys j <= i + 4 (the reference's
    ``tril(k=Sk - Sq)``), so the last query sees every key and the first
    sees five; checked against a softmax over exactly those keys."""
    q, k, v = (torch.from_numpy(x) for x in arrays(
        [(1, 4, 1, 16), (1, 8, 1, 16), (1, 8, 1, 16)], np.float64, seed=1))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    for i in range(4):
        s = (q[0, i, 0] @ k[0, :i + 5, 0].T) / 4.0
        want = torch.softmax(s, -1) @ v[0, :i + 5, 0]
        torch.testing.assert_close(out[0, i, 0], want, rtol=1e-12,
                                   atol=1e-12)


def test_sdpa_counts_its_flash_route_and_accepts_name():
    q, k, v = (torch.from_numpy(x) for x in arrays(
        [(1, 16, 2, 16)] * 3, np.float32, seed=2))
    F.scaled_dot_product_attention(q, k, v, None, 0.0, True, True, None)
    F.scaled_dot_product_attention(q, k, v, attn_mask=torch.ones(
        16, 16, dtype=torch.bool), name="attn")
    assert ROUTE_COUNTS == {"sdpa_flash": 1, "sdpa_plain:mask": 1}


# (T, D, dtype, cu, expected route); 4 query heads over 2 kv heads
VARLEN_CASES = {
    "d8": (40, 8, np.float32, (0, 7, 30, 40), "varlen_flash_padded"),
    "d136": (40, 136, np.float32, (0, 9, 33, 40), "varlen_flash_padded"),
    "d256": (40, 256, np.float32, (0, 1, 25, 40), "varlen_flash"),
    "float64": (40, 16, np.float64, (0, 13, 40), "varlen_plain:dtype"),
}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", list(VARLEN_CASES),
                         ids=list(VARLEN_CASES))
def test_flash_attn_unpadded_routes_by_shape_and_dtype(case, causal):
    t, d, dtype, cu, route = VARLEN_CASES[case]
    q, k, v, do = arrays([(t, 4, d), (t, 2, d), (t, 2, d), (t, 4, d)],
                         dtype, seed=t + d)
    scale = 1.0 / math.sqrt(d)
    jcu = paddle.to_tensor(np.asarray(cu, np.int32))
    want = reference_grads(
        lambda a, b, c: JF.flash_attn_unpadded(
            a, b, c, jcu, jcu, t, t, scale, causal=causal)[0],
        (q, k, v), do)
    tcu = torch.tensor(cu, dtype=torch.int32)
    before = dict(LAUNCH_COUNTS)
    got = port_grads(
        lambda a, b, c: F.flash_attn_unpadded(
            a, b, c, tcu, tcu, t, t, scale, causal=causal)[0],
        (q, k, v), do, dtype)
    assert ROUTE_COUNTS == {route: 1}
    assert LAUNCH_COUNTS == before
    # the packed core's softmax is f32 on both sides (module docstring)
    assert_same(got, want, TOL[np.float32])


def test_llama_with_head_dim_8_matches_the_reference(_restore_reference_rng):
    """hidden 64 over 8 heads (head_dim 8, which the flash kernels take
    zero-padded to 16), GQA 8/4: the full-sequence forward takes the
    padded flash path in every layer and gives the reference's logits
    (f32, 1e-4 absolute on logits of O(1), as tests/test_torch_llama.py's
    full forward)."""
    over = dict(num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=4, max_position_embeddings=64)
    paddle.seed(11)
    jmodel = jllama.LlamaForCausalLM(jllama.llama_tiny_config(**over))
    jmodel.eval()
    port = LlamaForCausalLM(llama_tiny_config(**over), device="cpu")
    assert port.config.head_dim == 8
    load_reference_arrays(port, {n: np.asarray(p.numpy())
                                 for n, p in jmodel.named_parameters()})
    ids = np.random.default_rng(12).integers(0, 256, (2, 12))
    want = np.asarray(jmodel(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    assert ROUTE_COUNTS == {"sdpa_flash_padded": 2}
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("d", [136, 192, 256])
def test_head_dims_above_128_take_the_flash_kernels_off_the_cpu(d):
    """head_dim 129..256: the reference's kernel takes it, and so do the
    kernels here (padded to the next multiple of 16), so the gate sends a
    tensor off the CPU (a meta tensor stands in for a CUDA one) to the
    flash kernels at the padded dim and counts the route; head_dim 272
    still takes the plain path, as the reference routes it."""
    dp = -(-d // 16) * 16
    route = "flash" if dp == d else "flash_padded"
    q = torch.empty(1, 16, 4, d, device="meta")
    k = torch.empty(1, 16, 2, d, device="meta")
    assert attention._flash_gate("sdpa", q, k, True) == dp
    assert attention._flash_gate("varlen", q[0], k[0], False) == dp
    assert ROUTE_COUNTS == {f"sdpa_{route}": 1, f"varlen_{route}": 1}
    reset_route_counts()
    q = torch.empty(1, 16, 4, 272, device="meta")
    assert attention._flash_gate("sdpa", q, q, True) is None
    assert ROUTE_COUNTS == {"sdpa_plain:head_dim": 1}
