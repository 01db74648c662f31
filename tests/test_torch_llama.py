"""The port's Llama pieces (paddle_tpu_torch: rms_norm, rope_at, the paged
KV ops, the prefill gather attention, the full model) against the JAX
package on the same numpy inputs and the same weights."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.core import random_state
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn.functional.norm import _rms_fwd
from paddle_tpu.serving import attention as jattn
from paddle_tpu_torch.models.llama import (LlamaForCausalLM, _rope_tables,
                                           llama_tiny_config,
                                           load_reference_arrays, rope_at)
from paddle_tpu_torch.nn.functional import rms_norm
from paddle_tpu_torch.serving.attention import (paged_attention_torch,
                                                paged_kv_copy,
                                                paged_kv_update)


@pytest.fixture(autouse=True)
def _restore_reference_rng():
    """paddle.seed below must not leak: later files in the same worker
    derive their random streams from the reference's global seed."""
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    random_state.seed(seed)
    random_state.set_rng_state(key)


def rng(seed=0):
    return np.random.default_rng(seed)


def test_rms_norm_float32():
    r = rng(0)
    x = r.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = r.standard_normal(64).astype(np.float32)
    want = np.asarray(_rms_fwd(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_rms_norm_bfloat16_casts_before_the_weight():
    """bf16: normalise in f32, cast to bf16, THEN multiply by the weight —
    two bf16 roundings, as the reference does.  The f32 normalisations may
    differ in their last bits, so outputs may sit one or two bf16 ulps
    apart: |diff| <= 2^-6 |ref|."""
    r = rng(1)
    x = r.standard_normal((4, 64)).astype(np.float32) * 3
    w = r.standard_normal(64).astype(np.float32)
    want = np.asarray(_rms_fwd(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(w, jnp.bfloat16), 1e-5)
                      .astype(jnp.float32))
    got = rms_norm(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(w).bfloat16(), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0,
                               rtol=2 ** -6)
    # the weight multiply happens in bf16, on the already-cast value
    xn = rms_norm(torch.from_numpy(x).bfloat16(), None, 1e-5)
    assert xn.dtype == torch.bfloat16
    assert torch.equal(got, xn * torch.from_numpy(w).bfloat16())


def test_rope_at_random_positions_rotates_interleaved_pairs():
    r = rng(2)
    d, max_len = 16, 64
    x = r.standard_normal((3, 5, 4, d)).astype(np.float32)
    pos = r.integers(0, max_len, (3, 5)).astype(np.int32)
    jcos, jsin = jllama._rope_tables(d, max_len, 10000.0)
    want = np.asarray(jllama._rope_at_fwd(jnp.asarray(x), jcos, jsin,
                                          jnp.asarray(pos)))
    cos, sin = _rope_tables(d, max_len, 10000.0, "cpu")
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    got = rope_at(torch.from_numpy(x), cos, sin,
                  torch.from_numpy(pos).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # interleaved pairs, not rotate-half: position 0 is the identity and
    # pair (0, 1) mixes only with itself
    zero = rope_at(torch.from_numpy(x), cos, sin,
                   torch.zeros(3, 5, dtype=torch.long)).numpy()
    np.testing.assert_array_equal(zero, x)


def test_paged_kv_update_matches_reference():
    r = rng(3)
    pages = r.standard_normal((8, 4, 2, 8)).astype(np.float32)
    k_new = r.standard_normal((2, 3, 2, 8)).astype(np.float32)
    v_new = r.standard_normal((2, 3, 2, 8)).astype(np.float32)
    # two padding rows aim at the page-0 sink
    sp = np.asarray([3, 3, 5, 0, 7, 0], np.int32)
    so = np.asarray([0, 1, 3, 0, 2, 0], np.int32)
    jk, jv = jattn._paged_kv_update_fwd(
        jnp.asarray(pages), jnp.asarray(pages), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(sp), jnp.asarray(so))
    tk, tv = torch.from_numpy(pages.copy()), torch.from_numpy(pages.copy())
    paged_kv_update(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
                    torch.from_numpy(sp), torch.from_numpy(so))
    # page 0 takes duplicate garbage writes in an unspecified order
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])


def test_paged_kv_copy_gathers_before_writing():
    r = rng(4)
    pages = r.standard_normal((8, 4, 2, 8)).astype(np.float32)
    # page 5 is both a destination and a later copy's source: page 7 must
    # receive page 5's PRE-step content; (0, 0) is a padding no-op
    src = np.asarray([3, 5, 0], np.int32)
    dst = np.asarray([5, 7, 0], np.int32)
    jk, _ = jattn._paged_kv_copy_fwd(jnp.asarray(pages), jnp.asarray(pages),
                                     jnp.asarray(src), jnp.asarray(dst))
    tk, tv = torch.from_numpy(pages.copy()), torch.from_numpy(pages.copy())
    paged_kv_copy(tk, tv, torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tk.numpy()[7], pages[5])


def test_prefill_gather_attention_matches_reference():
    r = rng(5)
    b, s, h, hkv, d, page, p = 3, 5, 4, 2, 16, 4, 4
    q = r.standard_normal((b, s, h, d)).astype(np.float32)
    k = r.standard_normal((16, page, hkv, d)).astype(np.float32)
    v = r.standard_normal((16, page, hkv, d)).astype(np.float32)
    bt = np.asarray([[3, 9, 0, 0], [5, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    sl = np.asarray([7, 3, 0], np.int32)           # row 2: no valid key
    qp = np.asarray([[2, 3, 4, 5, 6], [0, 1, 2, 2, 2], [0] * 5], np.int32)
    want = np.asarray(jattn.paged_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(sl), jnp.asarray(qp), 0.25))
    got = paged_attention_torch(*(torch.from_numpy(a) for a in
                                  (q, k, v, bt, sl, qp)), 0.25).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.all(got[2] == 0.0)


def reference_model(layers=2, max_pos=64, seed=7):
    paddle.seed(seed)
    model = jllama.LlamaForCausalLM(jllama.llama_tiny_config(
        num_hidden_layers=layers, max_position_embeddings=max_pos))
    model.eval()
    arrays = {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}
    return model, arrays


def test_full_forward_logits_match_reference_weights():
    jmodel, arrays = reference_model()
    port = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=2,
                                              max_position_embeddings=64),
                            device="cpu")
    load_reference_arrays(port, arrays)
    ids = rng(6).integers(0, 256, (2, 12))
    want = np.asarray(jmodel(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 12, 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_load_reference_arrays_refuses_mismatches():
    _, arrays = reference_model()
    port = LlamaForCausalLM(llama_tiny_config(num_hidden_layers=2,
                                              max_position_embeddings=64),
                            device="cpu")
    before = {n: p.clone() for n, p in port.named_parameters()}
    renamed = dict(arrays)
    renamed["llama.layers.0.self_attn.query.weight"] = renamed.pop(
        "llama.layers.0.self_attn.q_proj.weight")
    with pytest.raises(KeyError, match="q_proj"):
        load_reference_arrays(port, renamed)
    reshaped = dict(arrays)
    reshaped["lm_head.weight"] = reshaped["lm_head.weight"].T
    with pytest.raises(ValueError, match="lm_head.weight"):
        load_reference_arrays(port, reshaped)
    for n, p in port.named_parameters():
        assert torch.equal(p, before[n]), n    # nothing half-loaded


def test_initialisation_is_xavier_normal_and_seeded():
    cfg = llama_tiny_config(num_hidden_layers=1)
    a = LlamaForCausalLM(cfg, device="cpu", seed=3)
    b = LlamaForCausalLM(cfg, device="cpu", seed=3)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    w = a.llama.layers[0].mlp.gate_proj.weight      # (64, 160), (in, out)
    assert tuple(w.shape) == (64, 160)
    assert abs(w.std().item() - (2.0 / (64 + 160)) ** 0.5) < 0.01
    assert torch.equal(a.llama.norm.weight, torch.ones(64))


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny_config())
