"""Quantized serving in the port (paddle_tpu_torch/quantize,
ops/cuda/quant_matmul.py, the int8 paths of ops/cuda/attention.py and
serving/) against the JAX package on the same numpy inputs and weights:
the codec byte for byte, the quantized matmul's plain version against the
Pallas kernels (interpret mode) and their XLA twin, quantize_for_inference
layer by layer, the int8 KV pool's writes and decode attention, and
generate() token for token.  Outputs are held to the reference's
QUANTIZED outputs, never to fp32 tokens.  The CUDA kernels themselves run
only on a card (tests/test_torch_cuda_kernels.py)."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import random_state
from paddle_tpu.jit import compile_cache as cc
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.op import apply as jax_apply
from paddle_tpu.ops.pallas import quant_matmul as jqmm
from paddle_tpu.ops.pallas.attention import \
    ragged_paged_attention_decode as jax_rpa
from paddle_tpu.quantize import core as jcore
from paddle_tpu.quantize.layers import \
    quantize_for_inference as jax_quantize
from paddle_tpu.serving import attention as jattn
from paddle_tpu.serving.engine import ServingEngine as JaxEngine
from paddle_tpu.serving.kv_cache import PagedKVCache as JaxKV
from paddle_tpu.telemetry import flight_recorder as fr
from paddle_tpu.telemetry import metrics
from paddle_tpu.utils.monitor import stat_reset
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           load_reference_arrays)
from paddle_tpu_torch.ops.cuda.attention import (
    LAUNCH_COUNTS, ragged_paged_attention_decode,
    ragged_paged_attention_decode_ref)
from paddle_tpu_torch.ops.cuda.quant_matmul import (quant_matmul,
                                                    quant_matmul_ref,
                                                    use_quant_kernel)
from paddle_tpu_torch.quantize import calibration as tcalib
from paddle_tpu_torch.quantize import core as tcore
from paddle_tpu_torch.quantize.layers import (QuantizedEmbedding,
                                              QuantizedLinear,
                                              quantize_for_inference)
from paddle_tpu_torch.serving.attention import (paged_attention_torch,
                                                paged_kv_update_quant)
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.kv_cache import PagedKVCache

QUANT_FLAGS = {"serving_kv_quant": "off", "weight_quant_kernel": "auto",
               "weight_quant_group": 128, "serving_use_rpa_kernel": "auto",
               "serving_prefix_cache": "on"}


@pytest.fixture(autouse=True)
def _restore():
    """Neither package's flags, seed or serving globals may leak out of a
    test (later files in the same worker read the reference's seed)."""
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    random_state.seed(seed)
    random_state.set_rng_state(key)
    paddle.set_flags(QUANT_FLAGS)
    tflags.set_flags(QUANT_FLAGS)
    jattn._PALLAS_INTERPRET = False
    jqmm._PALLAS_INTERPRET = False
    fr.configure(fr.DEFAULT_SIZE)
    metrics.default_registry().reset()
    stat_reset()
    cc.reset_trace_counts()


def set_both(flags):
    paddle.set_flags(flags)
    tflags.set_flags(flags)


def same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

WEIGHT_CASES = [
    # (in, out, bits, group, clip)
    (256, 512, 8, 128, None),
    (256, 512, 4, 128, None),
    (100, 33, 8, 32, None),            # in not a group multiple
    (160, 48, 4, 8, None),
    (21, 10, 4, 3, None),              # odd group under int4: +1 group
    (96, 64, 8, 32, 1.5),              # clip
    (50, 20, 8, None, None),           # one group over the whole in dim
]


@pytest.mark.parametrize("k,n,bits,group,clip", WEIGHT_CASES,
                         ids=["i8", "i4", "i8_ragged_k", "i4_g8",
                              "i4_odd_group", "i8_clip", "i8_one_group"])
def test_quantize_weight_is_byte_identical(k, n, bits, group, clip):
    rng = np.random.default_rng(k * n + bits)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 0] = 0.0                       # an all-zero group: scale 1/maxq
    q, s, g = jcore.quantize_weight(w, bits=bits, group=group, clip=clip)
    tq, ts, tg = tcore.quantize_weight(torch.from_numpy(w), bits=bits,
                                       group=group, clip=clip)
    assert tg == g
    assert same_bytes(tq.numpy(), q) and same_bytes(ts.numpy(), s)
    back = np.asarray(jcore.dequantize_weight(q, s, bits, g, k))
    assert same_bytes(tcore.dequantize_weight(tq, ts, bits, tg, k).numpy(),
                      back)


def test_quantize_weight_refuses_a_vector_and_bad_bits():
    with pytest.raises(ValueError, match="2-D"):
        tcore.quantize_weight(torch.zeros(8), bits=8)
    with pytest.raises(ValueError, match="bits"):
        tcore.quantize_weight(torch.zeros(8, 8), bits=6)


def test_int4_pack_and_unpack_are_byte_identical():
    rng = np.random.default_rng(3)
    q = rng.integers(-8, 8, (6, 10)).astype(np.int8)
    packed = jcore.np_pack_int4(q)
    assert same_bytes(tcore.np_pack_int4(q), packed)
    assert same_bytes(tcore.pack_int4(torch.from_numpy(q)).numpy(), packed)
    for n in (10, 9):
        assert same_bytes(
            tcore.unpack_int4(torch.from_numpy(packed), n).numpy(),
            np.asarray(jcore.unpack_int4(packed, n)))
    with pytest.raises(ValueError, match="even"):
        tcore.pack_int4(torch.zeros(2, 3, dtype=torch.int8))


def test_quantize_kv_rows_is_byte_identical():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((5, 7, 2, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    want_q, want_s = jcore.np_quantize_kv_rows(x)
    jq, js = jcore.quantize_kv_rows(x)
    assert same_bytes(np.asarray(jq), want_q)
    assert same_bytes(np.asarray(js), want_s)
    tq, ts = tcore.quantize_kv_rows(torch.from_numpy(x))
    assert same_bytes(tq.numpy(), want_q) and same_bytes(ts.numpy(), want_s)
    nq, ns = tcore.np_quantize_kv_rows(x)
    assert same_bytes(nq, want_q) and same_bytes(ns, want_s)


# ---------------------------------------------------------------------------
# quant_matmul: plain version vs the Pallas kernels and their XLA twin
# ---------------------------------------------------------------------------

# both sides f32; they differ in summation order only
QMM_ATOL = QMM_RTOL = 1e-5


def qmm_case(m, k, n, bits, group, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    q, s, g = jcore.quantize_weight(w, bits=bits, group=group)
    return x, q, s, g


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_plain_matches_pallas_kernel(bits):
    x, q, s, g = qmm_case(8, 256, 512, bits, 128)
    assert jqmm.fallback_reason(8, 256, 512, bits, g) is None
    want = np.asarray(jqmm.quant_matmul_pallas(x, q, s, bits=bits, group=g,
                                               interpret=True))
    t = [torch.from_numpy(a) for a in (x, q, s)]
    got = quant_matmul_ref(*t, bits=bits, group=g).numpy()
    np.testing.assert_allclose(got, want, atol=QMM_ATOL, rtol=QMM_RTOL)
    # the wrapper on CPU tensors is the plain version, and no launch
    before = dict(LAUNCH_COUNTS)
    np.testing.assert_array_equal(quant_matmul(*t, bits=bits, group=g)
                                  .numpy(), got)
    assert LAUNCH_COUNTS == before


@pytest.mark.parametrize("m,k,n,bits,group", [
    (8, 96, 64, 8, 128),       # group clamps to K; K not lane-aligned
    (256, 160, 48, 8, 8),      # the tiny model's shapes
    (1, 160, 48, 4, 8),
    (3, 21, 10, 4, 3),         # odd group, padded K under int4
], ids=["i8_k96", "i8_m256_g8", "i4_m1_g8", "i4_odd_group"])
def test_quant_matmul_plain_matches_xla_where_the_kernel_refuses(
        m, k, n, bits, group):
    x, q, s, g = qmm_case(m, k, n, bits, group, seed=1)
    assert jqmm.fallback_reason(m, k, n, bits, g) is not None
    want = np.asarray(jqmm.quant_matmul_xla(x, q, s, bits=bits, group=g))
    t = [torch.from_numpy(a) for a in (x, q, s)]
    got = quant_matmul(*t, bits=bits, group=g)
    np.testing.assert_allclose(got.numpy(), want, atol=QMM_ATOL,
                               rtol=QMM_RTOL)


def test_quant_matmul_keeps_leading_dims_and_dtype():
    x, q, s, g = qmm_case(6, 64, 40, 8, 16, seed=2)
    xb = torch.from_numpy(x).reshape(2, 3, 64).to(torch.bfloat16)
    t = [torch.from_numpy(a) for a in (q, s)]
    got = quant_matmul(xb, *t, bits=8, group=g)
    assert got.shape == (2, 3, 40) and got.dtype == torch.bfloat16
    want = quant_matmul_ref(xb.float(), *t, bits=8, group=g)
    assert torch.equal(got, want.to(torch.bfloat16))


def test_quant_matmul_refusals():
    x, q, s, g = qmm_case(4, 64, 32, 8, 16, seed=3)
    x, q, s = (torch.from_numpy(a) for a in (x, q, s))
    with pytest.raises(ValueError, match="bits"):
        quant_matmul(x, q, s, bits=2, group=g)
    with pytest.raises(ValueError, match="needs codes"):
        quant_matmul(x, q, s[:-1], bits=8, group=g)
    with pytest.raises(ValueError, match="needs codes"):
        quant_matmul(x, q, s, bits=8, group=32)
    with pytest.raises(ValueError, match="needs codes"):
        quant_matmul(x[:, :40], q, s, bits=8, group=g)
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(x, q.float(), s, bits=8, group=g)
    with pytest.raises(TypeError, match="float32"):
        quant_matmul(x, q, s.double(), bits=8, group=g)
    with pytest.raises(ValueError, match="one device"):
        quant_matmul(x.to("meta"), q, s, bits=8, group=g)


def test_use_quant_kernel_flag_modes():
    assert use_quant_kernel("cpu") is False
    assert use_quant_kernel(torch.device("cuda", 0)) is True
    tflags.set_flags({"weight_quant_kernel": "on"})
    assert use_quant_kernel("cpu") is True
    tflags.set_flags({"weight_quant_kernel": "off"})
    assert use_quant_kernel(torch.device("cuda", 0)) is False


# ---------------------------------------------------------------------------
# quantize_for_inference on the tiny Llama
# ---------------------------------------------------------------------------

def model_pair(layers=2, max_pos=64, **cfg):
    paddle.seed(1234)
    jmodel = jllama.LlamaForCausalLM(jllama.llama_tiny_config(
        num_hidden_layers=layers, max_position_embeddings=max_pos, **cfg))
    jmodel.eval()
    port = LlamaForCausalLM(llama_tiny_config(
        num_hidden_layers=layers, max_position_embeddings=max_pos, **cfg),
        device="cpu")
    load_reference_arrays(port, {n: np.asarray(p.numpy())
                                 for n, p in jmodel.named_parameters()})
    return jmodel, port


def assert_same_quantized_params(jmodel, port):
    want = {n: np.asarray(p.numpy()) for n, p in jmodel.named_parameters()}
    got = {n: p.detach().numpy() for n, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        assert same_bytes(got[name], want[name]), name


# the reference's Llama builds the tensor-parallel layers, whose quantized
# twins carry their own names; the port's builds plain Linear/Embedding
KIND = {"QuantizedColumnParallelLinear": "QuantizedLinear",
        "QuantizedRowParallelLinear": "QuantizedLinear",
        "QuantizedVocabParallelEmbedding": "QuantizedEmbedding"}


def assert_same_report(got, want):
    assert got["skipped"] == want["skipped"]
    assert got["bytes_saved"] == want["bytes_saved"]
    assert got["bits"] == want["bits"] and got["group"] == want["group"]
    assert sorted(got["layers"]) == sorted(want["layers"])
    for path, w in want["layers"].items():
        g = got["layers"][path]
        assert (g["kind"], g["bits"], g["bytes_before"], g["bytes_after"]) \
            == (KIND.get(w["kind"], w["kind"]), w["bits"], w["bytes_before"],
                w["bytes_after"]), path
        assert abs(g["snr_db"] - w["snr_db"]) <= 1e-4, path
    for key in ("snr_db_min", "snr_db_median"):
        assert abs(got[key] - want[key]) <= 1e-4, key


@pytest.mark.parametrize("bits,group", [(8, 8), (4, 8), (8, None)],
                         ids=["int8_g8", "int4_g8", "int8_flag_group"])
def test_quantize_for_inference_matches_reference(bits, group):
    jmodel, port = model_pair()
    want = jax_quantize(jmodel, bits=bits, group=group)
    got = quantize_for_inference(port, bits=bits, group=group)
    assert len(got["layers"]) == 16    # 7 Linears a layer x 2 + emb + head
    assert_same_report(got, want)
    assert_same_quantized_params(jmodel, port)
    assert isinstance(port.lm_head, QuantizedLinear)
    assert isinstance(port.llama.embed_tokens, QuantizedEmbedding)
    assert got["snr_db_min"] > (30.0 if bits == 8 else 10.0)
    # decided at construction: the plain path on the CPU
    assert port.lm_head.kernel is False


@pytest.mark.parametrize("skip", [("lm_head",), ("mlp",), ("layers.1",)])
def test_quantize_for_inference_skip_patterns(skip):
    jmodel, port = model_pair()
    want = jax_quantize(jmodel, bits=8, group=8, skip=skip)
    got = quantize_for_inference(port, bits=8, group=8, skip=skip)
    assert got["skipped"] and got["skipped"] == want["skipped"]
    assert_same_report(got, want)
    assert_same_quantized_params(jmodel, port)


def test_tied_embedding_is_skipped_like_the_reference():
    jmodel, port = model_pair(tie_word_embeddings=True)
    want = jax_quantize(jmodel, bits=8, group=8)
    got = quantize_for_inference(port, bits=8, group=8)
    assert [e["layer"] for e in got["skipped"]] == ["llama.embed_tokens"]
    assert_same_report(got, want)
    assert_same_quantized_params(jmodel, port)


def test_percentile_scales_from_a_calibration_dump(tmp_path):
    from paddle_tpu.telemetry.numerics import dump_calibration
    jmodel, port = model_pair()
    path = str(tmp_path / "calib.json")
    dump_calibration(jmodel, path)
    kw = dict(scale_method="percentile:99.9", bits=8, group=8)
    want = jax_quantize(jmodel, calibration=path, **kw)
    got = quantize_for_inference(port, calibration=path, **kw)
    assert_same_report(got, want)
    assert_same_quantized_params(jmodel, port)
    # the percentile really clipped: the scales differ from absmax ones
    _, fresh = model_pair()
    absmax = quantize_for_inference(fresh, bits=8, group=8)
    assert got["snr_db_min"] != absmax["snr_db_min"]
    # a payload loads as the file does; another schema is refused
    payload = json.load(open(path))
    assert tcalib.load(payload) is payload
    assert tcalib.load(payload["params"])["schema"] == \
        tcalib.CALIBRATION_SCHEMA
    with pytest.raises(ValueError, match="schema"):
        tcalib.load({"schema": "other/1", "params": {}})
    with pytest.raises(ValueError, match="calibration"):
        quantize_for_inference(model_pair()[1],
                               scale_method="percentile:99.9")


def test_quantized_logits_match_reference():
    jmodel, port = model_pair()
    jax_quantize(jmodel, bits=8, group=8)
    quantize_for_inference(port, bits=8, group=8)
    ids = np.random.default_rng(5).integers(1, 256, (2, 24)).astype(np.int64)
    want = np.asarray(jmodel(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the int8 KV pool
# ---------------------------------------------------------------------------

def test_int8_pool_layout_and_bytes_match_reference():
    kw = dict(block_size=4, num_blocks=16, max_seq_len=32)
    set_both({"serving_kv_quant": "int8"})
    ref = JaxKV(num_layers=2, num_kv_heads=2, head_dim=8, **kw)
    port = PagedKVCache(2, 2, 8, device="cpu", **kw)
    assert port.quantized and ref.quantized
    assert port.k_pages[0].dtype == torch.int8
    assert tuple(port.k_scales[0].shape) == tuple(ref.k_scales[0].shape) \
        == (16, 4, 2, 1)
    assert port.v_scales[1].dtype == torch.float32
    assert port.pool_bytes() == ref.pool_bytes()
    assert [len(p) for p in port.layer_pools()] == [4, 4]
    set_both({"serving_kv_quant": "off"})
    plain = PagedKVCache(2, 2, 8, device="cpu", **kw)
    assert not plain.quantized and plain.k_scales is None
    assert plain.pool_bytes() == JaxKV(num_layers=2, num_kv_heads=2,
                                       head_dim=8, **kw).pool_bytes()
    assert plain.pool_bytes() / port.pool_bytes() >= 2.0


def test_paged_kv_update_quant_is_byte_identical():
    """Byte for byte against the reference op's own function run eagerly.
    Its registered op runs compiled, and XLA turns ``amax / 127`` into
    ``amax * f32(1/127)``: those scales may sit one f32 ulp off the codec's
    (and so a code one step off where x / scale lies on a rounding
    boundary); the port keeps the codec's division."""
    rng = np.random.default_rng(6)
    shape, sshape = (8, 4, 2, 16), (8, 4, 2, 1)
    pools = [np.zeros(shape, np.int8), np.zeros(shape, np.int8),
             np.zeros(sshape, np.float32), np.zeros(sshape, np.float32)]
    k_new = (rng.standard_normal((2, 3, 2, 16)) * 2).astype(np.float32)
    v_new = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    # distinct slots (page 0 takes duplicate padding writes in any order)
    sp = np.asarray([3, 3, 5, 1, 7, 7], np.int64)
    so = np.asarray([0, 1, 3, 2, 0, 3], np.int64)
    want = jattn._paged_kv_update_quant_fwd(
        *(jnp.asarray(a) for a in (*pools, k_new, v_new, sp, so)))
    got = [torch.from_numpy(a.copy()) for a in pools]
    paged_kv_update_quant(*got, torch.from_numpy(k_new),
                          torch.from_numpy(v_new), torch.from_numpy(sp),
                          torch.from_numpy(so))
    for g, w in zip(got, want):
        assert same_bytes(g.numpy(), np.asarray(w))
    op = [np.asarray(t._array) for t in jax_apply(
        "paged_kv_update_quant", *pools, k_new, v_new, sp, so)]
    for g, w in zip(got[:2], op[:2]):
        assert np.abs(g.numpy().astype(int) - w.astype(int)).max() <= 1
    for g, w in zip(got[2:], op[2:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=2 ** -23, atol=0)


def quant_rpa_case(seed, heads, kv_heads, lens, d=32, page=4, max_pages=6,
                   num_pages=32):
    """int8 code pools from random rows; page 0 holds garbage codes and
    scales a correct kernel never reads."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    rows = rng.standard_normal((2, num_pages, page, kv_heads, d)) * 2
    (kq, ks), (vq, vs) = (jcore.np_quantize_kv_rows(r.astype(np.float32))
                          for r in rows)
    kq[0], vq[0], ks[0], vs[0] = 127, -127, 300.0, 300.0
    bt = np.zeros((b, max_pages), np.int32)
    for i, n in enumerate(lens):
        owned = math.ceil(n / page)
        bt[i, :owned] = rng.choice(np.arange(1, num_pages), owned,
                                   replace=False)
    return q, kq, vq, bt, np.asarray(lens, np.int32), ks, vs


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2)],
                         ids=["mha", "gqa4q2kv"])
def test_int8_decode_plain_matches_pallas_kernel(heads, kv_heads):
    q, kq, vq, bt, sl, ks, vs = quant_rpa_case(
        0, heads, kv_heads, [0, 1, 4, 5, 13, 24])
    want = np.asarray(jax_rpa(q, kq, vq, bt, sl, interpret=True,
                              k_scales=ks, v_scales=vs))
    t = [torch.from_numpy(a) for a in (q, kq, vq, bt, sl, ks, vs)]
    before = dict(LAUNCH_COUNTS)
    got = ragged_paged_attention_decode(*t[:5], k_scales=t[5],
                                        v_scales=t[6]).numpy()
    assert LAUNCH_COUNTS == before
    # f32 on both sides, summation order only
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.all(got[0] == 0.0)
    np.testing.assert_array_equal(
        got, ragged_paged_attention_decode_ref(*t[:5], None, t[5], t[6])
        .numpy())


def test_int8_decode_refusals():
    q, kq, vq, bt, sl, ks, vs = (torch.from_numpy(a) for a in
                                 quant_rpa_case(1, 4, 2, [3, 5]))
    with pytest.raises(ValueError, match="together"):
        ragged_paged_attention_decode(q, kq, vq, bt, sl, k_scales=ks)
    with pytest.raises(TypeError, match="int8 codes"):
        ragged_paged_attention_decode(q, kq.float(), vq.float(), bt, sl,
                                      k_scales=ks, v_scales=vs)
    with pytest.raises(ValueError, match="one scale"):
        ragged_paged_attention_decode(q, kq, vq, bt, sl, k_scales=ks[..., 0],
                                      v_scales=vs)
    with pytest.raises(ValueError, match="one scale"):
        ragged_paged_attention_decode(q, kq, vq, bt, sl, k_scales=ks,
                                      v_scales=vs.double())
    with pytest.raises(TypeError, match="one dtype"):
        ragged_paged_attention_decode(q, kq, vq, bt, sl)


def test_int8_prefill_gather_matches_reference():
    """The gather path dequantizes to q's dtype before the products."""
    q0, kq, vq, bt, sl, ks, vs = quant_rpa_case(2, 4, 2, [7, 13])
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    qp = np.stack([np.arange(4, 7), np.arange(10, 13)]).astype(np.int64)
    want = np.asarray(jattn.paged_attention_xla(
        q, kq, vq, bt, sl, qp, 0.25, k_scales=ks, v_scales=vs))
    t = [torch.from_numpy(a) for a in (q, kq, vq, bt, sl, qp)]
    got = paged_attention_torch(*t, 0.25, torch.from_numpy(ks),
                                torch.from_numpy(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# generate(): int8 weights + int8 KV, token for token
# ---------------------------------------------------------------------------

KW = dict(block_size=4, num_blocks=64, max_batch=2, prefill_chunk=8,
          max_seq_len=32)
# the third and fourth prompts arrive after the first prefilled: they hit
# its cached blocks, the fourth forking inside a block (copy-on-write)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [7, 8, 9],
           [1, 2, 3, 4, 5, 6, 7, 8, 30, 31],
           [1, 2, 3, 4, 5, 6, 40, 41, 42, 43, 44]]


def quantized_pair(bits=8):
    jmodel, port = model_pair()
    jax_quantize(jmodel, bits=bits, group=8)
    quantize_for_inference(port, bits=bits, group=8)
    return jmodel, port


@pytest.mark.parametrize("prefix", ["on", "off"])
def test_int8_generate_is_token_identical_to_reference(prefix):
    set_both({"serving_kv_quant": "int8", "serving_prefix_cache": prefix})
    jmodel, port = quantized_pair()
    want = JaxEngine(jmodel, **KW).generate(PROMPTS, max_new_tokens=6)
    eng = ServingEngine(port, use_kernel=True, device="cpu", **KW)
    assert eng.kv.quantized
    got = eng.generate(PROMPTS, max_new_tokens=6)
    assert got == want and all(len(o) == 6 for o in got)
    stats = eng.kv.prefix_stats()
    if prefix == "on":
        assert stats["hits"] >= 2 and stats["cow_copies_total"] >= 1
    else:
        assert stats["hits"] == 0


def test_int8_generate_matches_reference_rpa_kernel_in_interpret_mode():
    """The reference engine's decode through its quantized Pallas kernel
    (interpret mode), the port's through the wrapper, with int4 weights
    going through the port's kernel wrapper too."""
    set_both({"serving_kv_quant": "int8"})
    tflags.set_flags({"weight_quant_kernel": "on"})
    jmodel, port = quantized_pair(bits=4)
    assert port.lm_head.kernel is True
    jattn._PALLAS_INTERPRET = True
    paddle.set_flags({"serving_use_rpa_kernel": "on"})
    ref = JaxEngine(jmodel, **KW)
    assert ref._use_kernel
    want = ref.generate(PROMPTS[:2], max_new_tokens=5)
    got = ServingEngine(port, use_kernel=True, device="cpu", **KW).generate(
        PROMPTS[:2], max_new_tokens=5)
    assert got == want


def test_int8_generate_under_forced_preemption_is_token_identical():
    """8 usable pages of 4 tokens; three requests each peak at 3 pages, so
    decode must evict and recompute — with the same outputs."""
    set_both({"serving_kv_quant": "int8"})
    jmodel, port = quantized_pair()
    kw = dict(block_size=4, num_blocks=9, max_batch=3, prefill_chunk=8,
              max_seq_len=16)
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10], [11, 12, 13, 14, 15]]
    want = JaxEngine(jmodel, **kw).generate(prompts, max_new_tokens=8)
    eng = ServingEngine(port, use_kernel=True, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=8)
    assert got == want
    assert sum(r.preemptions for r in eng.last_requests) >= 1
    assert eng.kv.blocks_in_use == 0


def test_copy_on_write_moves_scales_with_codes():
    """A step's queued CoW copy lands in the scale pools as well: the
    destination page's codes AND scales equal the source's."""
    set_both({"serving_kv_quant": "int8"})
    _, port = quantized_pair()
    eng = ServingEngine(port, use_kernel=True, device="cpu", **KW)
    kv = eng.kv
    pools = kv.layer_pools()
    rng = np.random.default_rng(8)
    for layer in pools:
        for t in layer[:2]:
            t[5] = torch.from_numpy(rng.integers(-127, 128, t[5].shape)
                                    .astype(np.int8))
        for t in layer[2:]:
            t[5] = torch.from_numpy(rng.random(t[5].shape, np.float32))
    kv._pending_copies.append((5, 9))
    # an all-padding decode step (every write into page 0) that carries
    # the copy in its fixed-width copy list
    step = eng._decode
    eng._build(step)
    step.fill()
    eng._run(step)
    for layer in pools:
        for t in layer:
            assert torch.equal(t[9], t[5])
        assert bool((layer[2][9] != 0).all())
