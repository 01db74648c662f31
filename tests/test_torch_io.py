"""Checkpoints across the two packages: ``paddle_tpu_torch.save``/``load``
(``framework/io_utils.py``) read and write the reference's format (a
protocol-4 pickle with ``paddle_tpu.framework.io_utils._TensorPayload``
leaves, bf16 as ``(uint16 array, "bfloat16")``, ``_QuantPayload``
dequantized at load).  A file saved by either package loads in the other
with equal arrays and dtypes; a tiny Llama saved by one and loaded into
the other gives logits within 1e-5; the tiny Llama's ``state_dict()``
keys and their order are the reference's.  The only test file that
imports both packages' ``save``/``load``."""

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import random_state as jrandom
from paddle_tpu.framework import io_utils as jio
from paddle_tpu.models import llama as jllama

import paddle_tpu_torch as P
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config)


@pytest.fixture(autouse=True)
def _restore_reference_rng():
    seed, key = jrandom.current_seed(), jrandom.get_rng_state()
    yield
    jrandom.seed(seed)
    jrandom.set_rng_state(key)


def _arrays(seed=0):
    r = np.random.RandomState(seed)
    return {
        "f32": r.randn(3, 4).astype(np.float32),
        "bf16": r.randn(5, 2).astype(ml_dtypes.bfloat16),
        "i64": r.randint(0, 9, (4,)).astype(np.int64),
        "f64": r.randn(2).astype(np.float64),
    }


def _quant(seed=1):
    """An int8 weight with per-column absmax scales, as the reference's
    ``inference.convert_to_int8`` stores one."""
    w = np.random.RandomState(seed).randn(6, 4).astype(np.float32)
    scale = np.abs(w).max(axis=0).astype(np.float32)
    q = np.round(w / scale * 127).astype(np.int8)
    return jio._QuantPayload(q, scale, 1, "float32", True, "w_q")


def _np_of(x):
    """numpy of a reference tensor (bf16 as ml_dtypes) or a port tensor
    (bf16 as ml_dtypes too, for the comparison)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x.numpy())


def _same(a, b, where):
    a, b = _np_of(a), _np_of(b)
    assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                  err_msg=where)


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    arrs = _arrays()
    obj = {"model": {k: paddle.to_tensor(v) for k, v in arrs.items()},
           "list": [paddle.to_tensor(arrs["f32"]), 3, "tag"],
           "nested": {"deep": (paddle.to_tensor(arrs["i64"]),)},
           "step": 7, "quant": _quant()}
    path = str(tmp_path / "ref.pdparams")
    paddle.save(obj, path)
    want = paddle.load(path)
    got = P.load(path, device="cpu")
    for k in arrs:
        _same(got["model"][k], want["model"][k], k)
    _same(got["list"][0], want["list"][0], "list")
    assert got["list"][1:] == [3, "tag"] and got["step"] == 7
    assert isinstance(got["nested"]["deep"], tuple)
    _same(got["nested"]["deep"][0], want["nested"]["deep"][0], "nested")
    np.testing.assert_array_equal(got["quant"].detach().numpy(),
                                  np.asarray(want["quant"].numpy()))
    assert isinstance(got["quant"], torch.nn.Parameter)
    assert got["quant"].name == "w_q"
    # return_numpy: arrays; bf16 as the (uint16, "bfloat16") pair
    raw = P.load(path, return_numpy=True)
    bits, tag = raw["model"]["bf16"]
    assert tag == "bfloat16" and bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, arrs["bf16"].view(np.uint16))
    np.testing.assert_array_equal(raw["model"]["f32"], arrs["f32"])


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    arrs = _arrays(3)
    tens = {k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
            if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v)
            for k, v in arrs.items()}
    param = torch.nn.Parameter(torch.ones(2, 2))
    obj = {"model": tens, "list": [tens["f32"], 1.5],
           "nested": {"p": param}, "epoch": 2}
    path = str(tmp_path / "port.pdparams")
    P.save(obj, path)
    with open(path, "rb") as f:     # the reference's class names on disk
        blob = f.read()
    assert b"paddle_tpu.framework.io_utils" in blob
    assert b"paddle_tpu_torch" not in blob
    # the file's arrays and dtypes (the reference's tensor load would
    # cast float64 to its default float32)
    want = jio.load(path, return_numpy=True)
    for k in arrs:
        assert want["model"][k].dtype == arrs[k].dtype, k
        np.testing.assert_array_equal(want["model"][k], arrs[k], err_msg=k)
    np.testing.assert_array_equal(want["list"][0], arrs["f32"])
    assert want["list"][1] == 1.5 and want["epoch"] == 2
    tensors = jio.load(path)
    _same(tens["bf16"], tensors["model"]["bf16"], "bf16")
    from paddle_tpu.core.tensor import Parameter as JParameter
    assert isinstance(tensors["nested"]["p"], JParameter)
    back = P.load(path, device="cpu")
    for k in arrs:
        _same(back["model"][k], tens[k], k)


def _ids():
    return np.random.RandomState(5).randint(0, 256, (2, 9)).astype(np.int64)


def test_tiny_llama_state_dict_keys_are_the_references():
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny_config())
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    assert list(tm.state_dict()) == list(jm.state_dict())
    for k, v in jm.state_dict().items():
        assert tuple(tm.state_dict()[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_llama_round_trip_both_ways(tmp_path, dtype):
    """Reference → file → port, and port → file → reference: logits within
    1e-5 (f32) of the model that wrote the file; every tensor bitwise."""
    cfg = dict(dtype=dtype)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny_config(**cfg))
    jm.eval()
    path = str(tmp_path / "ref_llama.pdparams")
    paddle.save(jm.state_dict(), path)
    tm = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu", seed=9)
    tm.eval()
    missing, unexpected = tm.set_state_dict(P.load(path, device="cpu"))
    assert missing == [] and unexpected == []
    for k, v in jm.state_dict().items():
        _same(tm.state_dict()[k], v, k)
    ids = _ids()
    if dtype == "float32":
        np.testing.assert_allclose(
            tm(torch.from_numpy(ids)).detach().numpy(),
            np.asarray(jm(paddle.to_tensor(ids)).numpy()), rtol=1e-5,
            atol=1e-5)
    # and back: the port's file into a fresh reference model
    tm2 = LlamaForCausalLM(llama_tiny_config(**cfg), device="cpu", seed=4)
    tm2.eval()
    path2 = str(tmp_path / "port_llama.pdparams")
    P.save(tm2.state_dict(), path2)
    jm2 = jllama.LlamaForCausalLM(jllama.llama_tiny_config(**cfg))
    jm2.eval()
    missing, unexpected = jm2.set_state_dict(paddle.load(path2))
    assert missing == [] and unexpected == []
    for k, v in jm2.state_dict().items():
        _same(tm2.state_dict()[k], v, k)
    if dtype == "float32":
        np.testing.assert_allclose(
            np.asarray(jm2(paddle.to_tensor(ids)).numpy()),
            tm2(torch.from_numpy(ids)).detach().numpy(), rtol=1e-5,
            atol=1e-5)


def test_load_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "x.pdparams")
    P.save({"w": torch.ones(2)}, path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.load(path)
