"""The port's sharded checkpoint (``paddle_tpu_torch/distributed/
checkpoint``) against the reference's (``paddle_tpu/distributed/
checkpoint``): port -> port bitwise for float32, bfloat16, int64, bool
and 0-dim tensors (and a tiny Llama with its AdamW moments); reference
float32 -> port and port float32 -> reference bitwise; the two packages'
shard files and manifests byte for byte equal on the same state dict;
reference bfloat16 shards -> port exact, while the reference's own load
of them fails (pinned here, not imitated); a corrupt shard (written by
the ``ckpt.shard.write`` failpoint's ``_flip_byte``, or read corrupt by
``ckpt.shard.read``) rejected by name, with fallback to an older valid
save; an async save's snapshot taken before ``save_state_dict``
returns, its writer's failure raised by ``wait_save``; a two-rank save
(two processes with ``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM``) merged
by the coordinator and read by both packages."""

import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jckpt

import paddle_tpu_torch as P
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed.checkpoint import (
    CheckpointCorruptionError, load_state_dict, save_state_dict, wait_save)
from paddle_tpu_torch.utils import failpoint as fp

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fp.disable()
    wait_save()


def arrays(seed=0):
    r = np.random.RandomState(seed)
    return {"f32": r.randn(3, 5).astype(np.float32),
            "bf16": r.randn(4, 6).astype(ml_dtypes.bfloat16),
            "i64": r.randint(-9, 9, (7,)).astype(np.int64),
            "flag": r.rand(2, 2) > 0.5,
            "scalar": np.float32(r.randn())}


def port_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def ref_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def zeros_like(state):
    return {k: torch.zeros_like(v) for k, v in state.items()}


@pytest.mark.parametrize("async_save", [False, True])
def test_port_round_trip_is_bitwise(tmp_path, async_save):
    state = {k: port_tensor(v) for k, v in arrays().items()}
    state["step"] = 3                   # a non-tensor value is skipped
    save_state_dict(state, str(tmp_path), async_save=async_save)
    target = zeros_like({k: v for k, v in state.items() if k != "step"})
    load_state_dict(target, str(tmp_path))
    for k, v in target.items():
        assert v.dtype == state[k].dtype and v.shape == state[k].shape
        np.testing.assert_array_equal(bits(v), bits(state[k]))


def test_reference_f32_loads_into_the_port_and_back(tmp_path):
    w = np.random.RandomState(1).randn(8, 16).astype(np.float32)
    i = np.arange(5, dtype=np.int64)
    jckpt.save_state_dict({"w": paddle.to_tensor(w),
                           "i": paddle.to_tensor(i)}, str(tmp_path / "ref"))
    target = {"w": torch.zeros(8, 16), "i": torch.zeros(5, dtype=torch.int64)}
    load_state_dict(target, str(tmp_path / "ref"))
    np.testing.assert_array_equal(target["w"].numpy(), w)
    np.testing.assert_array_equal(target["i"].numpy(), i)

    save_state_dict({"w": torch.from_numpy(w), "i": torch.from_numpy(i)},
                    str(tmp_path / "port"))
    jtarget = {"w": paddle.zeros([8, 16]),
               "i": paddle.zeros([5], dtype="int64")}
    jckpt.load_state_dict(jtarget, str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(jtarget["w"].numpy()), w)
    np.testing.assert_array_equal(np.asarray(jtarget["i"].numpy()), i)


def test_files_and_manifests_are_the_references_byte_for_byte(tmp_path):
    a = arrays(2)
    jckpt.save_state_dict({k: paddle.to_tensor(v) for k, v in a.items()},
                          str(tmp_path / "ref"))
    save_state_dict({k: port_tensor(v) for k, v in a.items()},
                    str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "metadata.pkl" in names and "meta_0_0.pkl" in names
    assert "world_0.txt" in names and "0_0_1.npy" in names
    for fn in names:
        assert (tmp_path / "ref" / fn).read_bytes() == \
            (tmp_path / "port" / fn).read_bytes(), fn
    with open(tmp_path / "port" / "metadata.pkl", "rb") as f:
        meta = tckpt.load_pickle_checked(f)
    bf = meta.state["bf16"][0]
    assert bf.dtype == "bfloat16" and bf.global_shape == (4, 6)
    assert bf.checksum == jckpt.array_checksum(a["bf16"])


def test_reference_bf16_shards_load_exactly_into_the_port(tmp_path):
    a = arrays(3)["bf16"]
    jckpt.save_state_dict({"w": paddle.to_tensor(a)}, str(tmp_path))
    target = {"w": torch.zeros(4, 6, dtype=torch.bfloat16),
              "w32": torch.zeros(4, 6)}
    load_state_dict({"w": target["w"]}, str(tmp_path))
    np.testing.assert_array_equal(bits(target["w"]), ref_bits(a))
    load_state_dict({"w": target["w32"]}, str(tmp_path))  # cast on load
    np.testing.assert_array_equal(target["w32"].numpy(),
                                  a.astype(np.float32))


def test_the_references_own_bf16_load_fails(tmp_path):
    """The reference cannot read its bf16 shards back: ``np.save`` wrote
    ``'<V2'`` and ``np.load`` returns void, which has no cast
    (``load_state_dict.py:417``).  The port reads the words by the
    manifest's dtype instead."""
    a = np.random.RandomState(4).randn(2, 3).astype(ml_dtypes.bfloat16)
    jckpt.save_state_dict({"w": paddle.to_tensor(a)}, str(tmp_path))
    target = {"w": paddle.zeros([2, 3], dtype="bfloat16")}
    with pytest.raises(ValueError, match="No cast function available"):
        jckpt.load_state_dict(target, str(tmp_path))


def test_tiny_llama_and_adamw_moments_round_trip(tmp_path):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = llama_tiny_config(dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    ids = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    model.compute_loss(model(ids), ids).backward()
    opt.step()
    state = {**model.state_dict(),
             **{f"opt.{k}": v for k, v in opt.state_dict().items()}}
    save_state_dict(state, str(tmp_path))
    other = LlamaForCausalLM(cfg, device="cpu", seed=1)
    opt2 = AdamW(learning_rate=1e-3, parameters=other.parameters())
    opt2._prepare_update(other.parameters())
    target = {**other.state_dict(),
              **{f"opt.{k}": v for k, v in opt2.state_dict().items()}}
    load_state_dict(target, str(tmp_path))
    tensors = [k for k, v in state.items() if isinstance(v, torch.Tensor)]
    assert len(tensors) > 2 * len(model.state_dict())
    for k in tensors:
        np.testing.assert_array_equal(bits(target[k].detach()),
                                      bits(state[k].detach()))


def test_corrupt_write_is_rejected_by_name_then_falls_back(tmp_path):
    good = {"w": torch.arange(12.0).reshape(3, 4)}
    save_state_dict(good, str(tmp_path))               # uid 0, intact
    fp.configure("ckpt.shard.write=corrupt")
    save_state_dict({"w": good["w"] + 1}, str(tmp_path))   # uid 1, damaged
    fp.disable()
    target = {"w": torch.zeros(3, 4)}
    load_state_dict(target, str(tmp_path))
    np.testing.assert_array_equal(target["w"].numpy(), good["w"].numpy())
    # alone in its directory, the damaged save raises, naming its file
    fp.configure("ckpt.shard.write=corrupt")
    save_state_dict(good, str(tmp_path / "alone"))
    fp.disable()
    with pytest.raises(CheckpointCorruptionError) as e:
        load_state_dict({"w": torch.zeros(3, 4)}, str(tmp_path / "alone"))
    assert e.value.files == ("0_0_0.npy",)


def test_corrupt_read_failpoint_names_the_shard(tmp_path):
    state = {k: port_tensor(v) for k, v in arrays(5).items()}
    save_state_dict(state, str(tmp_path))
    target = zeros_like(state)
    fp.configure("ckpt.shard.read=corrupt,n=1")
    with pytest.raises(CheckpointCorruptionError, match="0_0_0.npy") as e:
        load_state_dict(target, str(tmp_path))
    assert e.value.files == ("0_0_0.npy",)
    assert all(not v.any() for v in target.values()), \
        "a rejected load must change no target"
    fp.disable()
    load_state_dict(target, str(tmp_path))
    np.testing.assert_array_equal(bits(target["bf16"]), bits(state["bf16"]))


def test_async_snapshot_is_taken_before_return(tmp_path):
    w = torch.arange(4096.0).reshape(64, 64)
    want = w.clone()
    save_state_dict({"w": w}, str(tmp_path), async_save=True)
    w.add_(1.0)                  # the next update, in place, at once
    wait_save()
    target = {"w": torch.zeros(64, 64)}
    load_state_dict(target, str(tmp_path))
    assert torch.equal(target["w"], want)


def test_a_failed_async_write_raises_at_wait_save(tmp_path):
    fp.configure("ckpt.shard.write=error")
    save_state_dict({"w": torch.ones(3)}, str(tmp_path), async_save=True)
    with pytest.raises(fp.FailpointError):
        wait_save()
    wait_save()                  # raised once, then cleared


def test_shape_mismatch_and_missing_unique_id_raise(tmp_path, monkeypatch):
    save_state_dict({"w": torch.ones(3, 4)}, str(tmp_path))
    with pytest.raises(ValueError, match="saved global shape"):
        load_state_dict({"w": torch.zeros(4, 3)}, str(tmp_path))
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(ValueError, match="unique_id"):
        save_state_dict({"w": torch.ones(3)}, str(tmp_path / "x"))


def test_read_plan_and_overlap():
    meta = tckpt.Metadata({"a": [tckpt.LocalTensorMetadata(
        (4, 8), (2, 8), (2, 0), "float32", "0_1_0.npy", "")]})
    assert tckpt.get_rank_to_files(meta, {"a": torch.zeros(4, 8),
                                          "b": torch.zeros(1)}) == \
        {"0_1_0.npy"}
    for args in [((0, 0), (4, 8), (2, 0), (4, 8)),
                 ((0, 0), (2, 8), (4, 0), (2, 8))]:
        assert tckpt.compute_overlap(*args) == jckpt.compute_overlap(*args)


RANK_SCRIPT = """
import sys, torch
from paddle_tpu_torch.distributed.checkpoint import save_state_dict
rank = int(sys.argv[2])
w = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
save_state_dict({f"w{rank}": w, "shared": torch.full((2,), 7.0)},
                sys.argv[1], unique_id=5)
"""


def test_two_rank_save_is_merged_by_the_coordinator(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), PADDLE_TRAINERS_NUM="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(tmp_path), str(r)],
        env=dict(env, PADDLE_TRAINER_ID=str(r)), stderr=subprocess.PIPE,
        text=True) for r in (1, 0)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
    names = set(os.listdir(tmp_path))
    assert {"meta_5_0.pkl", "meta_5_1.pkl", "world_5.txt",
            "metadata.pkl", "5_0_0.npy", "5_1_0.npy"} <= names
    with open(tmp_path / "metadata.pkl", "rb") as f:
        meta = tckpt.load_pickle_checked(f)
    assert set(meta.state) == {"w0", "w1", "shared"}
    assert len(meta.state["shared"]) == 2
    want = {r: np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
            for r in (0, 1)}
    target = {"w0": torch.zeros(2, 3), "w1": torch.zeros(2, 3)}
    load_state_dict(target, str(tmp_path))
    jtarget = {"w0": paddle.zeros([2, 3]), "w1": paddle.zeros([2, 3])}
    jckpt.load_state_dict(jtarget, str(tmp_path))
    for r in (0, 1):
        np.testing.assert_array_equal(target[f"w{r}"].numpy(), want[r])
        np.testing.assert_array_equal(
            np.asarray(jtarget[f"w{r}"].numpy()), want[r])
