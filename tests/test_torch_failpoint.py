"""The port's failpoint registry and retry policy
(paddle_tpu_torch/utils) against the JAX package's stdlib modules: the
same spec grammar and modes, the same deterministic fire sequence for a
seed, byte-identical ``corrupt_bytes``, the same retry schedule; and the
``serving.step`` failpoint in the port's engine, reported by
``health_snapshot`` as the reference's engine reports it."""

import random
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.core import random_state
from paddle_tpu.models import llama as jllama
from paddle_tpu.utils import failpoint as jfp
from paddle_tpu.utils import retry as jretry
import paddle_tpu_torch as P
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           llama_tiny_config,
                                           load_reference_arrays)
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.utils import failpoint as tfp
from paddle_tpu_torch.utils import retry as tretry

MODULES = {"reference": jfp, "port": tfp}


@pytest.fixture(autouse=True)
def _disarm():
    """No spec, and no reference seed set below, leaks into later
    tests."""
    seed, key = random_state.current_seed(), random_state.get_rng_state()
    yield
    jfp.disable()
    tfp.disable()
    random_state.seed(seed)
    random_state.set_rng_state(key)


@pytest.mark.parametrize("which", list(MODULES))
def test_spec_parsing_and_modes(which):
    fp = MODULES[which]
    fp.configure("a.b=error,p=0.25;c.d=delay,arg=0.01;e.f=hang_once,"
                 "arg=0.001;g.h=corrupt,n=2")
    assert set(fp.ACTIVE) == {"a.b", "c.d", "e.f", "g.h"}
    assert fp.ACTIVE["a.b"].prob == 0.25
    assert fp.ACTIVE["e.f"].max_fires == 1
    assert fp.inject("g.h") == "corrupt"
    assert fp.inject("g.h") == "corrupt"
    assert fp.inject("g.h") is None
    assert fp.inject("e.f") == "hang_once" and fp.inject("e.f") is None
    t0 = time.monotonic()
    assert fp.inject("c.d") == "delay" and time.monotonic() - t0 >= 0.009
    assert fp.inject("unarmed.point") is None
    assert fp.stats()["g.h"] == {"evaluated": 3, "fired": 2}


@pytest.mark.parametrize("which", list(MODULES))
@pytest.mark.parametrize("spec", ["no_equals_sign", "a.b=unknown_mode",
                                  "a.b=error,bogus=1", "a.b=error,p"])
def test_bad_specs_rejected(which, spec):
    with pytest.raises(ValueError):
        MODULES[which].configure(spec)


def test_the_registered_names_are_the_references():
    assert tfp.REGISTERED == jfp.REGISTERED
    assert issubclass(tfp.FailpointError, ConnectionError)


def test_error_mode_fires_the_same_calls_as_the_reference(monkeypatch):
    """p=0.3 over 200 calls: the same call ordinals fire in both (each
    point's Random seeded from the seed XOR the name's CRC)."""
    monkeypatch.setenv("FLAGS_fault_injection_seed", "17")
    monkeypatch.setattr(jfp, "_base_seed", lambda: 17)
    monkeypatch.setattr(tfp, "_base_seed", lambda: 17)
    fired = {}
    for name, fp in MODULES.items():
        fp.configure("x.y=error,p=0.3")
        hits = []
        for i in range(200):
            try:
                fp.inject("x.y")
            except fp.FailpointError:
                hits.append(i)
        fired[name] = hits
    assert fired["port"] == fired["reference"] and 30 < len(fired["port"])


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_corrupt_bytes_is_byte_identical(seed):
    data = bytes(range(256)) * 3
    got = tfp.corrupt_bytes(data, random.Random(seed))
    want = jfp.corrupt_bytes(data, random.Random(seed))
    assert got == want and got != data
    assert sum(a != b for a, b in zip(got, data)) == 1
    assert tfp.corrupt_bytes(b"") == b""


def test_context_manager_and_flags_mirror_the_spec():
    with tfp.failpoints("a.b=error"):
        assert P.get_flags("fault_injection") == "a.b=error"
        with tfp.failpoints("c.d=corrupt"):
            assert set(tfp.ACTIVE) == {"c.d"}
        assert set(tfp.ACTIVE) == {"a.b"}
    assert tfp.ACTIVE is None and P.get_flags("fault_injection") == ""
    P.set_flags({"fault_injection": "q.r=corrupt,n=1"})
    assert tfp.inject("q.r") == "corrupt" and tfp.inject("q.r") is None
    P.set_flags({"fault_injection": ""})
    assert tfp.ACTIVE is None


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["reference", "port"])
def test_retry_recovers_then_reraises_last_error(which):
    mod = {"reference": jretry, "port": tretry}[which]
    calls, pauses = [], []
    pol = mod.RetryPolicy(max_attempts=4, initial_backoff=0.01, jitter=0.0,
                          sleep=pauses.append)

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("down")
        return "ok"

    assert mod.call_with_retry(flaky, policy=pol) == "ok"
    assert pauses == [0.01, 0.02]

    def dead():
        raise TimeoutError(len(calls))

    with pytest.raises(TimeoutError):
        mod.call_with_retry(dead, policy=pol)
    with pytest.raises(KeyError):
        mod.call_with_retry(lambda: {}["x"], policy=pol)
    with pytest.raises(ValueError):
        mod.RetryPolicy(max_attempts=None)


def test_retry_backoff_schedule_equals_reference():
    """Jitter from the same seeded stream: the same pauses."""
    jretry._jitter_rng.seed(0x5EED)
    tretry._jitter_rng.seed(0x5EED)
    kw = dict(initial_backoff=0.1, multiplier=2.0, max_backoff=1.0,
              jitter=0.1)
    jp, tp = jretry.RetryPolicy(**kw), tretry.RetryPolicy(**kw)
    assert [tp.backoff(a) for a in range(1, 8)] == \
        [jp.backoff(a) for a in range(1, 8)]


def test_retryable_decorator_retries_injected_faults():
    tfp.configure("svc.call=error,n=2")
    pauses = []

    @tretry.retryable(max_attempts=3, initial_backoff=0.0,
                      sleep=pauses.append)
    def call():
        if tfp.ACTIVE:
            tfp.inject("svc.call")
        return 7

    assert call() == 7 and call.retry_policy.max_attempts == 3
    assert tfp.stats()["svc.call"] == {"evaluated": 3, "fired": 2}


# ---------------------------------------------------------------------------
# serving.step in the engine
# ---------------------------------------------------------------------------

def test_serving_step_failpoint_reports_and_recovers():
    """Armed once (n=1) mid-traffic, the step raises FailpointError on the
    host; health_snapshot turns unhealthy naming it; disarmed, the engine
    serves the same tokens as an engine that never failed, and a later
    step clears the error."""
    paddle.seed(1234)
    jmodel = jllama.LlamaForCausalLM(jllama.llama_tiny_config(
        num_hidden_layers=2, max_position_embeddings=64))
    port = LlamaForCausalLM(llama_tiny_config(
        num_hidden_layers=2, max_position_embeddings=64), device="cpu")
    load_reference_arrays(port, {n: np.asarray(p.numpy())
                                 for n, p in jmodel.named_parameters()})
    kw = dict(block_size=4, num_blocks=64, max_batch=2, prefill_chunk=8,
              max_seq_len=32, device="cpu")
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    want = ServingEngine(port, **kw).generate(prompts, max_new_tokens=6)
    eng = ServingEngine(port, **kw)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    while not reqs[0].out_tokens:
        eng.step()
    assert eng.health_snapshot()["healthy"] is True
    with tfp.failpoints("serving.step=error,n=1"):
        with pytest.raises(tfp.FailpointError):
            eng.step()
        health = eng.health_snapshot()
        assert health["healthy"] is False
        assert "FailpointError" in health["last_error"]
        assert tfp.stats()["serving.step"]["fired"] == 1
    while any(not r.done for r in reqs):
        eng.step()
    assert [r.output_tokens for r in reqs] == want
    assert eng.health_snapshot()["healthy"] is True
    assert eng.generate(prompts, max_new_tokens=6) == want
