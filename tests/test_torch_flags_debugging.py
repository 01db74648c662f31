"""The port's flag registry and amp.debugging against the JAX package's:
every reference flag is defined with its name, type and default;
``on_flag_set`` hooks; ``check_numerics``; operator stats collected over
the registry's ``apply`` (the same table, f32 within 1e-5); the tensor
checker naming the first op that turns finite inputs non-finite."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.telemetry import numerics as jnum
import paddle_tpu_torch as P
from paddle_tpu_torch.core import place
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.ops import op as top


@pytest.fixture(autouse=True)
def _restore():
    P.set_device("cpu")
    yield
    place._current = None
    for mod in (tflags, jflags):
        mod.set_flags({"check_numerics": "off", "check_nan_inf": False,
                       "low_precision_op_list": False})


def test_every_reference_flag_is_defined_with_its_default():
    names = jflags.all_flags()
    assert tflags.all_flags() == names and len(names) == 77
    for n in names:
        j, t = jflags.flag_info(n), tflags.flag_info(n)
        assert t["default"] == j.default and t["type"] is j.type, n
        assert tflags.get_flags(n) == jflags.get_flags(n) or \
            n in ("check_numerics", "fault_injection"), n
    assert tflags.get_flags(["FLAGS_pg_timeout", "jit_max_programs"]) == \
        {"pg_timeout": 1800.0, "jit_max_programs": 32}
    assert tflags.pg_timeout() == 1800.0


def test_set_flags_coerces_and_hooks_fire():
    seen = []
    tflags.define_flag("test_only_knob", 3, "a test flag")
    try:
        tflags.on_flag_set("test_only_knob", seen.append)
        tflags.set_flags({"FLAGS_test_only_knob": "5"})
        assert tflags.get_flags("test_only_knob") == 5 and seen == [5]
        assert tflags.non_default_flags()["test_only_knob"] == 5
        with pytest.raises(ValueError):
            tflags.define_flag("test_only_knob", 1)
    finally:
        tflags._REGISTRY._flags.pop("test_only_knob")
        tflags._REGISTRY._hooks.pop("test_only_knob", None)


def _non_default(info):
    return {bool: lambda d: not d, int: lambda d: d + 1,
            float: lambda d: d + 0.5,
            str: lambda d: d + "x"}[info["type"]](info["default"])


@pytest.mark.parametrize("name", sorted(tflags._NO_READER))
def test_flag_with_no_reader_refuses_a_non_default_value(name, monkeypatch):
    """A flag whose reader is not ported takes its default and refuses any
    other value, from set_flags or the environment, naming where its
    reader comes from; the reference's own reader exists."""
    info = tflags.flag_info(name)
    other = _non_default(info)
    tflags.set_flags({name: info["default"]})
    with pytest.raises(NotImplementedError, match=tflags._NO_READER[name]):
        tflags.set_flags({name: other})
    assert tflags.get_flags(name) == info["default"]
    monkeypatch.setenv(f"FLAGS_{name}", str(other))
    with pytest.raises(NotImplementedError, match=f"FLAGS_{name}"):
        tflags._FlagRegistry().define(name, info["default"])
    jflags.set_flags({name: other})
    try:
        assert jflags.get_flags(name) == other
    finally:
        jflags.set_flags({name: info["default"]})


def test_flags_the_port_reads_take_any_value():
    """Every flag outside _NO_READER is one the port reads or one the
    reference also leaves unread; check_shapes now reaches the op
    registry."""
    read = {"serving_block_size", "serving_num_blocks", "serving_max_batch",
            "serving_prefill_chunk", "serving_kv_quant",
            "serving_use_rpa_kernel", "serving_prefix_cache",
            "weight_quant_group", "weight_quant_kernel",
            "retrace_warn_threshold", "compile_cache_dir",
            "compile_cache_max_bytes", "check_shapes", "exact_dropout_mask",
            "fault_injection", "fault_injection_seed", "check_numerics",
            "check_nan_inf", "low_precision_op_list"}
    compat = {"check_nan_inf_level", "paddle_num_threads", "eager_op_jit",
              "use_stride_kernel", "allocator_strategy",
              "tracer_mkldnn_ops_on", "max_inplace_grad_add",
              "embedding_deterministic", "cudnn_deterministic", "benchmark"}
    assert set(tflags.all_flags()) == read | compat | set(tflags._NO_READER)
    assert not (read | compat) & set(tflags._NO_READER)
    assert top._check_shapes is True
    tflags.set_flags({"check_shapes": False})
    try:
        assert top._check_shapes is False
    finally:
        tflags.set_flags({"check_shapes": True})
    assert top._check_shapes is True


def test_check_numerics_matches_reference():
    v = np.array([1.0, np.nan, np.inf, -np.inf, 2.0], np.float32)
    with pytest.raises(FloatingPointError):
        tdbg.check_numerics(torch.from_numpy(v), op_type="my_op",
                            var_name="x")
    got = tdbg.check_numerics(torch.from_numpy(v),
                              debug_mode=tdbg.DebugMode.CHECK_NAN_INF)
    want = jdbg.check_numerics(paddle.to_tensor(v),
                               debug_mode=jdbg.DebugMode.CHECK_NAN_INF)
    assert [int(g) for g in got] == [int(w.numpy()) for w in want] == [1, 2]
    assert all(g.dtype == torch.int32 for g in got)
    ok = tdbg.check_numerics(torch.ones(3))
    assert [int(g) for g in ok] == [0, 0]


X = np.array([[0.5, -2.0], [3.0, 0.25]], np.float32)


def _ops(mod, tensor):
    a = tensor(X)
    b = mod.matmul(a, a)
    c = mod.exp(b)
    d = mod.log(mod.abs(a))
    return mod.add(mod.tanh(d), c)


def test_operator_stats_match_reference():
    """The same registry ops in both packages: the same op names, call
    order and stats."""
    with jdbg.collect_operator_stats() as jc:
        _ops(paddle, paddle.to_tensor)
    with tdbg.collect_operator_stats() as tc:
        _ops(P, torch.from_numpy)
        live = tc.stats()
    want, got = jc.stats(), tc.stats()
    assert got == live and list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g["first"] == w["first"] and g["first_bad"] == w["first_bad"]
        assert (g["nan"], g["inf"]) == (w["nan"], w["inf"])
        np.testing.assert_allclose([g["absmax"], g["rms"]],
                                   [w["absmax"], w["rms"]], rtol=1e-5)
    assert tdbg.ACTIVE is None and top.NUMERICS_HOOK is None
    assert P.get_flags("low_precision_op_list") is False


def test_operator_stats_count_non_finite_outputs():
    with tdbg.collect_operator_stats() as tc:
        P.log(torch.tensor([1.0, -1.0, 0.0]))
        P.log(torch.tensor([2.0]))
    st = tc.stats()["log"]
    assert (st["nan"], st["inf"], st["first_bad"]) == (1, 1, 0)
    assert st["absmax"] == pytest.approx(np.log(2.0))


def test_enable_disable_pair_disarms_only_what_it_armed():
    tdbg.enable_operator_stats_collection()
    assert tdbg.ACTIVE is not None
    tdbg.disable_operator_stats_collection()
    assert tdbg.ACTIVE is None
    P.set_flags({"check_numerics": "stats"})
    tdbg.enable_operator_stats_collection()
    tdbg.disable_operator_stats_collection()
    assert tdbg.ACTIVE is not None and tdbg.mode() == "stats"


def test_tensor_checker_names_the_first_offending_op():
    """Full mode: log of a negative input raises naming 'log', with the
    output's counts and finite inputs; an op fed that NaN does not.
    The reference's checker names the same op."""
    bad = np.array([1.0, -1.0], np.float32)
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig())
    assert tdbg.mode() == "full" and P.get_flags("check_nan_inf")
    with pytest.raises(tdbg.NonFiniteError) as ei:
        P.exp(P.log(torch.from_numpy(bad)))
    assert ei.value.op == "log" and ei.value.where == "forward"
    assert ei.value.stats["output"]["nan"] == 1
    assert all(i["nan"] == 0 for i in ei.value.stats["inputs"])
    tdbg.disable_tensor_checker()
    assert tdbg.mode() == "off" and not P.get_flags("check_nan_inf")
    jdbg.enable_tensor_checker(jdbg.TensorCheckerConfig())
    try:
        with pytest.raises(jnum.NonFiniteError) as je:
            paddle.exp(paddle.log(paddle.to_tensor(bad)))
    finally:
        jdbg.disable_tensor_checker()
    assert je.value.op == ei.value.op


def test_tensor_checker_restores_the_mode_it_found():
    P.set_flags({"check_numerics": "stats"})
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig())
    assert tdbg.mode() == "full"
    tdbg.disable_tensor_checker()
    assert tdbg.mode() == "stats"
    tdbg.disable_tensor_checker()
    assert tdbg.mode() == "stats"
    cfg = tdbg.TensorCheckerConfig(debug_mode=tdbg.DebugMode.CHECK_ALL)
    P.set_flags({"check_numerics": "off"})
    tdbg.enable_tensor_checker(cfg)
    assert tdbg.mode() == "stats"
    tdbg.disable_tensor_checker()
    assert tdbg.mode() == "off"
