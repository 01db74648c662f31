"""The port's op surface (``paddle_tpu_torch/ops/op.py`` and
``paddle_tpu_torch/tensor/*``) against the JAX package's registry.

The reference registers 278 ops.  The port registers every one that
``paddle_tpu/tensor/*`` and the nn functionals register, and the
registry entries of the functionals beside the model and the engine
(``flash_sdpa``, the paged-KV ops, ``quant_matmul``, ...), under the same
names; every other op is listed in ``NOT_PORTED`` with the ROADMAP item
that ports it, and an op in neither fails ``test_registry_is_tiled``.

Each ported op runs on the inputs of ``tests/test_check_grad_sweep.py``'s
``SPEC``/``_build`` (imported, not edited; ``EXTRA`` below for the ops that
sweep leaves out: boolean, integer and complex outputs) through both
packages: float32 forwards within 1e-5, integer and boolean outputs exact,
gradients within 1e-5 where ``SPEC`` has them.  Random ops are checked by
shape, dtype, determinism under ``seed`` and moments, never against JAX's
random numbers.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import random_state as jrandom
from paddle_tpu.ops import infermeta as jinfer
from paddle_tpu.ops.op import _REGISTRY as JREG
from paddle_tpu.ops.op import apply_op as japply

import paddle_tpu_torch as P
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import errors as terrors
from paddle_tpu_torch.core import grad_mode as tgrad
from paddle_tpu_torch.core import random_state as trandom
from paddle_tpu_torch.ops import infermeta as tinfer
from paddle_tpu_torch.ops import op as top

from test_check_grad_sweep import SPEC, _build, _call  # noqa: E402

# -- the registry, side by side -------------------------------------------------

NOT_PORTED = {
    **{n: "A7 (distributed: ring and Ulysses attention)"
       for n in ("ring_attention", "ulysses_attention")},
    **{n: "A8 (ResNet: conv and pooling)" for n in (
        "conv_nd", "conv_transpose_nd", "adaptive_avg_pool_nd",
        "adaptive_max_pool_nd", "avg_pool_nd", "max_pool_nd")},
    **{n: "A9 (fft)" for n in (
        "fft_c2c", "fftn_c2c", "fftshift", "hfft_c2r", "ifft_c2c",
        "ifftn_c2c", "ifftshift", "ihfft_r2c", "irfft_c2r", "irfftn_c2r",
        "rfft_r2c", "rfftn_r2c")},
    **{n: "A9 (signal)" for n in ("frame_op", "istft_op", "overlap_add_op",
                                  "stft_op")},
    **{n: "A9 (sparse)" for n in (
        "sparse_conv3d", "sparse_dense_matmul", "sparse_fused_attention",
        "sparse_gather_values", "sparse_maxpool3d", "sparse_sddmm",
        "sparse_segment_softmax", "sparse_to_dense", "sparse_unary")},
    **{n: "A9 (geometric)" for n in (
        "segment_max", "segment_mean", "segment_min", "segment_sum",
        "send_u_recv", "send_ue_recv", "send_uv")},
    **{n: "A9 (vision ops and nn/functional/vision.py)" for n in (
        "grid_sample_op", "psroi_pool_op", "roi_align_op", "roi_pool_op",
        "yolo_loss_op")},
    **{n: "A9 (nn/layer/rnn.py)" for n in ("gru_layer", "lstm_layer",
                                           "rnn_layer")},
    **{n: "A9 (text)" for n in ("viterbi_decode",)},
    **{n: "A9 (incubate nn)" for n in ("fused_rope",)},
}
# registered by the reference on first use
LAZY = {"rnnt_loss_op"}
RANDOM = {"uniform_op", "normal_op", "randint_op", "bernoulli_op",
          "poisson_op", "gamma_op"}


def test_registry_is_tiled():
    """Every reference op is ported under its name or listed with the
    ROADMAP item that ports it; nothing in both, nothing stale."""
    ported, listed, ref = set(top.all_ops()), set(NOT_PORTED), set(JREG)
    assert not ported & listed, sorted(ported & listed)
    missing = ref - ported - listed
    assert not missing, f"unclassified reference ops: {sorted(missing)}"
    stale = (ported | listed) - ref - LAZY
    assert not stale, f"names the reference does not register: {stale}"
    assert len(ported) == 229
    # the port's infermeta rule is the reference's, op by op (a lazily
    # registered reference op has no rule of its own: "opaque")
    for n in ported:
        want = JREG[n].infer_category if n in JREG else "opaque"
        assert n in JREG or n in LAZY, n
        assert top.get_op(n).infer_category == want, n


# -- inputs for the ops the check_grad sweep leaves out ----------------------------

def _r(name):
    import zlib
    return np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))


def _cmp_pair(rng):
    x = rng.randn(3, 4).astype(np.float32)
    y = np.where(rng.rand(3, 4) > 0.5, x, rng.randn(3, 4)).astype(np.float32)
    return [x, y], {}


def _bools(rng, n=2):
    return [rng.rand(3, 4) > 0.5 for _ in range(n)], {}


def _ints(rng, n=2, lo=1, hi=40):
    return [rng.randint(lo, hi, (3, 4)).astype(np.int32)
            for _ in range(n)], {}


EXTRA = {
    # a grid of 8-bit steps with values past the scale on both sides
    "fake_quant_dequant": lambda r: ([(2 * r.randn(3, 4)).astype(np.float32),
                                      np.float32(1.5)],
                                     dict(bit_length=8, channel_axis=None)),
    **{n: _cmp_pair for n in ("equal", "not_equal", "greater_equal",
                              "greater_than", "less_equal", "less_than")},
    **{n: _bools for n in ("logical_and", "logical_or", "logical_xor")},
    "logical_not": lambda r: _bools(r, 1),
    "isclose_op": lambda r: (_cmp_pair(r)[0], dict(rtol=1e-5, atol=1e-8,
                                                   equal_nan=False)),
    **{n: lambda r: ([np.array([[1.0, np.nan, np.inf], [-np.inf, 0.0, 2.0]],
                               np.float32)], {})
       for n in ("isfinite", "isinf", "isnan")},
    **{n: lambda r: (_bools(r, 1)[0], dict(axis=1, keepdim=False))
       for n in ("all_op", "any_op")},
    **{n: lambda r: ([r.permutation(12).reshape(3, 4).astype(np.float32)],
                     dict(axis=1, keepdim=False, dtype="int64"))
       for n in ("argmax_op", "argmin_op")},
    "argsort_op": lambda r: ([r.permutation(12).reshape(3, 4)
                              .astype(np.float32)],
                             dict(axis=-1, descending=True, stable=True)),
    "count_nonzero_op": lambda r: ([(r.rand(3, 4) > 0.5).astype(np.float32)],
                                   dict(axis=1, keepdim=False)),
    "searchsorted_op": lambda r: ([np.sort(r.randn(6)).astype(np.float32),
                                   r.randn(2, 3).astype(np.float32)],
                                  dict(right=False)),
    **{n: _ints for n in ("bitwise_and", "bitwise_or", "bitwise_xor",
                          "gcd", "lcm")},
    "bitwise_not": lambda r: _ints(r, 1),
    **{n: lambda r: ([r.randint(0, 100, (3, 4)).astype(np.int32),
                      r.randint(0, 4, (3, 4)).astype(np.int32)], {})
       for n in ("bitwise_left_shift", "bitwise_right_shift")},
    "floor_divide": lambda r: ([r.randn(3, 4).astype(np.float32) * 5,
                                r.rand(3, 4).astype(np.float32) + 0.5], {}),
    "complex_op": lambda r: ([r.randn(3, 4).astype(np.float32),
                              r.randn(3, 4).astype(np.float32)], {}),
    "batch_norm_train": lambda r: ([r.randn(4, 3, 2).astype(np.float32),
                                    r.rand(3).astype(np.float32) + 0.5,
                                    r.randn(3).astype(np.float32)],
                                   dict(axes_key=(0, 2), epsilon=1e-5)),
}


def _ported_forward_cases():
    names = []
    for n in top.all_ops():
        if n in RANDOM:
            continue
        if n in SPEC and SPEC[n] != "public":
            names.append(n)
        elif n in EXTRA:
            names.append(n)
    return sorted(names)


FORWARD = _ported_forward_cases()
GRAD = sorted(n for n in FORWARD if n in SPEC)


def _inputs(name):
    if name in SPEC:
        args, kwargs, diff = _build(name, "float32")
        return args, kwargs, diff
    args, kwargs = EXTRA[name](_r(name))
    return args, kwargs, set()


def _to_np(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    res = []
    for o in outs:
        if isinstance(o, torch.Tensor):
            res.append(o.detach().cpu().numpy())
        else:
            res.append(np.asarray(o.numpy()))
    return res


def _port_args(args, diff):
    out, leaves = [], {}
    for i, a in enumerate(args):
        if a is None:
            out.append(None)
            continue
        t = torch.from_numpy(np.ascontiguousarray(a))
        if i in diff:
            t = t.clone().requires_grad_(True)
            leaves[i] = t
        out.append(t)
    return out, leaves


def _same(got, want, name):
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        kinds = {g.dtype.kind, w.dtype.kind}
        if kinds <= {"b"} or kinds <= {"i", "u"}:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g.dtype.kind == w.dtype.kind or kinds <= {"f", "c"}, (
                name, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_reference(name):
    args, kwargs, _ = _inputs(name)
    want = _to_np(japply(JREG[name], *args, **kwargs))
    targs, _ = _port_args(args, set())
    got = _to_np(top.apply(name, *targs, **kwargs))
    _same(got, want, name)


@pytest.mark.parametrize("name", GRAD)
def test_grads_match_reference(name):
    """The check_grad sweep's loss (every floating output summed) through
    both packages: each SPEC-differentiated input's gradient within 1e-5
    (a port gradient torch does not form, e.g. imag of a real input, is
    zero)."""
    args, kwargs, diff = _build(name, "float32")
    loss, tensors = _call(name, args, kwargs, diff, "float32")
    loss.backward()
    targs, leaves = _port_args(args, diff)
    outs = top.apply(name, *targs, **kwargs)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    terms = [o.double().sum() for o in outs
             if o.is_floating_point() and o.requires_grad]
    if terms:
        sum(terms).backward()
    for i in sorted(diff):
        want = np.asarray(tensors[i].grad.numpy(), np.float64)
        g = leaves[i].grad
        got = np.zeros_like(want) if g is None else g.double().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} input {i}")


# -- random ops: shape, dtype, determinism under seed, moments --------------------

@pytest.fixture
def cpu_default():
    """The port's creation functions default to the card: the CPU here.
    The reference's global seed is restored too."""
    seed, key = jrandom.current_seed(), jrandom.get_rng_state()
    P.set_device("cpu")
    yield
    from paddle_tpu_torch.core import place
    place._current = None
    trandom.seed(0)
    jrandom.seed(seed)
    jrandom.set_rng_state(key)


RANDOM_CASES = {
    "uniform_op": (lambda g: top.apply("uniform_op", g, shape=(4000, 5),
                                       dtype="float32", lo=-1.0, hi=3.0),
                   (4000, 5), torch.float32, 1.0, 16.0 / 12),
    "normal_op": (lambda g: top.apply("normal_op", g, 2.0, 0.5,
                                      shape=(4000, 5), dtype="float32"),
                  (4000, 5), torch.float32, 2.0, 0.25),
    "randint_op": (lambda g: top.apply("randint_op", g, 0, 10,
                                       shape=(4000, 5), dtype="int64"),
                   (4000, 5), torch.int64, 4.5, 99.0 / 12),
    "bernoulli_op": (lambda g: top.apply("bernoulli_op", g,
                                         torch.full((4000, 5), 0.3)),
                     (4000, 5), torch.float32, 0.3, 0.21),
    "poisson_op": (lambda g: top.apply("poisson_op", g,
                                       torch.full((4000, 5), 3.0)),
                   (4000, 5), torch.float32, 3.0, 3.0),
    "gamma_op": (lambda g: top.apply("gamma_op", g, torch.tensor(2.0),
                                     shape=(4000, 5), dtype="float32"),
                 (4000, 5), torch.float32, 2.0, 2.0),
}


@pytest.mark.parametrize("name", sorted(RANDOM_CASES))
def test_random_op_shape_dtype_seed_and_moments(cpu_default, name):
    assert name in JREG and name in top.all_ops()
    draw, shape, dtype, mean, var = RANDOM_CASES[name]
    P.seed(123)
    a = draw(trandom.generator("cpu"))
    b = draw(trandom.generator("cpu"))
    P.seed(123)
    again = draw(trandom.generator("cpu"))
    assert tuple(a.shape) == shape and a.dtype == dtype
    assert torch.equal(a, again) and not torch.equal(a, b)
    af = a.double()
    n = af.numel()
    # 6 standard errors of the mean; the variance within 10 %
    assert abs(af.mean().item() - mean) <= 6 * (var / n) ** 0.5, name
    assert abs(af.var().item() - var) <= 0.1 * var, name


def test_public_random_functions(cpu_default):
    P.seed(7)
    draws = [P.rand([3, 4]), P.randn([3, 4]), P.randint(0, 5, [3, 4]),
             P.uniform([3, 4], min=-2.0, max=2.0), P.normal(1.0, 2.0, [3]),
             P.randperm(10), P.bernoulli(torch.full((3,), 0.5)),
             P.standard_gamma(torch.ones(3)), P.poisson(torch.ones(3))]
    assert [tuple(d.shape) for d in draws] == [
        (3, 4), (3, 4), (3, 4), (3, 4), (3,), (10,), (3,), (3,), (3,)]
    assert draws[0].dtype == torch.float32 and draws[2].dtype == torch.int64
    assert sorted(draws[5].tolist()) == list(range(10))
    P.seed(7)
    assert torch.equal(P.rand([3, 4]), draws[0])
    state = P.get_rng_state()
    x = P.randn([5])
    P.set_rng_state(state)
    assert torch.equal(P.randn([5]), x)


# -- infermeta: the reference's error class, naming the op ---------------------------

SHAPE_ERRORS = [
    ("matmul_op", [(2, 3), (4, 5)], dict(transpose_x=False,
                                          transpose_y=False)),
    ("concat_op", [(2, 3), (2, 4)], dict(axis=0)),
    ("reshape_op", [(2, 3)], dict(shape=(4, 2))),
    ("add", [(2, 3), (4, 3)], {}),
    ("squeeze_op", [(2, 3)], dict(axis=(5,))),
    ("transpose_op", [(2, 3)], dict(perm=(0, 0))),
    ("solve_op", [(2, 3), (3, 1)], {}),
    ("inv_op", [(2, 3)], {}),
    ("stack_op", [(2, 3), (3, 2)], dict(axis=0)),
    ("sum_op", [(2, 3)], dict(axis=(0, 0), keepdim=False, dtype=None)),
]


@pytest.mark.parametrize("name,shapes,kwargs", SHAPE_ERRORS,
                         ids=[c[0] for c in SHAPE_ERRORS])
def test_shape_errors_name_the_op(name, shapes, kwargs):
    arrays = [np.zeros(s, np.float32) for s in shapes]
    with pytest.raises(jinfer.ShapeError) as jerr:
        japply(JREG[name], *arrays, **kwargs)
    with pytest.raises(tinfer.ShapeError) as terr:
        top.apply(name, *[torch.from_numpy(a) for a in arrays], **kwargs)
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert isinstance(terr.value, terrors.InvalidArgumentError)
    assert isinstance(terr.value, ValueError)
    assert str(terr.value).startswith(f"{name}: ")
    assert str(terr.value) == str(jerr.value)


def test_check_shapes_can_be_turned_off():
    x, y = torch.zeros(2, 3), torch.zeros(4, 5)
    top.set_check_shapes(False)
    try:
        with pytest.raises(RuntimeError) as err:
            top.apply("matmul_op", x, y, transpose_x=False,
                      transpose_y=False)
        assert not isinstance(err.value, tinfer.ShapeError)
    finally:
        top.set_check_shapes(True)


# -- the public functions, Paddle's semantics --------------------------------------

def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


PUBLIC = [
    ("reshape", lambda: ([_f(2, 3, 4)], dict(shape=[0, -1]))),
    ("reshape", lambda: ([_f(2, 3, 4)], dict(shape=[4, 0, -1]))),
    ("concat", lambda: ([[_f(2, 3), _f(4, 3, seed=1)]], dict(axis=0))),
    ("concat", lambda: ([[_f(2, 3), _f(2, 1, seed=1)]], dict(axis=-1))),
    ("stack", lambda: ([[_f(2, 3), _f(2, 3, seed=1)]], dict(axis=1))),
    ("split", lambda: ([_f(6, 2)], dict(num_or_sections=3))),
    ("split", lambda: ([_f(7, 2)], dict(num_or_sections=[2, -1, 1]))),
    ("squeeze", lambda: ([_f(2, 1, 3, 1)], dict(axis=[1, 2]))),
    ("unsqueeze", lambda: ([_f(2, 3)], dict(axis=[0, 2]))),
    ("flatten", lambda: ([_f(2, 3, 4)], dict(start_axis=1))),
    ("transpose", lambda: ([_f(2, 3, 4)], dict(perm=[2, 0, 1]))),
    ("matmul", lambda: ([_f(2, 3), _f(4, 3, seed=1)],
                        dict(transpose_y=True))),
    ("matmul", lambda: ([_f(3, 2), _f(3, 4, seed=1)],
                        dict(transpose_x=True))),
    ("sum", lambda: ([_f(2, 3, 4)], dict(axis=[0, 2], keepdim=True))),
    ("mean", lambda: ([_f(2, 3)], dict(axis=None, keepdim=True))),
    ("max", lambda: ([_f(2, 3)], dict(axis=1))),
    ("prod", lambda: ([_f(2, 3)], dict(axis=[0, 1]))),
    ("logsumexp", lambda: ([_f(2, 3)], dict(axis=-1))),
    ("cumsum", lambda: ([_f(2, 3)], dict())),
    ("cummax", lambda: ([_f(2, 5)], dict(axis=1))),
    ("clip", lambda: ([_f(3, 4)], dict(min=-0.5, max=0.5))),
    ("scale", lambda: ([_f(3)], dict(scale=2.0, bias=1.0,
                                     bias_after_scale=False))),
    ("tile", lambda: ([_f(2, 3)], dict(repeat_times=[2, 1]))),
    ("expand", lambda: ([_f(1, 3)], dict(shape=[4, -1]))),
    ("flip", lambda: ([_f(2, 3)], dict(axis=[0, 1]))),
    ("roll", lambda: ([_f(2, 3)], dict(shifts=2))),
    ("gather", lambda: ([_f(4, 3), np.array([[3], [0]], np.int64)],
                        dict(axis=0))),
    ("pad", lambda: ([_f(1, 2, 3, 3)], dict(pad=[1, 2, 0, 1],
                                            mode="reflect"))),
    ("pad", lambda: ([_f(1, 2, 3, 3)], dict(pad=[1, 1, 2, 0],
                                            mode="replicate"))),
    ("pad", lambda: ([_f(1, 2, 3, 3)], dict(pad=[2, 1, 1, 1],
                                            mode="circular"))),
    ("pad", lambda: ([_f(2, 3)], dict(pad=[1, 0, 0, 2], value=3.0))),
    ("chunk", lambda: ([_f(5, 2)], dict(chunks=2))),
    ("unbind", lambda: ([_f(3, 2)], dict(axis=1))),
    ("topk", lambda: ([_f(3, 5)], dict(k=2, axis=1, largest=False))),
    ("argsort", lambda: ([_f(3, 5)], dict(axis=0, descending=True))),
    ("kthvalue", lambda: ([_f(3, 5)], dict(k=2, axis=1))),
    ("std", lambda: ([_f(3, 5)], dict(axis=1, unbiased=False))),
    ("median", lambda: ([_f(3, 4)], dict(axis=1))),
    ("quantile", lambda: ([_f(3, 4)], dict(q=0.25, axis=1))),
    ("norm", lambda: ([_f(3, 4)], dict(p="fro"))),
    ("norm", lambda: ([_f(3, 4)], dict(p=1.0, axis=1, keepdim=True))),
    ("dist", lambda: ([_f(3, 4), _f(3, 4, seed=1)], dict(p=3))),
    ("tril", lambda: ([_f(4, 4)], dict(diagonal=-1))),
    ("diag", lambda: ([_f(3)], dict(offset=1, padding_value=5.0))),
    ("where", lambda: ([_f(3, 4) > 0, _f(3, 4, seed=1),
                        _f(3, 4, seed=2)], {})),
    ("masked_fill", lambda: ([_f(3, 4), _f(3, 4, seed=1) > 0],
                             dict(value=7.0))),
    ("einsum", lambda: (["ij,kj->ik", _f(2, 3), _f(4, 3, seed=1)], {})),
    ("tensordot", lambda: ([_f(2, 3, 4), _f(3, 4, 5, seed=1)],
                           dict(axes=2))),
    ("kron", lambda: ([_f(2, 2), _f(2, 3, seed=1)], {})),
    ("lerp", lambda: ([_f(3), _f(3, seed=1)], dict(weight=0.3))),
    ("take_along_axis", lambda: ([_f(3, 4), np.array([[0], [3], [1]],
                                                     np.int64)],
                                 dict(axis=1))),
    ("put_along_axis", lambda: ([_f(3, 4), np.array([[0], [3], [1]],
                                                    np.int64), 2.0],
                                dict(axis=1, reduce="add"))),
    ("repeat_interleave", lambda: ([_f(2, 3)], dict(repeats=2, axis=1))),
    ("index_add", lambda: ([_f(4, 3), np.array([0, 2], np.int64)],
                           dict(axis=0, value=np.ones((2, 3), np.float32)))),
    ("strided_slice", lambda: ([_f(4, 6)], dict(axes=[0, 1], starts=[1, 0],
                                                ends=[4, 6],
                                                strides=[2, 3]))),
    ("cast", lambda: ([_f(3)], dict(dtype="float64"))),
    ("isclose", lambda: ([_f(3), _f(3)], {})),
    ("equal_all", lambda: ([_f(3), _f(3)], {})),
    ("numel", lambda: ([_f(3, 4)], {})),
    ("slogdet", lambda: ([np.eye(3, dtype=np.float32) * 2], {})),
    ("rot90", lambda: ([_f(2, 3)], dict(k=3))),
    ("atleast_3d", lambda: ([_f(3)], {})),
    ("logcumsumexp", lambda: ([_f(2, 3)], dict(axis=1))),
    ("diff", lambda: ([_f(2, 5)], dict(axis=1))),
    ("trace", lambda: ([_f(3, 3)], dict(offset=1))),
    ("frac", lambda: ([_f(3) * 4], {})),
    ("count_nonzero", lambda: ([(_f(3, 4) > 0).astype(np.float32)],
                               dict(axis=1, keepdim=True))),
    ("nonzero", lambda: ([(_f(3, 4) > 0)], {})),
    ("masked_select", lambda: ([_f(3, 4), _f(3, 4, seed=1) > 0], {})),
    ("zeros_like", lambda: ([_f(2, 3)], dict(dtype="int32"))),
    ("full_like", lambda: ([_f(2, 3)], dict(fill_value=2.5))),
    ("bucketize", lambda: ([_f(5), np.sort(_f(4, seed=1))], {})),
]


def _pub_args(args, to):
    out = []
    for a in args:
        if isinstance(a, list):
            out.append([to(x) for x in a])
        elif isinstance(a, np.ndarray):
            out.append(to(a))
        else:
            out.append(a)
    return out


@pytest.mark.parametrize("case", range(len(PUBLIC)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(PUBLIC)])
def test_public_function_matches_reference(cpu_default, case):
    name, make = PUBLIC[case]
    args, kwargs = make()
    jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    want = getattr(paddle, name)(*_pub_args(args, paddle.to_tensor), **jkw)
    got = getattr(P, name)(*_pub_args(args, torch.from_numpy), **tkw)
    _same(_to_np(got), _to_np(want), name)


# -- the core modules ---------------------------------------------------------------

def test_creation_defaults_and_devices(cpu_default):
    x = P.to_tensor([[1, 2], [3, 4]])
    assert x.dtype == torch.int64 and x.device.type == "cpu"
    assert P.to_tensor([1.5, 2.0]).dtype == torch.float32
    y = P.to_tensor(np.ones(3, np.float64), stop_gradient=False)
    assert y.requires_grad and y.dtype == torch.float64
    assert P.arange(5).dtype == torch.int64
    assert P.arange(0, 1, 0.25).tolist() == [0.0, 0.25, 0.5, 0.75]
    assert P.full([2], 3).dtype == torch.int64
    assert P.full([2], True).dtype == torch.bool
    assert P.zeros([2, 3]).dtype == P.float32 == P.get_default_dtype()
    np.testing.assert_allclose(P.linspace(0, 1, 5).numpy(),
                               paddle.linspace(0, 1, 5).numpy())
    np.testing.assert_array_equal(P.eye(3, 2).numpy(),
                                  paddle.eye(3, 2).numpy())
    np.testing.assert_array_equal(P.tril_indices(4, 3, -1).numpy(),
                                  paddle.tril_indices(4, 3, -1).numpy())
    a, b = P.meshgrid(P.arange(3), P.arange(2))
    assert a.shape == b.shape == (3, 2)


def test_creation_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default places there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.zeros([2])
    assert P.zeros([2], device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.to_tensor([1.0])


def test_grad_mode_switches_torch_grad():
    x = torch.ones(2, requires_grad=True)
    with P.no_grad():
        assert not P.is_grad_enabled()
        assert not (x * 2).requires_grad
        with P.enable_grad():
            assert (x * 2).requires_grad
    assert P.is_grad_enabled()

    @P.no_grad
    def f():
        return x * 2

    @tgrad.no_grad()
    def g():
        return x * 2

    assert not f().requires_grad and not g().requires_grad
    P.set_grad_enabled(False)
    try:
        assert not torch.is_grad_enabled()
    finally:
        P.set_grad_enabled(True)
    with P.set_grad_enabled(False):
        assert not (x * 2).requires_grad
    assert torch.is_grad_enabled()


def test_errors_and_enforce_match_the_reference():
    from paddle_tpu.core import errors as jerrors
    assert terrors.__all__ == jerrors.__all__
    for n in terrors.__all__[:-1]:
        t, j = getattr(terrors, n), getattr(jerrors, n)
        assert [b.__name__ for b in t.__mro__] == \
            [b.__name__ for b in j.__mro__], n
    terrors.enforce(True, "fine")
    with pytest.raises(terrors.InvalidArgumentError, match="bad"):
        terrors.enforce(False, "bad")
    with pytest.raises(terrors.NotFoundError):
        terrors.enforce(0, exc=terrors.NotFoundError)


def test_inplace_variants_and_aliases(cpu_default):
    x = P.to_tensor([-1.0, 4.0])
    assert P.abs_(x) is x and x.tolist() == [1.0, 4.0]
    P.sqrt_(x)
    assert x.tolist() == [1.0, 2.0]
    y = P.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    P.t_(y)
    assert y.tolist() == [[1.0, 3.0], [2.0, 4.0]]
    assert P.mod is P.remainder and P.reverse is P.flip
    assert P.shape(y).tolist() == [2, 2] and P.shape(y).dtype == torch.int64
    assert P.is_tensor(y) and not P.is_tensor(np.ones(2))


def test_quantile_of_several_q_matches_numpy(cpu_default):
    """Several q at once (the reference's quantile passes a tuple to
    jnp.quantile, which refuses it): numpy's linear quantiles, q first."""
    x = _f(3, 4, 5)
    got = P.quantile(torch.from_numpy(x), [0.25, 0.75], axis=[0, 2],
                     keepdim=True)
    want = np.quantile(x, [0.25, 0.75], axis=(0, 2), keepdims=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_chip_smoke_op_cases_cover_the_registry():
    """chip_smoke.py's ops phase (the registry on the card vs the CPU) has
    a case for every op but the random ones and the kernel entries (which
    it checks at phase 3's shapes on the card), and each runs here on the
    CPU, the nn ops' backward too."""
    import chip_smoke
    cases = chip_smoke.op_cases()
    assert set(cases) | set(chip_smoke.RANDOM_OPS) | \
        set(chip_smoke.KERNEL_OPS) == set(top.all_ops())
    nn_names = set(chip_smoke.nn_op_cases(False))
    for name, (args, kwargs) in sorted(cases.items()):
        assert chip_smoke.run_op_case(name, args, kwargs, "cpu",
                                      name in nn_names), name
    for name in chip_smoke.RANDOM_OPS:
        a = chip_smoke.random_op_draw(name, "cpu")
        assert torch.equal(a, chip_smoke.random_op_draw(name, "cpu"))


def test_top_level_framework_functions():
    """The framework helpers ``paddle_tpu/__init__.py`` exports beside the
    op surface."""
    assert P.in_dynamic_mode() is paddle.in_dynamic_mode() is True
    assert P.in_dygraph_mode() and P.version() == P.__version__
    assert P.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    for name in ("is_compiled_with_xpu", "is_compiled_with_cinn",
                 "is_compiled_with_tpu"):
        assert getattr(P, name)() is False
    assert P.is_compiled_with_custom_device("tpu") is False
    P.disable_static()
    P.enable_static()
    assert P.finfo(P.float32).eps == np.finfo(np.float32).eps
    assert P.iinfo(P.int8).max == 127 and P.dtype is torch.dtype
    assert P.check_shape([2, -1])
    with pytest.raises(tinfer.ShapeError, match="invalid dim -2"):
        P.check_shape([2, -2])
    with pytest.raises(jinfer.ShapeError, match="invalid dim -2"):
        paddle.check_shape([2, -2])
    assert P.get_flags("serving_kv_quant") == \
        paddle.get_flags("serving_kv_quant") == "off"
    if not torch.cuda.is_available():
        assert P.get_cuda_rng_state() == []


# -- the nn ops the check_grad sweep leaves out ----------------------------------------

def _grad_pair(name, args, kwargs, diff, jfn=None):
    """One registry op in both packages on the same arrays: every output
    within 1e-5, and the gradients of the float outputs' sum."""
    jt = [paddle.to_tensor(a, stop_gradient=i not in diff)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(args)]
    want = (jfn or (lambda *a, **k: japply(JREG[name], *a, **k)))(
        *jt, **kwargs)
    want = want if isinstance(want, (tuple, list)) else (want,)
    sum(w.astype("float64").sum() for w in want
        if not w.stop_gradient).backward()
    targs, leaves = _port_args(args, diff)
    got = top.apply(name, *targs, **kwargs)
    got = got if isinstance(got, (tuple, list)) else (got,)
    _same(_to_np(tuple(got)), _to_np(tuple(want)), name)
    sum(g.double().sum() for g in got if g.requires_grad).backward()
    for i in sorted(diff):
        np.testing.assert_allclose(
            leaves[i].grad.double().numpy(), np.asarray(
                jt[i].grad.numpy(), np.float64), rtol=1e-5, atol=1e-5,
            err_msg=f"{name} input {i}")


def test_batch_norm_train_op_grads():
    args, kwargs = EXTRA["batch_norm_train"](_r("batch_norm_train"))
    _grad_pair("batch_norm_train", args, kwargs, {0, 1, 2})


def test_rnnt_loss_op():
    """Registered lazily by the reference (on its first rnnt_loss call)."""
    r = _r("rnnt_loss_op")
    logits = r.randn(2, 3, 3, 4).astype(np.float32)
    args = [logits, np.array([[1, 2], [3, 0]], np.int32),
            np.array([3, 2], np.int32), np.array([2, 1], np.int32)]
    import paddle_tpu.nn.functional as JF
    JF.rnnt_loss(*[paddle.to_tensor(a) for a in args])
    _grad_pair("rnnt_loss_op", args, dict(blank=0, fastemit_lambda=0.001),
               {0})


@pytest.mark.parametrize("exact", [False, True])
def test_dropout_ops_draw_from_their_generator(exact):
    """``dropout_op`` and ``alpha_dropout_op`` take a torch.Generator where
    the reference's take a JAX key: the same seed gives the same mask; the
    realised keep rate and scale are the reference's (p quantised to
    1/256 unless exact)."""
    x = torch.ones(400, 300)
    g = torch.Generator().manual_seed(4)
    y = top.apply("dropout_op", x, g, p=0.3, upscale=True, exact=exact)
    g.manual_seed(4)
    assert torch.equal(top.apply("dropout_op", x, g, p=0.3, upscale=True,
                                 exact=exact), y)
    keep_p = 0.7 if exact else 1 - round(0.3 * 256) / 256
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / keep_p))
    n = x.numel()
    assert abs(kept.double().mean().item() - keep_p) < \
        6 * (keep_p * (1 - keep_p) / n) ** 0.5
    down = top.apply("dropout_op", x, g, p=0.3, upscale=False)
    assert set(torch.unique(down).tolist()) == {0.0, 1.0}
    a = top.apply("alpha_dropout_op", torch.randn(400, 300, generator=g), g,
                  p=0.2)
    assert abs(a.mean().item()) < 0.02 and abs(a.std().item() - 1) < 0.02


# -- the registry entries of the functionals beside the model and the engine -------
# Each runs the reference's op (its Pallas kernels in interpret mode where
# the op takes them) and the port's on the same arrays, and the port's op
# is also the functional it wraps.

@pytest.fixture
def pallas_interpret(monkeypatch):
    from paddle_tpu.nn.functional import attention as jfa
    from paddle_tpu.ops.pallas import quant_matmul as jqmm
    from paddle_tpu.serving import attention as jsa
    for mod in (jfa, jsa, jqmm):
        monkeypatch.setattr(mod, "_PALLAS_INTERPRET", True)


def _f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_sdpa_op(pallas_interpret, causal):
    q, k, v = (_f32(1, 128, 4, 16, seed=i) for i in range(3))
    k, v = k[:, :, :2], v[:, :, :2]                   # grouped-query heads
    kw = dict(scale=0.25, is_causal=causal)
    _grad_pair("flash_sdpa", [q, k, v], kw, {0, 1, 2})
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = top.apply("flash_sdpa", *t, **kw)
    ref_out, ref_lse = TF.flash_sdpa(*t, 0.25, causal)
    assert torch.equal(out, ref_out) and torch.equal(lse[..., 0], ref_lse)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_ops(pallas_interpret, causal):
    q, k, v = (_f32(256, 2, 16, seed=i) for i in range(3))
    cu = np.array([0, 100, 173, 256], np.int32)
    _grad_pair("varlen_flash", [q, k, v, cu], dict(scale=0.25,
                                                   causal=causal),
               {0, 1, 2})
    _grad_pair("varlen_sdpa", [q, k, v, cu, cu], dict(scale=0.25,
                                                      causal=causal),
               {0, 1, 2})
    t = [torch.from_numpy(a) for a in (q, k, v, cu)]
    out, _ = TF.flash_attn_unpadded(*t[:3], t[3], t[3], 0, 0, 0.25,
                                    causal=causal)
    torch.testing.assert_close(top.apply("varlen_flash", *t, scale=0.25,
                                         causal=causal)[0], out)


def test_rope_ops():
    from paddle_tpu_torch.models.llama import _rope_tables
    x = _f32(2, 5, 3, 8)
    cos, sin = (t.numpy() for t in _rope_tables(8, 16, 10000.0, "cpu"))
    _grad_pair("rope", [x, cos[:5], sin[:5]], {}, {0})
    pos = np.random.RandomState(1).randint(0, 16, (2, 5)).astype(np.int32)
    _grad_pair("rope_at", [x, cos, sin, pos], {}, {0})


def _pages(seed=0, quant=False):
    r = np.random.RandomState(seed)
    pages = r.randn(6, 4, 2, 8).astype(np.float32)
    if quant:
        return (r.randint(-127, 128, (6, 4, 2, 8)).astype(np.int8),
                (r.rand(6, 4, 2, 1) * 0.02).astype(np.float32))
    return pages


def test_paged_kv_ops():
    """The writes return the updated pools (the port's, in place); page 0,
    the padding sink, takes duplicate writes in another order and is not
    compared."""
    k_new, v_new = _f32(2, 2, 2, 8, seed=1), _f32(2, 2, 2, 8, seed=2)
    sp = np.array([3, 3, 5, 0], np.int32)
    so = np.array([0, 1, 2, 0], np.int32)
    cases = [
        ("paged_kv_update", [_pages(), _pages(1), k_new, v_new, sp, so]),
        ("paged_kv_copy", [_pages(), _pages(1), np.array([3, 5, 0], np.int32),
                           np.array([5, 1, 0], np.int32)]),
        ("paged_kv_update_quant", [_pages(2, True)[0], _pages(3, True)[0],
                                   _pages(2, True)[1], _pages(3, True)[1],
                                   k_new, v_new, sp, so]),
    ]
    for name, args in cases:
        want = _to_np(japply(JREG[name], *args))
        targs, _ = _port_args([a.copy() for a in args], set())
        got = _to_np(top.apply(name, *targs))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[1:], w[1:], rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def _decode_args(seed=0, quant=False):
    r = np.random.RandomState(seed)
    q = r.randn(3, 1, 4, 8).astype(np.float32)
    bt = np.array([[1, 2, 0], [3, 0, 0], [4, 5, 1]], np.int32)
    lens = np.array([6, 3, 9], np.int32)
    pos = (lens - 1).reshape(3, 1).astype(np.int32)
    if quant:
        (kq, ks), (vq, vs) = _pages(seed, True), _pages(seed + 1, True)
        return [q, kq, vq, ks, vs, bt, lens, pos]
    return [q, _pages(seed), _pages(seed + 1), bt, lens, pos]


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("name", ["paged_attention", "paged_attention_quant"])
def test_paged_attention_ops(pallas_interpret, name, kernel):
    """kernel=True with one query token takes the decode kernel (its
    plain version on CPU tensors; the reference's Pallas kernel in
    interpret mode); otherwise the gather path."""
    args = _decode_args(quant=name.endswith("quant"))
    kw = dict(scale=0.3, kernel=kernel)
    want = _to_np(japply(JREG[name], *args, **kw))
    targs, _ = _port_args(args, set())
    got = _to_np(top.apply(name, *targs, **kw))
    _same(got, want, name)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_ops(pallas_interpret, bits, kernel):
    from paddle_tpu.quantize import core as jcore
    r = np.random.RandomState(bits)
    x = r.randn(8, 256).astype(np.float32)
    q, s, g = jcore.quantize_weight(r.randn(256, 128).astype(np.float32),
                                    bits=bits, group=128)
    kw = dict(bits=bits, group=g, kernel=kernel)
    want = _to_np(japply(JREG["quant_matmul"], x, q, s, **kw))
    targs, _ = _port_args([x, q, s], set())
    got = _to_np(top.apply("quant_matmul", *targs, **kw))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
    ids = np.array([[0, 5], [7, 2]], np.int32)
    rows = r.randint(-127, 128, (8, 16)).astype(np.int8)
    scales = (r.rand(8, 1) * 0.01).astype(np.float32)
    want = _to_np(japply(JREG["quant_embedding_lookup"], ids, rows, scales))
    targs, _ = _port_args([ids, rows, scales], set())
    _same(_to_np(top.apply("quant_embedding_lookup", *targs)), want,
          "quant_embedding_lookup")


def test_attention_dropout_ops_draw_from_their_generator():
    """sdpa_dropout and varlen_sdpa_dropout take a torch.Generator where
    the reference's take a JAX key.  With q = 0 every probability is
    1 / Sk, so each output element is 0 or (1 / Sk) / keep: sdpa_dropout
    keeps at the reference's quantised rate (``fast_keep_mask``),
    varlen_sdpa_dropout at exactly 1 - p (its exact Bernoulli)."""
    sk = 16
    q = torch.zeros(1, 64, 8, sk)
    v = torch.eye(sk).reshape(1, sk, 1, sk).expand(1, sk, 8, sk).contiguous()
    g = torch.Generator().manual_seed(2)
    out = top.apply("sdpa_dropout", q, torch.zeros(1, sk, 8, sk), v, None,
                    g, p=0.3, scale=1.0, is_causal=False)
    keep = 1 - round(0.3 * 256) / 256
    vals = set(np.round(torch.unique(out).double().numpy(), 5).tolist())
    assert vals == {0.0, round(1 / sk / keep, 5)}
    g.manual_seed(2)
    assert torch.equal(out, top.apply(
        "sdpa_dropout", q, torch.zeros(1, sk, 8, sk), v, None, g, p=0.3,
        scale=1.0, is_causal=False))
    cu = torch.tensor([0, sk], dtype=torch.int32)
    vo = top.apply("varlen_sdpa_dropout", torch.zeros(sk, 8, sk),
                   torch.zeros(sk, 8, sk), v[0], cu, cu, g, scale=1.0,
                   causal=False, p=0.25)
    vals = set(np.round(torch.unique(vo).double().numpy(), 5).tolist())
    assert vals == {0.0, round(1 / sk / 0.75, 5)}
