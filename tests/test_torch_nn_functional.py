"""The port's nn functionals (``paddle_tpu_torch/nn/functional/``:
activation, common, norm, loss) against the JAX package's, on the same
seeded numpy inputs: float32 forwards within 1e-5, integer outputs
exact, gradients within 1e-5 wherever the reference differentiates
(a reference function that computes on raw arrays, off its tape, has its
forward compared only; ``cross_entropy(use_softmax=False)``'s gradient is
held to central differences of the reference's loss instead).  Random
functions (dropout, gumbel_softmax, rrelu) are checked by their realised
rates, scales and moments, and by determinism under ``seed``, never
against JAX's random numbers; BatchNorm's running statistics after three
training calls.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch as P
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import random_state as trandom

RTOL = ATOL = 1e-5


def _rng(seed):
    return np.random.RandomState(seed)


def f32(*shape, seed=0, scale=1.0):
    return (_rng(seed).randn(*shape) * scale).astype(np.float32)


def away(*shape, seed=0):
    """Values with |x| in [0.2, 1.4]: clear of the kinks at 0."""
    r = _rng(seed)
    sign = np.where(r.rand(*shape) > 0.5, 1.0, -1.0)
    return (sign * (0.2 + r.rand(*shape) * 1.2)).astype(np.float32)


def prob(*shape, seed=0):
    return (_rng(seed).rand(*shape) * 0.8 + 0.1).astype(np.float32)


def ints(*shape, hi=4, seed=0):
    return _rng(seed).randint(0, hi, shape).astype(np.int64)


def _to_ref(a, grad):
    return paddle.to_tensor(a, stop_gradient=not grad)


def _to_port(a, grad):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_(True) if grad else t


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def run_case(name, args, kwargs, grad=True, port_name=None, ref_fn=None,
             port_fn=None, rtol=RTOL, atol=ATOL):
    """``name(*args, **kwargs)`` through both packages (``name`` may carry
    a ":variant" case label); float arrays among ``args`` are
    differentiated where ``grad``."""
    name = name.split(":")[0]
    diff = [i for i, a in enumerate(args) if grad and isinstance(
        a, np.ndarray) and a.dtype.kind == "f"]
    rargs = [_to_ref(a, i in diff) if isinstance(a, np.ndarray) else a
             for i, a in enumerate(args)]
    targs = [_to_port(a, i in diff) if isinstance(a, np.ndarray) else a
             for i, a in enumerate(args)]
    # array keywords (class weights) are tensors, not differentiated
    rkw = {k: _to_ref(v, False) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    tkw = {k: _to_port(v, False) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    rout = _outs((ref_fn or getattr(JF, name))(*rargs, **rkw))
    tout = _outs((port_fn or getattr(TF, port_name or name))(*targs,
                                                             **tkw))
    assert len(rout) == len(tout), name
    for r, t in zip(rout, tout):
        rv, tv = _np(r), _np(t)
        assert tuple(tv.shape) == tuple(rv.shape), (name, tv.shape, rv.shape)
        if rv.dtype.kind in "iub":
            np.testing.assert_array_equal(tv, rv, err_msg=name)
        else:
            np.testing.assert_allclose(tv, rv, rtol=rtol, atol=atol,
                                       err_msg=name)
    if not diff:
        return
    rterms = [r.astype("float64").sum() for r in rout
              if not r.stop_gradient and np.asarray(_np(r)).dtype.kind == "f"]
    if not rterms:
        return   # the reference computes this one off its tape
    sum(rterms[1:], rterms[0]).backward()
    tterms = [t.double().sum() for t in tout
              if t.requires_grad and t.is_floating_point()]
    sum(tterms[1:], tterms[0]).backward()
    for i in diff:
        if rargs[i].grad is None:
            continue
        want = np.asarray(rargs[i].grad.numpy(), np.float64)
        got = targs[i].grad
        got = np.zeros_like(want) if got is None else got.double().numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"{name} grad of input {i}")


# -- activations ------------------------------------------------------------------

ACT = {
    "relu": ([away(3, 4)], {}), "relu6": ([away(3, 4) * 4], {}),
    "gelu": ([f32(3, 4)], {}), "gelu:tanh": ([f32(3, 4)],
                                             dict(approximate=True)),
    "silu": ([f32(3, 4)], {}), "swish": ([f32(3, 4)], {}),
    "sigmoid": ([f32(3, 4)], {}), "tanh": ([f32(3, 4)], {}),
    "softmax": ([f32(3, 4)], dict(axis=0)),
    "log_softmax": ([f32(3, 4)], dict(axis=-1)),
    "leaky_relu": ([away(3, 4)], dict(negative_slope=0.1)),
    "elu": ([away(3, 4)], dict(alpha=0.7)), "selu": ([away(3, 4)], {}),
    "celu": ([away(3, 4)], dict(alpha=1.3)),
    "hardswish": ([away(3, 4) * 2], {}),
    "hardsigmoid": ([away(3, 4) * 2], {}),
    "hardtanh": ([away(3, 4) * 0.6], dict(min=-0.5, max=0.5)),
    "prelu": ([away(2, 3, 4), prob(1)], {}),
    "prelu:channel": ([away(2, 3, 4), prob(3)], {}),
    "mish": ([f32(3, 4)], {}),
    "softplus": ([f32(3, 4) * 4], dict(beta=2, threshold=3)),
    "softshrink": ([away(3, 4)], dict(threshold=0.1)),
    "hardshrink": ([away(3, 4)], dict(threshold=0.1)),
    "tanhshrink": ([f32(3, 4)], {}), "softsign": ([f32(3, 4)], {}),
    "thresholded_relu": ([away(3, 4)], dict(threshold=0.1, value=0.3)),
    "log_sigmoid": ([f32(3, 4)], {}), "glu": ([f32(3, 4)], dict(axis=-1)),
    "maxout": ([f32(2, 4, 3)], dict(groups=2, axis=1)),
    "rrelu:eval": ([away(3, 4)], dict(training=False)),
}


@pytest.mark.parametrize("case", sorted(ACT))
def test_activation(case):
    run_case(case, *ACT[case])


INPLACE = {"elu_": dict(alpha=0.5), "hardtanh_": {}, "leaky_relu_": {},
           "relu_": {}, "softmax_": dict(axis=-1), "tanh_": {},
           "thresholded_relu_": dict(threshold=0.3)}


@pytest.mark.parametrize("name", sorted(INPLACE))
def test_inplace_activation(name):
    """The in-place form writes the out-of-place result into x and keeps
    the gradient path through it."""
    x = away(3, 4)
    want = getattr(JF, name.rstrip("_"))(paddle.to_tensor(x),
                                         **INPLACE[name]).numpy()
    leaf = torch.from_numpy(x.copy()).requires_grad_(True)
    t = leaf * 1.0
    got = getattr(TF, name)(t, **INPLACE[name])
    assert got is t
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    got.sum().backward()
    ref = torch.from_numpy(x.copy()).requires_grad_(True)
    getattr(TF, name.rstrip("_"))(ref * 1.0, **INPLACE[name]).sum() \
        .backward()
    torch.testing.assert_close(leaf.grad, ref.grad)


# -- common -------------------------------------------------------------------------

COMMON = {
    "linear": ([f32(2, 3), f32(3, 4, seed=1), f32(4, seed=2)], {}),
    "linear:nobias": ([f32(2, 5, 3), f32(3, 4, seed=1)], {}),
    "embedding": ([ints(2, 3, hi=5), f32(5, 3)], {}),
    "embedding:pad": ([np.array([[0, 2], [4, 2]]), f32(5, 3)],
                      dict(padding_idx=2)),
    "one_hot": ([np.array([0, 3, 1])], dict(num_classes=4)),
    "pad": ([f32(1, 2, 3, 4)], dict(pad=[1, 2, 0, 1], mode="reflect")),
    "pad:constant": ([f32(1, 2, 3)], dict(pad=[1, 2], value=0.5)),
    "zeropad2d": ([f32(1, 2, 3, 4)], dict(padding=[1, 0, 2, 1])),
    "cosine_similarity": ([f32(3, 4), f32(3, 4, seed=1)], dict(axis=1)),
    "normalize": ([f32(3, 4)], dict(p=2, axis=1)),
    "normalize:p1": ([f32(3, 4)], dict(p=1, axis=0)),
    "interpolate:nearest": ([f32(1, 2, 3, 4)], dict(scale_factor=2)),
    "interpolate:nearest_down": ([f32(1, 2, 6, 5)], dict(size=[4, 3])),
    "interpolate:bilinear": ([f32(1, 2, 3, 4)],
                             dict(size=[5, 7], mode="bilinear")),
    "interpolate:bilinear_down": ([f32(1, 2, 8, 6)],
                                  dict(size=[3, 4], mode="bilinear")),
    "interpolate:bicubic": ([f32(1, 1, 4, 4)],
                            dict(scale_factor=2, mode="bicubic")),
    "interpolate:nhwc": ([f32(1, 3, 4, 2)], dict(size=[6, 5], mode="bilinear",
                                                 data_format="NHWC")),
    "interpolate:linear": ([f32(2, 3, 5)], dict(size=[9], mode="linear",
                                                data_format="NCW")),
    "upsample": ([f32(1, 2, 3, 3)], dict(scale_factor=2, mode="bilinear")),
    "unfold": ([f32(2, 3, 5, 6)], dict(kernel_sizes=[2, 3], strides=1,
                                       paddings=1, dilations=1)),
    "unfold:pad4": ([f32(1, 2, 5, 5)], dict(kernel_sizes=2, strides=2,
                                            paddings=[1, 0, 0, 1])),
    "fold": ([f32(1, 12, 12)], dict(output_sizes=[4, 5], kernel_sizes=2,
                                    strides=1)),
    "fold:pad": ([f32(1, 8, 9)], dict(output_sizes=[4, 4], kernel_sizes=2,
                                      strides=2, paddings=1)),
    "bilinear": ([f32(2, 3), f32(2, 4, seed=1), f32(5, 3, 4, seed=2),
                  f32(1, 5, seed=3)], {}),
    "label_smooth": ([prob(2, 4)], dict(epsilon=0.2)),
    "sequence_mask": ([np.array([1, 3, 2])], dict(maxlen=4)),
    "pixel_shuffle": ([f32(1, 8, 2, 3)], dict(upscale_factor=2)),
    "pixel_shuffle:nhwc": ([f32(1, 2, 3, 8)], dict(upscale_factor=2,
                                                   data_format="NHWC")),
    "pixel_unshuffle": ([f32(1, 2, 4, 6)], dict(downscale_factor=2)),
    "channel_shuffle": ([f32(1, 6, 2, 2)], dict(groups=3)),
    "channel_shuffle:nhwc": ([f32(1, 2, 2, 6)], dict(groups=2,
                                                     data_format="NHWC")),
    "gather_tree": ([np.array([[[2, 1], [3, 4]], [[5, 6], [7, 8]],
                               [[9, 1], [2, 3]]]),
                     np.array([[[0, 0], [0, 0]], [[1, 0], [1, 1]],
                               [[0, 1], [1, 0]]])], {}),
}


@pytest.mark.parametrize("case", sorted(COMMON))
def test_common(case):
    run_case(case, *COMMON[case])


def test_class_center_sample():
    label = np.array([3, 7, 3, 1], np.int64)
    want = JF.class_center_sample(paddle.to_tensor(label), 10, 6)
    got = TF.class_center_sample(torch.from_numpy(label), 10, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w.numpy()))


# -- dropout: realised rates and scales -----------------------------------------------

@pytest.fixture
def cpu_seed():
    P.set_device("cpu")
    P.seed(11)
    yield
    from paddle_tpu_torch.core import place
    place._current = None
    trandom.seed(0)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("p", [0.1, 0.3])
def test_dropout_rate_and_scale(cpu_seed, p, exact):
    """Without the flag the drop rate is p quantised to 1/256 and kept
    values are scaled by 1 / (1 - thresh/256); with it, Bernoulli(1 - p)
    and 1 / (1 - p) (the reference's fast_keep_mask)."""
    P.set_flags({"exact_dropout_mask": exact})
    try:
        x = torch.ones(400, 500)
        y = TF.dropout(x, p)
        thresh = round(p * 256)
        keep_p = 1 - p if exact else 1 - thresh / 256
        kept = y != 0
        assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / keep_p))
        rate = 1 - kept.double().mean().item()
        n = x.numel()
        assert abs(rate - (1 - keep_p)) < 6 * (keep_p * (1 - keep_p) / n) ** .5
        P.seed(11)
        assert torch.equal(TF.dropout(x, p), y)
    finally:
        P.set_flags({"exact_dropout_mask": False})


def test_dropout_modes_and_axis(cpu_seed):
    x = torch.ones(300, 40)
    np.testing.assert_allclose(
        TF.dropout(x, 0.25, training=False, mode="downscale_in_infer"),
        0.75)
    assert torch.equal(TF.dropout(x, 0.25, training=False), x)
    y = TF.dropout(x, 0.25, mode="downscale_in_infer")
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0}
    shared = TF.dropout(x, 0.5, axis=0)
    assert torch.equal(shared, shared[:, :1].expand_as(shared))
    assert set(torch.unique(shared).tolist()) <= {0.0, 2.0}
    d2 = TF.dropout2d(torch.ones(8, 6, 3, 3), 0.5)
    assert torch.equal(d2, d2[:, :, :1, :1].expand_as(d2))


@pytest.mark.parametrize("fn", ["alpha_dropout", "feature_alpha_dropout"])
def test_alpha_dropout_keeps_moments(cpu_seed, fn):
    x = torch.randn(200, 50, 4, generator=torch.Generator().manual_seed(0))
    y = getattr(TF, fn)(x, 0.2)
    assert abs(y.mean().item()) < 0.05 and abs(y.std().item() - 1) < 0.05
    if fn == "feature_alpha_dropout":
        alpha_p = -1.6732632423543772 * 1.0507009873554805
        a = (0.8 * (1 + 0.2 * alpha_p ** 2)) ** -0.5
        dropped = (y == a * alpha_p + -a * alpha_p * 0.2)
        assert torch.equal(dropped.all(-1), dropped.any(-1))
    assert torch.equal(getattr(TF, fn)(x, 0.2, training=False), x)


def test_gumbel_softmax_and_rrelu(cpu_seed):
    x = torch.from_numpy(f32(4, 6))
    y = TF.gumbel_softmax(x, temperature=0.5)
    np.testing.assert_allclose(y.sum(-1).numpy(), 1.0, rtol=1e-6)
    hard = TF.gumbel_softmax(x, hard=True)
    assert torch.equal(hard.sum(-1), torch.ones(4))
    assert set(torch.unique(hard).tolist()) <= {0.0, 1.0}
    neg = -torch.ones(2000)
    slopes = -TF.rrelu(neg, 0.1, 0.3)
    assert 0.1 <= slopes.min() and slopes.max() <= 0.3
    assert abs(slopes.mean().item() - 0.2) < 0.005


# -- norms ----------------------------------------------------------------------------

NORM = {
    "layer_norm": ([f32(2, 3, 4), [3, 4], prob(3, 4), f32(3, 4, seed=1)],
                   {}),
    "rms_norm": ([f32(3, 8), prob(8)], dict(epsilon=1e-5)),
    "instance_norm": ([f32(2, 3, 4, 4)], dict(eps=1e-5)),
    "group_norm": ([f32(2, 4, 3, 3)], dict(num_groups=2)),
    "group_norm:nhwc": ([f32(2, 3, 3, 4)], dict(num_groups=2,
                                                data_format="NHWC")),
    "local_response_norm": ([prob(2, 5, 3, 3)], dict(size=3)),
}


@pytest.mark.parametrize("case", sorted(NORM))
def test_norm(case):
    run_case(case, *NORM[case])


def test_instance_and_group_norm_affine():
    x, w, b = f32(2, 4, 3, 3), prob(4), f32(4, seed=1)
    rw, rb = paddle.to_tensor(w), paddle.to_tensor(b)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    np.testing.assert_allclose(
        TF.instance_norm(torch.from_numpy(x), weight=tw, bias=tb).numpy(),
        JF.instance_norm(paddle.to_tensor(x), weight=rw, bias=rb).numpy(),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        TF.group_norm(torch.from_numpy(x), 2, weight=tw, bias=tb).numpy(),
        JF.group_norm(paddle.to_tensor(x), 2, weight=rw, bias=rb).numpy(),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_batch_norm_running_stats_after_three_calls(data_format):
    """Three training calls: outputs, gradients and the running statistics
    (momentum 0.9 on the running side, the batch's biased variance) equal
    the reference's; then an inference call on the running statistics."""
    shape = (4, 3, 2, 2) if data_format == "NCHW" else (4, 2, 2, 3)
    w, b = prob(3), f32(3, seed=1)
    rm, rv = [paddle.to_tensor(np.zeros(3, np.float32)),
              paddle.to_tensor(np.ones(3, np.float32))]
    tm, tv = torch.zeros(3), torch.ones(3)
    for step in range(3):
        x = f32(*shape, seed=10 + step) * (step + 1) + step
        rx = paddle.to_tensor(x, stop_gradient=False)
        rw = paddle.to_tensor(w, stop_gradient=False)
        ry = JF.batch_norm(rx, rm, rv, rw, paddle.to_tensor(b),
                           training=True, data_format=data_format)
        tx = torch.from_numpy(x).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        ty = TF.batch_norm(tx, tm, tv, tw, torch.from_numpy(b),
                           training=True, data_format=data_format)
        np.testing.assert_allclose(ty.detach().numpy(), ry.numpy(),
                                   rtol=RTOL, atol=ATOL)
        (ry * ry).sum().backward()
        (ty * ty).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), rx.grad.numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tw.grad.numpy(), rw.grad.numpy(),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm.numpy(), rm.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), rv.numpy(), rtol=RTOL, atol=ATOL)
    x = f32(*shape, seed=20)
    np.testing.assert_allclose(
        TF.batch_norm(torch.from_numpy(x), tm, tv, torch.from_numpy(w),
                      torch.from_numpy(b), data_format=data_format).numpy(),
        JF.batch_norm(paddle.to_tensor(x), rm, rv, paddle.to_tensor(w),
                      paddle.to_tensor(b), data_format=data_format).numpy(),
        rtol=RTOL, atol=ATOL)


# -- losses ---------------------------------------------------------------------------

def _ce_inputs(seed=0):
    return f32(6, 5, seed=seed), np.array([1, 4, -100, 0, 2, -100])


LOSS = {
    "cross_entropy": ([f32(6, 5), ints(6, hi=5)], {}),
    "cross_entropy:ignore": (list(_ce_inputs()), {}),
    "cross_entropy:sum": (list(_ce_inputs()), dict(reduction="sum")),
    "cross_entropy:none": (list(_ce_inputs()), dict(reduction="none")),
    "cross_entropy:smooth": (list(_ce_inputs()),
                             dict(label_smoothing=0.1)),
    "cross_entropy:soft": ([f32(4, 5), prob(4, 5)], dict(soft_label=True)),
    "cross_entropy:axis1": ([f32(2, 5, 3), np.array([[1, -100, 4],
                                                     [0, 2, 3]])],
                            dict(axis=1)),
    # R2: class weights (valid positions' weights in the mean) ...
    "cross_entropy:weight": (list(_ce_inputs()),
                             dict(weight=prob(5, seed=3))),
    "cross_entropy:weight_none": (list(_ce_inputs()),
                                  dict(weight=prob(5, seed=3),
                                       reduction="none")),
    "cross_entropy:weight_axis1": ([f32(2, 5, 3), np.array(
        [[1, -100, 4], [0, 2, 3]])], dict(weight=prob(5, seed=3), axis=1)),
    "softmax_with_cross_entropy": ([f32(4, 5), ints(4, 1, hi=5)], {}),
    "softmax_with_cross_entropy:soft": ([f32(4, 5), prob(4, 5)],
                                        dict(soft_label=True)),
    "nll_loss": ([f32(6, 5), np.array([1, 4, -100, 0, 2, 3])], {}),
    "nll_loss:weight": ([f32(6, 5), np.array([1, 4, -100, 0, 2, 3]),
                         prob(5)], {}),
    "nll_loss:4d": ([f32(2, 3, 2, 2), ints(2, 2, 2, hi=3)],
                    dict(reduction="none")),
    "binary_cross_entropy": ([prob(3, 4), prob(3, 4, seed=1)], {}),
    "binary_cross_entropy:weight": ([prob(3, 4), prob(3, 4, seed=1),
                                     prob(3, 4, seed=2)],
                                    dict(reduction="sum")),
    "binary_cross_entropy_with_logits": ([away(3, 4), prob(3, 4)], {}),
    "binary_cross_entropy_with_logits:pos_weight": (
        [away(3, 4), prob(3, 4)], dict(pos_weight=prob(4, seed=5),
                                       reduction="none")),
    "mse_loss": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "l1_loss": ([f32(3, 4), f32(3, 4, seed=1)], dict(reduction="sum")),
    "smooth_l1_loss": ([f32(3, 4), f32(3, 4, seed=1)], dict(delta=0.5)),
    "huber_loss": ([f32(3, 4), f32(3, 4, seed=1)], dict(delta=0.5)),
    "kl_div": ([f32(3, 4), prob(3, 4)], {}),
    "kl_div:log_target": ([f32(3, 4), f32(3, 4, seed=1)],
                          dict(log_target=True, reduction="batchmean")),
    "margin_ranking_loss": ([f32(5), f32(5, seed=1),
                             np.array([1., -1, 1, 1, -1], np.float32)],
                            dict(margin=0.1)),
    "square_error_cost": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "sigmoid_focal_loss": ([away(3, 4), (prob(3, 4) > 0.5).astype(
        np.float32)], {}),
    "log_loss": ([prob(3, 1), (prob(3, 1, seed=1) > 0.5).astype(
        np.float32)], {}),
    "hinge_embedding_loss": ([f32(3, 4), np.where(prob(3, 4) > 0.5, 1.0,
                                                  -1.0).astype(np.float32)],
                             {}),
    "cosine_embedding_loss": ([f32(3, 4), f32(3, 4, seed=1),
                               np.array([1, -1, 1])], dict(margin=0.1)),
    "triplet_margin_loss": ([f32(3, 4), f32(3, 4, seed=1),
                             f32(3, 4, seed=2)], {}),
    "triplet_margin_loss:swap": ([f32(3, 4), f32(3, 4, seed=1),
                                  f32(3, 4, seed=2)], dict(swap=True)),
    "triplet_margin_with_distance_loss": ([f32(3, 4), f32(3, 4, seed=1),
                                           f32(3, 4, seed=2)], {}),
    "triplet_margin_with_distance_loss:swap": ([f32(3, 4), f32(3, 4, seed=1),
                                                f32(3, 4, seed=2)],
                                               dict(swap=True)),
    "multi_label_soft_margin_loss": ([f32(3, 4), (prob(3, 4) > 0.5).astype(
        np.float32)], {}),
    "soft_margin_loss": ([f32(3, 4), np.where(prob(3, 4) > 0.5, 1.0,
                                              -1.0).astype(np.float32)], {}),
    "poisson_nll_loss": ([f32(3, 4) * 0.5, prob(3, 4) * 3], {}),
    "poisson_nll_loss:raw": ([prob(3, 4) + 0.5, prob(3, 4) * 3],
                             dict(log_input=False)),
    "gaussian_nll_loss": ([f32(3, 4), f32(3, 4, seed=1), prob(3, 4)],
                          dict(full=True)),
    "dice_loss": ([np.abs(prob(3, 4)), ints(3, 1, hi=4)], {}),
    "npair_loss": ([f32(4, 3), f32(4, 3, seed=1), np.array([0, 1, 0, 2])],
                   {}),
    "multi_margin_loss": ([f32(4, 5), ints(4, hi=5)], {}),
    "multi_margin_loss:p2": ([f32(4, 5), ints(4, hi=5)],
                             dict(p=2, margin=0.5)),
    "margin_cross_entropy": ([prob(4, 6) * 1.6 - 0.8, ints(4, hi=6)],
                             dict(scale=4.0)),
    "margin_cross_entropy:softmax": ([prob(4, 6) * 1.6 - 0.8, ints(4, hi=6)],
                                     dict(scale=4.0, return_softmax=True,
                                          reduction="none")),
}


@pytest.mark.parametrize("case", sorted(LOSS))
def test_loss(case):
    run_case(case, *LOSS[case])


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_use_softmax_false(weighted, reduction):
    """R2: probabilities in, nll_loss of log(clip(p, 1e-30)) over axis 1
    (here a (2, 5, 3) input, classes on axis 1, with ignore_index
    positions).  Values within 1e-5 of the reference; the reference
    takes the log off its tape, so the port's gradient is held to central
    differences of the reference's loss (float64)."""
    logits = f32(2, 5, 3, seed=4)
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    label = np.array([[1, -100, 4], [0, 2, -100]])
    w = prob(5, seed=6)
    kw = dict(use_softmax=False, axis=1, reduction=reduction)

    def ref(pv, dtype="float32"):
        extra = dict(weight=paddle.to_tensor(w, dtype=dtype)) \
            if weighted else {}
        return JF.cross_entropy(paddle.to_tensor(pv, dtype=dtype),
                                paddle.to_tensor(label), **extra, **kw)

    tp = torch.from_numpy(p.astype(np.float32)).requires_grad_(True)
    extra = dict(weight=torch.from_numpy(w)) if weighted else {}
    got = TF.cross_entropy(tp, torch.from_numpy(label), **extra, **kw)
    np.testing.assert_allclose(got.detach().numpy(), ref(p).numpy(),
                               rtol=RTOL, atol=ATOL)
    got.double().sum().backward()
    p64, eps = p.astype(np.float64), 1e-6
    num = np.zeros_like(p64)
    for idx in np.ndindex(p64.shape):
        hi, lo = p64.copy(), p64.copy()
        hi[idx] += eps
        lo[idx] -= eps
        num[idx] = (float(ref(hi, "float64").numpy().sum()) -
                    float(ref(lo, "float64").numpy().sum())) / (2 * eps)
    np.testing.assert_allclose(tp.grad.double().numpy(), num, rtol=1e-5,
                               atol=1e-5)


def test_ctc_loss():
    """(T, B, C) log-probabilities through both packages' lattices,
    per sequence and in the reductions; gradients within 1e-5."""
    lp = f32(6, 2, 4, seed=3)
    labels = np.array([[1, 2, 2], [3, 1, 0]], np.int32)
    in_l, lab_l = np.array([6, 5], np.int64), np.array([3, 2], np.int64)
    for red in ("none", "sum", "mean"):
        run_case("ctc_loss", [lp, labels, in_l, lab_l],
                 dict(blank=0, reduction=red))


def test_rnnt_loss():
    logits = f32(2, 4, 3, 5, seed=7)
    labels = np.array([[1, 3], [2, 0]], np.int32)
    in_l, lab_l = np.array([4, 3], np.int32), np.array([2, 1], np.int32)
    for red in ("none", "mean"):
        run_case("rnnt_loss", [logits, labels, in_l, lab_l],
                 dict(blank=0, reduction=red))


def test_hsigmoid_loss():
    x, label = f32(4, 3), np.array([0, 3, 4, 1])
    w, b = f32(4, 3, seed=1), f32(4, 1, seed=2)
    run_case("hsigmoid_loss", [x, label, 5, w, b], {})
    table = np.array([[0, 1, -1], [0, 2, 3], [1, 3, -1], [0, -1, -1]])
    code = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 0]])
    run_case("hsigmoid_loss", [x, label, 5, w, b, table, code], {})


def test_sparse_attention():
    q, k, v = f32(1, 2, 3, 4), f32(1, 2, 3, 4, seed=1), f32(1, 2, 3, 4,
                                                           seed=2)
    off = np.array([[[0, 1, 3, 5], [0, 2, 3, 5]]], np.int32)
    cols = np.array([[[0, 0, 1, 1, 2], [0, 1, 1, 0, 2]]], np.int32)
    run_case("sparse_attention", [q, k, v, off, cols], {})
