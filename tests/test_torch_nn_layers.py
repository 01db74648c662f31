"""The port's nn surface (``paddle_tpu_torch/nn``: ``Layer``, initializers,
containers, the activation, common, norm and loss layers, ``nn.utils``,
and the single-device ``mp_layers``) against the JAX package's.

Each layer built in both packages has the same parameter and state-dict
keys, shapes and buffers; loaded with the reference's numpy state
(``set_state_dict``) it gives the reference's outputs (float32 within
1e-5) in training and in eval mode.  Random initial values are compared
by their bound, mean and standard deviation (within 3 standard errors of
the difference), never against JAX's random numbers.
"""

import collections
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.utils as jutils

import paddle_tpu_torch as P
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.utils as tutils
from paddle_tpu_torch.core import random_state as trandom
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from paddle_tpu_torch.nn import initializer as tinit
from paddle_tpu.nn import initializer as jinit

RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def cpu():
    """Layers are built on the current device: the CPU here."""
    P.set_device("cpu")
    P.seed(5)
    yield
    from paddle_tpu_torch.core import place
    place._current = None
    trandom.seed(0)


def f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def ref_state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


# name: (reference constructor, port constructor, input arrays)
def _pair(cls, *a, **k):
    return (lambda: getattr(jnn, cls)(*a, **k),
            lambda: getattr(tnn, cls)(*a, **k))


LAYERS = {
    "Linear": (*_pair("Linear", 3, 4), [f32(2, 3)]),
    "Linear_nobias": (*_pair("Linear", 3, 4, bias_attr=False), [f32(2, 3)]),
    "Embedding": (*_pair("Embedding", 6, 3, padding_idx=1),
                  [np.array([[0, 1], [5, 2]])]),
    "Bilinear": (*_pair("Bilinear", 3, 2, 4), [f32(2, 3), f32(2, 2, seed=1)]),
    "PReLU": (*_pair("PReLU", 3), [f32(2, 3, 4)]),
    "BatchNorm1D": (*_pair("BatchNorm1D", 3), [f32(5, 3)]),
    "BatchNorm2D": (*_pair("BatchNorm2D", 3), [f32(4, 3, 2, 2)]),
    "BatchNorm3D": (*_pair("BatchNorm3D", 2), [f32(3, 2, 2, 2, 2)]),
    "BatchNorm": (*_pair("BatchNorm", 3, act="relu"), [f32(4, 3, 2, 2)]),
    "SyncBatchNorm": (*_pair("SyncBatchNorm", 3), [f32(4, 3, 2, 2)]),
    "LayerNorm": (*_pair("LayerNorm", [3, 4]), [f32(2, 3, 4)]),
    "GroupNorm": (*_pair("GroupNorm", 2, 4), [f32(2, 4, 3, 3)]),
    "InstanceNorm2D": (*_pair("InstanceNorm2D", 3), [f32(2, 3, 4, 4)]),
    "RMSNorm": (*_pair("RMSNorm", 8), [f32(3, 8)]),
    "LocalResponseNorm": (*_pair("LocalResponseNorm", 3),
                          [np.abs(f32(2, 5, 3, 3))]),
    "SpectralNorm": (*_pair("SpectralNorm", [3, 4], power_iters=2),
                     [f32(3, 4)]),
    "Dropout": (*_pair("Dropout", 0.3), [f32(4, 5)]),
    "Dropout_downscale": (*_pair("Dropout", 0.3, mode="downscale_in_infer"),
                          [f32(4, 5)]),
    "AlphaDropout": (*_pair("AlphaDropout", 0.3), [f32(4, 5)]),
    "Flatten": (*_pair("Flatten"), [f32(2, 3, 4)]),
    "Identity": (*_pair("Identity"), [f32(2, 3)]),
    "Upsample": (*_pair("Upsample", scale_factor=2, mode="bilinear"),
                 [f32(1, 2, 3, 3)]),
    "UpsamplingNearest2D": (*_pair("UpsamplingNearest2D", scale_factor=2),
                            [f32(1, 2, 3, 3)]),
    "Pad2D": (*_pair("Pad2D", [1, 0, 2, 1], mode="replicate"),
              [f32(1, 2, 3, 3)]),
    "ZeroPad2D": (*_pair("ZeroPad2D", [1, 1, 0, 2]), [f32(1, 2, 3, 3)]),
    "CosineSimilarity": (*_pair("CosineSimilarity", axis=1),
                         [f32(3, 4), f32(3, 4, seed=1)]),
    "PairwiseDistance": (*_pair("PairwiseDistance"),
                         [f32(3, 4), f32(3, 4, seed=1)]),
    "Unfold": (*_pair("Unfold", 2), [f32(1, 2, 4, 4)]),
    "Fold": (*_pair("Fold", [3, 3], 2), [f32(1, 8, 4)]),
    "PixelShuffle": (*_pair("PixelShuffle", 2), [f32(1, 8, 2, 2)]),
    "PixelUnshuffle": (*_pair("PixelUnshuffle", 2), [f32(1, 2, 4, 4)]),
    "ChannelShuffle": (*_pair("ChannelShuffle", 2), [f32(1, 4, 2, 2)]),
    "Softmax": (*_pair("Softmax", axis=0), [f32(3, 4)]),
    "GELU": (*_pair("GELU", approximate=True), [f32(3, 4)]),
    "LeakyReLU": (*_pair("LeakyReLU", 0.2), [f32(3, 4)]),
    "Hardtanh": (*_pair("Hardtanh", -0.5, 0.5), [f32(3, 4)]),
    "Softplus": (*_pair("Softplus", 2, 5), [f32(3, 4)]),
    "Maxout": (*_pair("Maxout", 2), [f32(2, 4, 3)]),
    "GLU": (*_pair("GLU"), [f32(3, 4)]),
    "RReLU": (*_pair("RReLU"), [f32(3, 4)]),
    "CrossEntropyLoss": (*_pair("CrossEntropyLoss", label_smoothing=0.1),
                         [f32(4, 5), np.array([1, 0, -100, 4])]),
    "NLLLoss": (*_pair("NLLLoss"), [f32(4, 5), np.array([1, 0, 3, 4])]),
    "BCEWithLogitsLoss": (*_pair("BCEWithLogitsLoss"),
                          [f32(3, 4), np.abs(f32(3, 4, seed=1)) % 1]),
    "SmoothL1Loss": (*_pair("SmoothL1Loss"), [f32(3, 4), f32(3, 4, seed=1)]),
    "KLDivLoss": (*_pair("KLDivLoss", "batchmean"),
                  [f32(3, 4), np.abs(f32(3, 4, seed=1))]),
    "HuberLoss": (*_pair("HuberLoss", delta=0.5),
                  [f32(3, 4), f32(3, 4, seed=1)]),
    "MarginRankingLoss": (*_pair("MarginRankingLoss", 0.1),
                          [f32(5), f32(5, seed=1),
                           np.array([1., -1, 1, 1, -1], np.float32)]),
    "TripletMarginLoss": (*_pair("TripletMarginLoss"),
                          [f32(3, 4), f32(3, 4, seed=1), f32(3, 4, seed=2)]),
    "MultiMarginLoss": (*_pair("MultiMarginLoss"),
                        [f32(4, 5), np.array([1, 0, 3, 4])]),
    "HSigmoidLoss": (*_pair("HSigmoidLoss", 3, 5),
                     [f32(4, 3), np.array([0, 3, 4, 1])]),
    "CTCLoss": (*_pair("CTCLoss"),
                [f32(6, 2, 4), np.array([[1, 2, 2], [3, 1, 0]], np.int32),
                 np.array([6, 5]), np.array([3, 2])]),
}
ACT_CLASSES = ("ReLU", "ReLU6", "SiLU", "Swish", "Sigmoid", "Tanh", "Mish",
               "Softsign", "Tanhshrink", "LogSigmoid", "Hardswish",
               "Hardsigmoid", "ELU", "SELU", "CELU", "Softshrink",
               "Hardshrink", "ThresholdedReLU", "LogSoftmax", "Softmax2D")
LAYERS.update({c: (*_pair(c), [f32(2, 3, 4)]) for c in ACT_CLASSES})
LOSS_CLASSES = ("MSELoss", "L1Loss", "SoftMarginLoss",
                "MultiLabelSoftMarginLoss", "HingeEmbeddingLoss")
LAYERS.update({c: (*_pair(c), [f32(3, 4), np.sign(f32(3, 4, seed=1))])
               for c in LOSS_CLASSES})
RANDOM_IN_TRAINING = {"Dropout", "Dropout_downscale", "AlphaDropout", "RReLU"}


def _call(layer, arrays, make):
    return layer(*[make(a) for a in arrays])


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_state_and_outputs_match_reference(name):
    """Same keys (in the same order), shapes and dtypes; after
    ``set_state_dict`` of the reference's numpy state, the same outputs,
    in training (where it draws no random numbers) and in eval mode."""
    make_ref, make_port, arrays = LAYERS[name]
    ref, port = make_ref(), make_port()
    rsd, tsd = ref.state_dict(), port.state_dict()
    assert list(tsd) == list(rsd)
    for k in rsd:
        assert tuple(tsd[k].shape) == tuple(rsd[k].shape), k
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    missing, unexpected = port.set_state_dict(ref_state(ref))
    assert missing == [] and unexpected == []
    for mode in ("train", "eval"):
        getattr(ref, mode)()
        getattr(port, mode)()
        if mode == "train" and name in RANDOM_IN_TRAINING:
            continue
        want = _call(ref, arrays, paddle.to_tensor)
        got = _call(port, arrays, lambda a: torch.from_numpy(
            np.ascontiguousarray(a)))
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} ({mode})")
    for k, v in ref.state_dict().items():     # buffers updated alike
        np.testing.assert_allclose(_np(port.state_dict()[k]), _np(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_train_and_eval_switch_dropout_and_batchnorm():
    """Dropout draws in training and is the identity in eval (downscale:
    x (1 - p)); BatchNorm uses batch statistics and moves its running ones
    in training, and reads them in eval."""
    x = torch.from_numpy(f32(64, 3))
    d = tnn.Dropout(0.5)
    assert d.training and (d(x) == 0).any()
    d.eval()
    assert torch.equal(d(x), x)
    down = tnn.Dropout(0.5, mode="downscale_in_infer").eval()
    torch.testing.assert_close(down(x), x * 0.5)
    net = tnn.Sequential(tnn.Linear(3, 3), tnn.BatchNorm1D(3))
    net(x)
    bn = net[1]
    assert not torch.equal(bn._mean, torch.zeros(3))
    mean = bn._mean.clone()
    net.eval()
    assert not bn.training and not net[0].training
    net(x)
    assert torch.equal(bn._mean, mean)
    net.train()
    assert bn.training


def test_state_dict_order_is_params_then_buffers():
    """The reference lists every parameter, then every persistable buffer
    (torch's own order interleaves them a module at a time)."""
    ref = jnn.Sequential(jnn.BatchNorm1D(3), jnn.Linear(3, 2))
    port = tnn.Sequential(tnn.BatchNorm1D(3), tnn.Linear(3, 2))
    assert list(port.state_dict()) == list(ref.state_dict()) == [
        "0.weight", "0.bias", "1.weight", "1.bias", "0._mean", "0._variance"]
    assert list(port.state_dict(structured_name_prefix="net")) == [
        "net." + k for k in ref.state_dict()]
    port.register_buffer("scratch", torch.zeros(2), persistable=False)
    assert "scratch" not in port.state_dict()
    assert any(n == "scratch" for n, _ in port.named_buffers())
    outer = torch.nn.ModuleDict({"inner": port})   # torch's own recursion
    assert list(outer.state_dict())[0] == "inner.0.weight"


def test_set_state_dict_reports_and_refuses():
    lin = tnn.Linear(3, 2)
    before = lin.weight.detach().clone()
    missing, unexpected = lin.set_state_dict(
        {"weight": np.ones((3, 2), np.float32), "extra": np.zeros(1)})
    assert missing == ["bias"] and unexpected == ["extra"]
    assert torch.equal(lin.weight, torch.ones(3, 2))
    with pytest.raises(ValueError, match="weight"):
        lin.set_state_dict({"weight": before.t(), "bias": np.zeros(2)})
    assert torch.equal(lin.weight, torch.ones(3, 2))   # nothing copied
    assert tnn.Layer.load_dict is tnn.Layer.set_state_dict
    assert tnn.Layer.set_dict is tnn.Layer.set_state_dict


def test_layer_surface():
    net = tnn.Sequential(("fc", tnn.Linear(3, 4)), ("act", tnn.ReLU()),
                         ("out", tnn.Linear(4, 2)))
    assert isinstance(net, torch.nn.Module)
    assert isinstance(net.parameters(), list) and len(net.parameters()) == 4
    assert net.parameters(include_sublayers=False) == []
    assert [type(m).__name__ for m in net.sublayers()] == [
        "Linear", "ReLU", "Linear"]
    assert len(net.sublayers(include_self=True)) == 4
    assert [n for n, _ in net.named_sublayers()] == ["fc", "act", "out"]
    seen = []
    net.apply(lambda m: seen.append(type(m).__name__))
    assert seen == ["Sequential", "Linear", "ReLU", "Linear"]   # parents first
    assert net.full_name() == "sequential"
    net.to(dtype="float64")
    assert net.fc.weight.dtype == torch.float64 and \
        net._dtype == torch.float64
    net.astype("float32")
    assert net.out.bias.dtype == torch.float32
    net.bfloat16()
    assert net.fc.weight.dtype == torch.bfloat16
    net.float()
    x = torch.randn(2, 3)
    net(x).sum().backward()
    assert net.fc.weight.grad is not None
    net.clear_gradients()
    assert net.fc.weight.grad is None
    sub = tnn.Layer()
    p = sub.create_parameter([2, 3])
    sub.add_parameter("w", p)
    sub.add_sublayer("child", tnn.Linear(2, 2))
    assert [n for n, _ in sub.named_parameters()] == [
        "w", "child.weight", "child.bias"]
    assert "in_features=2" in repr(sub)


def test_hooks():
    lin = tnn.Linear(3, 2)
    x = torch.randn(4, 3)
    calls = []
    pre = lin.register_forward_pre_hook(
        lambda layer, inputs: (inputs[0] * 2,))
    post = lin.register_forward_post_hook(
        lambda layer, inputs, out: calls.append(out.shape) or out + 1)
    y = lin(x)
    torch.testing.assert_close(y, tnn.functional.linear(
        x * 2, lin.weight, lin.bias) + 1)
    assert calls == [torch.Size([4, 2])]
    pre.remove()
    post.remove()
    torch.testing.assert_close(lin(x), tnn.functional.linear(
        x, lin.weight, lin.bias))


def test_containers():
    layers = [tnn.Linear(2, 2) for _ in range(3)]
    ll = tnn.LayerList(layers[:2])
    ll.append(layers[2])
    assert len(ll) == 3 and ll[-1] is layers[2]
    ll.insert(0, tnn.ReLU())
    assert [type(m).__name__ for m in ll] == ["ReLU", "Linear", "Linear",
                                             "Linear"]
    assert len(ll[1:]) == 3
    ll[0] = tnn.Tanh()
    assert isinstance(ll[0], tnn.Tanh)
    assert len(ll.parameters()) == 6
    seq = tnn.Sequential(collections.OrderedDict(
        [("a", tnn.Linear(2, 3)), ("b", tnn.Tanh())]))
    assert isinstance(seq[0], tnn.Linear) and len(seq[0:1]) == 1
    assert tuple(seq(torch.randn(5, 2)).shape) == (5, 3)
    pl = tnn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    pl.append(torch.nn.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and [n for n, _ in pl.named_parameters()] == [
        "0", "1"]
    d = tnn.LayerDict({"x": tnn.ReLU()})
    d["y"] = tnn.Linear(2, 2)
    assert list(d.keys()) == ["x", "y"] and "y" in d and len(d) == 2
    assert isinstance(d.pop("x"), tnn.ReLU) and list(d) == ["y"]
    ref = jnn.LayerDict({"x": jnn.ReLU()})
    ref["y"] = jnn.Linear(2, 2)
    assert list(ref.state_dict()) == ["y.weight", "y.bias"]
    assert list(tnn.LayerDict({"x": tnn.ReLU(), "y": tnn.Linear(2, 2)})
                .state_dict()) == ["y.weight", "y.bias"]


def test_param_attr_trainable_false_is_skipped_by_the_optimizer():
    """``ParamAttr(trainable=False)`` gives ``requires_grad=False``; AdamW
    leaves that weight alone and updates the bias, as the reference's
    optimizer skips it."""
    from paddle_tpu_torch.optimizer import AdamW
    attr = tnn.ParamAttr(name="frozen", trainable=False,
                         learning_rate=0.5, need_clip=False)
    lin = tnn.Linear(3, 2, weight_attr=attr)
    w = lin.weight
    assert not w.requires_grad and w.name == "frozen" and \
        w.trainable is False and w.need_clip is False and \
        w.optimize_attr == {"learning_rate": 0.5}
    before_w, before_b = w.detach().clone(), lin.bias.detach().clone()
    opt = AdamW(learning_rate=0.1, parameters=lin.parameters())
    lin(torch.randn(4, 3)).sum().backward()
    opt.step()
    assert torch.equal(lin.weight, before_w)
    assert not torch.equal(lin.bias, before_b)
    jlin = jnn.Linear(3, 2, weight_attr=jnn.ParamAttr(trainable=False))
    jw = np.asarray(jlin.weight.numpy()).copy()
    jopt = paddle.optimizer.AdamW(learning_rate=0.1,
                                  parameters=jlin.parameters())
    jlin(paddle.to_tensor(f32(4, 3))).sum().backward()
    jopt.step()
    np.testing.assert_array_equal(np.asarray(jlin.weight.numpy()), jw)


# -- initializers -----------------------------------------------------------------

def _moments(a):
    a = np.asarray(a, np.float64).ravel()
    mean, std = a.mean(), a.std()
    se_mean = std / math.sqrt(a.size)
    se_std = math.sqrt(max(np.mean((a - mean) ** 4) - std ** 4, 0.0)) / (
        2 * std * math.sqrt(a.size))
    return mean, std, se_mean, se_std


def _same_distribution(port, ref, bound=None):
    pm, ps, pse, psse = _moments(port)
    rm, rs, rse, rsse = _moments(ref)
    assert abs(pm - rm) <= 3 * math.hypot(pse, rse), (pm, rm)
    assert abs(ps - rs) <= 3 * math.hypot(psse, rsse), (ps, rs)
    if bound is not None:
        assert np.abs(port).max() <= bound * (1 + 1e-6)
        assert np.abs(ref).max() <= bound * (1 + 1e-6)


INITS = {
    "Normal": (dict(mean=0.5, std=2.0), None),
    "TruncatedNormal": (dict(mean=0.1, std=0.5), 0.1 + 2 * 0.5),
    "Uniform": (dict(low=-0.3, high=0.7), 0.7),
    "XavierNormal": ({}, None),
    "XavierUniform": ({}, math.sqrt(6 / (300 + 200))),
    "KaimingNormal": ({}, None),
    "KaimingUniform": (dict(negative_slope=0.1, nonlinearity="leaky_relu"),
                       math.sqrt(2 / 1.01) * math.sqrt(3 / 300)),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_random_initializer_bound_and_moments(name):
    kw, bound = INITS[name]
    shape = (300, 200)
    port = getattr(tinit, name)(**kw).make(shape, torch.float32, "cpu")
    ref = getattr(jinit, name)(**kw).init_array(shape, np.float32)
    assert tuple(port.shape) == shape and port.dtype == torch.float32
    _same_distribution(port.numpy(), np.asarray(ref), bound)
    gen = torch.Generator().manual_seed(3)
    a = getattr(tinit, name)(**kw).make(shape, torch.bfloat16, "cpu", gen)
    gen.manual_seed(3)
    b = getattr(tinit, name)(**kw).make(shape, torch.bfloat16, "cpu", gen)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_conv_fans_and_deterministic_initializers():
    shape = (8, 4, 3, 3)
    port = tinit.XavierUniform().make(shape, torch.float32, "cpu")
    assert port.abs().max() <= math.sqrt(6 / (4 * 9 + 8 * 9))
    for gain in ("sigmoid", "tanh", "relu", "selu", "conv2d"):
        assert tinit.calculate_gain(gain) == jinit.calculate_gain(gain)
    assert tinit.calculate_gain("leaky_relu", 0.2) == \
        jinit.calculate_gain("leaky_relu", 0.2)
    with pytest.raises(ValueError):
        tinit.calculate_gain("nope")
    for port_init, ref_init, shp in (
            (tinit.Constant(0.25), jinit.Constant(0.25), (3, 4)),
            (tinit.Assign(np.arange(12.0)), jinit.Assign(np.arange(12.0)),
             (3, 4)),
            (tinit.Dirac(), jinit.Dirac(), (4, 3, 3, 3)),
            (tinit.Dirac(groups=2), jinit.Dirac(groups=2), (4, 2, 3))):
        np.testing.assert_array_equal(
            port_init.make(shp, torch.float32, "cpu").numpy(),
            np.asarray(ref_init.init_array(shp, np.float32)))
    bil = tinit.Bilinear().make((2, 2, 4, 4), torch.float32, "cpu")
    jparam = jnn.Layer().create_parameter([2, 2, 4, 4])
    jinit.Bilinear()(jparam)
    np.testing.assert_allclose(bil.numpy(), np.asarray(jparam.numpy()),
                               rtol=1e-6)
    for shp in ((6, 4), (4, 6), (3, 2, 2)):
        q = tinit.Orthogonal(gain=1.0).make(shp, torch.float32, "cpu")
        m = q.reshape(shp[0], -1)
        eye = m @ m.t() if m.shape[0] <= m.shape[1] else m.t() @ m
        torch.testing.assert_close(eye, torch.eye(eye.shape[0]), rtol=1e-5,
                                   atol=1e-5)
    lin = tnn.Linear(3, 2)
    tinit.Constant(0.5)(lin.weight)
    assert torch.equal(lin.weight, torch.full((3, 2), 0.5))


def test_create_parameter_rules():
    layer = tnn.Layer(dtype="float64")
    assert layer.create_parameter([2], attr=False) is None
    b = layer.create_parameter([3], is_bias=True)
    assert b.dtype == torch.float64 and torch.equal(b, torch.zeros(
        3, dtype=torch.float64))
    c = layer.create_parameter([3], default_initializer=tinit.Constant(2.0))
    assert torch.equal(c, torch.full((3,), 2.0, dtype=torch.float64))
    d = layer.create_parameter([3], attr=tinit.Constant(3.0),
                               default_initializer=tinit.Constant(2.0))
    assert torch.equal(d, torch.full((3,), 3.0, dtype=torch.float64))
    named = layer.create_parameter([3], attr="w0", dtype="float32")
    assert named.name == "w0" and named.dtype == torch.float32
    tinit.set_global_initializer(tinit.Constant(9.0))
    try:
        # stored, not read by create_parameter, as in the reference
        w = layer.create_parameter([2, 2], dtype="float32")
        assert not torch.equal(w, torch.full((2, 2), 9.0))
    finally:
        tinit.set_global_initializer(None)


# -- R1: nn.Linear / nn.Embedding are the reference's, the Llama's layers
# the parallel ones ----------------------------------------------------------

def test_linear_and_embedding_start_xavier_uniform_like_the_reference():
    """The reference's ``nn.Linear(4096, 4096)`` draws XavierUniform: every
    element within sqrt(6 / (fan_in + fan_out)); so must the port's, with
    the same mean and standard deviation (3 standard errors)."""
    bound = math.sqrt(6 / (4096 + 4096))
    port = tnn.Linear(4096, 4096).weight.detach().numpy()
    ref = np.asarray(jnn.Linear(4096, 4096).weight.numpy())
    _same_distribution(port, ref, bound)
    np.testing.assert_array_equal(tnn.Linear(8, 4).bias.detach().numpy(),
                                  np.zeros(4, np.float32))
    ebound = math.sqrt(6 / (1000 + 64))
    emb = tnn.Embedding(1000, 64, padding_idx=-1)
    _same_distribution(emb.weight.detach().numpy()[:-1],
                       np.asarray(jnn.Embedding(1000, 64).weight.numpy()),
                       ebound)
    assert torch.equal(emb.weight[999], torch.zeros(64))


def test_embedding_padding_row_gets_no_gradient():
    emb = tnn.Embedding(5, 3, padding_idx=2)
    assert torch.equal(emb.weight[2], torch.zeros(3))
    emb(torch.tensor([[2, 0], [2, 4]])).sum().backward()
    assert torch.equal(emb.weight.grad[2], torch.zeros(3))
    assert torch.equal(emb.weight.grad[0], torch.ones(3))


@pytest.mark.parametrize("kind", ["column", "row", "vocab"])
def test_parallel_layers_start_xavier_normal_like_the_reference(kind):
    from paddle_tpu.distributed.fleet.meta_parallel import mp_layers as jmp
    shape = (512, 384)
    make = {"column": (lambda m: m.ColumnParallelLinear(*shape),
                       lambda: ColumnParallelLinear(*shape)),
            "row": (lambda m: m.RowParallelLinear(*shape),
                    lambda: RowParallelLinear(*shape)),
            "vocab": (lambda m: m.VocabParallelEmbedding(*shape),
                      lambda: VocabParallelEmbedding(*shape))}[kind]
    ref = make[0](jmp)
    port = make[1]()
    assert list(port.state_dict()) == list(ref.state_dict())
    _same_distribution(port.weight.detach().numpy(),
                       np.asarray(ref.weight.numpy()))
    std = math.sqrt(2 / sum(shape))
    assert abs(port.weight.std().item() - std) < 0.01 * std
    x = f32(2, shape[0]) if kind != "vocab" else np.array([[1, 7], [3, 0]])
    port.set_state_dict(ref_state(ref))
    np.testing.assert_allclose(
        port(torch.from_numpy(x)).detach().numpy(),
        np.asarray(ref(paddle.to_tensor(x)).numpy()), rtol=RTOL, atol=ATOL)


def test_parallel_cross_entropy_matches_reference():
    from paddle_tpu.distributed.fleet.meta_parallel import mp_layers as jmp
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ParallelCrossEntropy)
    x, lab = f32(4, 6), np.array([[1], [5], [-100], [0]])
    want = jmp.ParallelCrossEntropy()(paddle.to_tensor(x),
                                      paddle.to_tensor(lab))
    got = ParallelCrossEntropy()(torch.from_numpy(x), torch.from_numpy(lab))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=RTOL, atol=ATOL)


# -- nn.utils ----------------------------------------------------------------------

def _twin_linears(shape=(4, 3)):
    ref = jnn.Linear(*shape)
    port = tnn.Linear(*shape)
    port.set_state_dict(ref_state(ref))
    return ref, port


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_grad_norm_matches_reference(norm_type, max_norm):
    ref, port = _twin_linears()
    x = f32(5, 4)
    (ref(paddle.to_tensor(x)) ** 2).sum().backward()
    (port(torch.from_numpy(x)) ** 2).sum().backward()
    want = jutils.clip_grad_norm_(ref.parameters(), max_norm, norm_type)
    got = tutils.clip_grad_norm_(port.parameters(), max_norm, norm_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=RTOL)
    for (n, p), (_, q) in zip(port.named_parameters(),
                              ref.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(
            q.grad.numpy()), rtol=RTOL, atol=ATOL, err_msg=n)


def test_clip_grad_value_and_vector_round_trip():
    ref, port = _twin_linears()
    x = f32(5, 4)
    (ref(paddle.to_tensor(x)) ** 2).sum().backward()
    (port(torch.from_numpy(x)) ** 2).sum().backward()
    jutils.clip_grad_value_(ref.parameters(), 0.3)
    tutils.clip_grad_value_(port.parameters(), 0.3)
    for p, q in zip(port.parameters(), ref.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(
            q.grad.numpy()), rtol=RTOL, atol=ATOL)
    vec = tutils.parameters_to_vector(port.parameters())
    np.testing.assert_allclose(vec.detach().numpy(), np.asarray(
        jutils.parameters_to_vector(ref.parameters()).numpy()))
    tutils.vector_to_parameters(vec * 2, port.parameters())
    np.testing.assert_allclose(port.bias.detach().numpy(),
                               2 * np.asarray(ref.bias.numpy()), rtol=RTOL)


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_reference(dim):
    ref, port = _twin_linears()
    jutils.weight_norm(ref, dim=dim)
    tutils.weight_norm(port, dim=dim)
    assert list(port.state_dict()) == list(ref.state_dict())
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(port.state_dict()[k].detach().numpy(),
                                   np.asarray(v.numpy()), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    x = f32(5, 4)
    rx = ref(paddle.to_tensor(x))
    tx = port(torch.from_numpy(x))
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(rx.numpy()),
                               rtol=RTOL, atol=ATOL)
    (rx ** 2).sum().backward()
    (tx ** 2).sum().backward()
    for n in ("weight_g", "weight_v"):
        np.testing.assert_allclose(getattr(port, n).grad.numpy(), np.asarray(
            getattr(ref, n).grad.numpy()), rtol=1e-4, atol=1e-5, err_msg=n)
    jutils.remove_weight_norm(ref)
    tutils.remove_weight_norm(port)
    assert list(port.state_dict()) == list(ref.state_dict())
    np.testing.assert_allclose(port.weight.detach().numpy(), np.asarray(
        ref.weight.numpy()), rtol=RTOL, atol=ATOL)


def test_spectral_norm_matches_reference():
    ref, port = _twin_linears((5, 3))
    jutils.spectral_norm(ref, n_power_iterations=3)
    tutils.spectral_norm(port, n_power_iterations=3)
    assert list(port.state_dict()) == list(ref.state_dict())
    x = f32(2, 5)
    for _ in range(2):
        np.testing.assert_allclose(
            port(torch.from_numpy(x)).detach().numpy(),
            np.asarray(ref(paddle.to_tensor(x)).numpy()), rtol=1e-4,
            atol=1e-5)
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(port.state_dict()[k].detach().numpy(),
                                   np.asarray(v.numpy()), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
