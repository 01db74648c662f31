"""The port's ``quantization/`` (QAT, PTQ, observers, fake quanters,
``fake_quant_dequant``) against the reference's
(``paddle_tpu/quantization``), on ``tests/test_quantization.py``'s cases
(its Conv2D case waits for the port's convolution layers), with the same
weights and inputs in both packages (numpy from a seed).

Bounds: ``fake_quant_dequant`` is elementwise float32 in the reference's
order (``round(x / s * qmax)`` clipped, times ``s / qmax``): equal within
1e-6.  Through a network the matmuls sum in another order, so a value one
rounding from a grid step's midpoint may land on the other step (one
step, ``s / 127``, apart).  One forward: outputs and scales within 1e-5
relative of the reference's.  Over QAT's 25 Adam steps such flips come
and go (measured: the losses equal to 2.4e-7 for 7 steps, then apart by
at most 2.95e-4 relative, not growing): the first 5 losses within 1e-6,
all 25 within 1e-3 relative, and falling.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.quantization as JQ
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt

import paddle_tpu_torch as P
import paddle_tpu_torch.quantization as Q
from paddle_tpu_torch import nn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.quantize import calibration as tcal
from paddle_tpu.quantize import calibration as jcal

NET_RTOL = 1e-5
QAT_EARLY_RTOL = 1e-6
QAT_RTOL = 1e-3


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def test_fake_quant_dequant_numerics():
    vals = np.array([-1.0, -0.5, 0.0, 0.3, 0.9, 2.0], np.float32)
    out = _np(Q.fake_quant_dequant(torch.from_numpy(vals), scale=1.0,
                                   bit_length=8))
    qmax = 127.0
    ref = np.clip(np.round(vals.astype(np.float64) * qmax), -qmax,
                  qmax) / qmax
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert abs(out[3] - 0.3) < 1.0 / 127
    want = _np(JQ.fake_quant_dequant(paddle.to_tensor(vals), scale=1.0))
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits,axis", [(8, None), (4, None), (8, 0),
                                       (8, -1)])
def test_fake_quant_dequant_matches_reference(bits, axis):
    r = np.random.RandomState(bits + (axis or 0) + 5)
    x = (2 * r.randn(6, 5)).astype(np.float32)
    if axis is None:
        scale = np.float32(1.7)
    else:
        scale = np.abs(x).max(axis=1 if axis == 0 else 0) * 0.8
    got = _np(Q.fake_quant_dequant(torch.from_numpy(x), scale, bits, axis))
    want = _np(JQ.fake_quant_dequant(paddle.to_tensor(x), scale, bits, axis))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fake_quant_ste_gradient():
    x = torch.tensor([-2.0, -0.5, 0.5, 2.0], requires_grad=True)
    Q.fake_quant_dequant(x, scale=1.0).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 1.0, 1.0, 0.0])
    # a per-channel tensor scale: the same pass-through inside each
    # channel's range, and the reference's gradient
    w = np.array([[1.0, 10.0], [0.1, -20.0], [3.0, 0.5]], np.float32)
    s = np.array([0.5, 15.0], np.float32)
    xt = torch.from_numpy(w.copy()).requires_grad_(True)
    (Q.fake_quant_dequant(xt, torch.from_numpy(s), 8, -1) * 3.0).sum() \
        .backward()
    xj = paddle.to_tensor(w)
    xj.stop_gradient = False
    (JQ.fake_quant_dequant(xj, paddle.to_tensor(s), 8, -1) * 3.0).sum() \
        .backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(xj.grad.numpy()))
    np.testing.assert_array_equal(xt.grad.numpy(), 3.0 * (np.abs(w) <= s))


def test_channelwise_fake_quant():
    w = np.array([[1.0, 10.0], [0.1, -20.0]], np.float32)
    q = Q.FakeQuanterChannelWiseAbsMax(quant_axis=-1)
    out = _np(q(torch.from_numpy(w)))
    steps = np.array([1.0, 20.0]) / 127.0
    assert (np.abs(out - w) <= 0.5 * steps + 1e-7).all()
    np.testing.assert_allclose(q.scales(), [1.0, 20.0])
    jq = JQ.FakeQuanterChannelWiseAbsMax(quant_axis=-1)
    np.testing.assert_allclose(out, _np(jq(paddle.to_tensor(w))), rtol=1e-6)


def nets(sizes, seed):
    """The reference's Sequential of Linear/ReLU made after
    ``paddle.seed(seed)``, as ``tests/test_quantization.py`` makes it, and
    the port's with the same weights."""
    paddle.seed(seed)
    jl, tl = [], []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        j = jnn.Linear(a, b)
        t = nn.Linear(a, b, device="cpu")
        with torch.no_grad():
            t.weight.copy_(torch.from_numpy(_np(j.weight)))
            t.bias.copy_(torch.from_numpy(_np(j.bias)))
        jl.append(j)
        tl.append(t)
        if i < len(sizes) - 2:
            jl.append(jnn.ReLU())
            tl.append(nn.ReLU())
    return jnn.Sequential(*jl), nn.Sequential(*tl)


def qat_config(pkg):
    return pkg.QuantConfig(
        activation=pkg.FakeQuanterWithAbsMaxObserver,
        weight=lambda: pkg.FakeQuanterChannelWiseAbsMax(quant_axis=-1))


def close(got, want, rtol=NET_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30), \
        (np.abs(got - want).max(), np.abs(want).max())


def test_qat_quantize_swaps_and_trains_as_the_reference():
    """QAT's swap, then 25 Adam steps of cross entropy on both packages:
    the first 5 losses within QAT_EARLY_RTOL of the reference's, all
    within QAT_RTOL, falling; the activation scale within QAT_RTOL."""
    jnet, tnet = nets([8, 16, 4], 0)
    jnet = JQ.QAT(qat_config(JQ)).quantize(jnet, inplace=True)
    tnet = Q.QAT(qat_config(Q)).quantize(tnet, inplace=True)
    from paddle_tpu_torch.quantization.qat_layers import QuantedLinear
    assert isinstance(tnet[0], QuantedLinear)
    assert isinstance(tnet[2], QuantedLinear)
    jo = jopt.Adam(0.01, parameters=jnet.parameters())
    to = topt.Adam(0.01, parameters=tnet.parameters())
    rs = np.random.RandomState(0)
    x = rs.randn(32, 8).astype("float32")
    y = rs.randint(0, 4, (32, 1)).astype("int64")
    jl, tl = [], []
    for _ in range(25):
        loss = jnn.CrossEntropyLoss()(jnet(paddle.to_tensor(x)),
                                      paddle.to_tensor(y))
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(loss.numpy()))
        tloss = nn.CrossEntropyLoss()(tnet(torch.from_numpy(x)),
                                      torch.from_numpy(y))
        tloss.backward()
        to.step()
        to.clear_grad()
        tl.append(tloss.item())
    close(tl[:5], jl[:5], QAT_EARLY_RTOL)
    close(tl, jl, QAT_RTOL)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tnet[0].activation_quanter.scales(),
                               jnet[0].activation_quanter.scales(),
                               rtol=QAT_RTOL)


def test_qat_convert_close_to_float_and_to_the_reference():
    jnet, tnet = nets([8, 8, 2], 78)
    x = np.random.RandomState(1).randn(16, 8).astype("float32")
    float_out = _np(tnet(torch.from_numpy(x)))
    close(float_out, _np(jnet(paddle.to_tensor(x))))
    outs = []
    for pkg, net, T in ((JQ, jnet, paddle.to_tensor),
                        (Q, tnet, torch.from_numpy)):
        qat = pkg.QAT(qat_config(pkg))
        net = qat.quantize(net, inplace=True)
        net.train()
        net(T(x))  # one pass to settle activation scales
        net.eval()
        qat.convert(net, inplace=True)
        outs.append(_np(net(T(x))))
    from paddle_tpu_torch.quantization.qat_layers import ConvertedLinear
    assert isinstance(tnet[0], ConvertedLinear)
    assert not tnet[0].weight.requires_grad
    q_out = outs[1]
    assert np.abs(q_out - float_out).max() < \
        0.15 * np.abs(float_out).max() + 0.05
    close(q_out, outs[0])


def test_ptq_with_observers_as_the_reference():
    """EMA activation observers and channel-wise weight observers over
    four calibration batches: outputs unchanged while observing, scales
    and the converted outputs within NET_RTOL of the reference's."""
    jnet, tnet = nets([8, 8, 2], 77)
    x = np.random.RandomState(2).randn(64, 8).astype("float32")
    float_out = _np(tnet(torch.from_numpy(x)))
    res = []
    for pkg, net, T in ((JQ, jnet, paddle.to_tensor),
                        (Q, tnet, torch.from_numpy)):
        cfg = pkg.QuantConfig(
            activation=pkg.EMAObserver,
            weight=lambda: pkg.AbsMaxChannelWiseWeightObserver(quant_axis=-1))
        ptq = pkg.PTQ(cfg)
        net = ptq.quantize(net, inplace=True)
        for i in range(0, 64, 16):
            net(T(x[i:i + 16]))
        observed = _np(net(T(x)))
        scales = [net[0].activation_quanter.scales(),
                  net[2].activation_quanter.scales()]
        ptq.convert(net, inplace=True)
        res.append((observed, scales, _np(net(T(x)))))
    np.testing.assert_allclose(res[1][0], float_out, rtol=1e-5)
    close(res[1][1], res[0][1])
    q_out = res[1][2]
    assert np.abs(q_out - float_out).max() < \
        0.15 * np.abs(float_out).max() + 0.05
    close(q_out, res[0][2])


def test_layer_and_type_config_precedence():
    l1 = nn.Linear(4, 4, device="cpu")
    l2 = nn.Linear(4, 4, device="cpu")
    cfg = Q.QuantConfig()
    cfg.add_type_config(nn.Linear, activation=Q.FakeQuanterWithAbsMaxObserver,
                        weight=Q.FakeQuanterWithAbsMaxObserver)
    cfg.add_layer_config(l2, activation=None, weight=None)
    assert cfg.need_quantize(l1)
    aq = cfg.activation_quanter_for(l1)
    assert isinstance(aq, Q.FakeQuanterWithAbsMaxObserver)
    assert cfg.activation_quanter_for(l2) is None
    # a prototype instance is copied a site
    proto = Q.FakeQuanterWithAbsMaxObserver(moving_rate=0.5)
    cfg.add_layer_config(l1, activation=proto)
    inst = cfg.activation_quanter_for(l1)
    assert inst is not proto and inst._rate == 0.5
    assert Q.BaseQuanter is Q.FakeQuanterWithAbsMaxObserver

    @Q.quanter("MyQuanter")
    class MyQuanter(Q.FakeQuanterWithAbsMaxObserver):
        pass

    assert Q.MyQuanter is MyQuanter


def test_quant_and_calibration_round_trip_through_observers(tmp_path):
    """``from_observers`` gives the reference's payload for the same
    observers; ``seed_observer`` (through ``PTQ.load_calibration`` of a
    dumped file) gives a fresh model's observers the same scales, so its
    convert() equals the calibrated one's without a sample batch."""
    _, tnet = nets([8, 8, 2], 5)
    x = np.random.RandomState(9).randn(32, 8).astype("float32")
    cfg = Q.QuantConfig(
        activation=Q.AbsmaxObserver,
        weight=lambda: Q.AbsMaxChannelWiseWeightObserver(quant_axis=-1))
    ptq = Q.PTQ(cfg)
    tnet = ptq.quantize(tnet, inplace=True)
    tnet(torch.from_numpy(x))
    path = str(tmp_path / "calib.json")
    payload = ptq.dump_calibration(tnet, path)
    obs = ptq._observers(tnet)
    assert sorted(payload["params"]) == sorted(obs)
    ref_payload = jcal.from_observers(obs)
    for name, entry in payload["params"].items():
        want = ref_payload["params"][name]
        assert {k: v for k, v in entry.items()} == want
    assert payload["schema"] == ref_payload["schema"] == \
        tcal.CALIBRATION_SCHEMA
    a0 = tnet[0].activation_quanter
    assert a0.calibration_entry() == jcal.from_observers({"x": a0})[
        "params"]["x"]
    # a fresh model's observers seeded from the dump (no sample batch):
    # activation scales equal; a channel-wise weight observer takes the
    # entry's one absmax for every channel, as the reference's does, so
    # the converted model is compared with the reference's same round trip
    jnet, fresh = nets([8, 8, 2], 5)
    fresh = Q.PTQ(cfg).quantize(fresh, inplace=True)
    assert Q.PTQ(cfg).load_calibration(fresh, path) == len(obs)
    assert fresh[0].activation_quanter.scales() == a0.scales()
    jcfg = JQ.QuantConfig(
        activation=JQ.AbsmaxObserver,
        weight=lambda: JQ.AbsMaxChannelWiseWeightObserver(quant_axis=-1))
    jnet = JQ.PTQ(jcfg).quantize(jnet, inplace=True)
    assert JQ.PTQ(jcfg).load_calibration(jnet, path) == len(obs)
    Q.PTQ(cfg).convert(fresh, inplace=True)
    JQ.PTQ(jcfg).convert(jnet, inplace=True)
    close(_np(fresh(torch.from_numpy(x))), _np(jnet(paddle.to_tensor(x))))
    # a per-channel observer seeded from one entry takes its absmax as the
    # running max, as the reference's seed_observer does
    for seeded, cal in ((Q.AbsMaxChannelWiseWeightObserver(), tcal),
                        (JQ.AbsMaxChannelWiseWeightObserver(), jcal)):
        seeded._max = np.array([0.5, 2.0], np.float32)
        cal.seed_observer(seeded, {"absmax": 1.0})
        np.testing.assert_allclose(seeded._max, [1.0, 2.0])
    e = Q.AbsmaxObserver()
    e.load_calibration_entry({"absmax": 3.5})
    assert e.scales() == 3.5


def test_fake_quant_dequant_is_a_registry_op():
    from paddle_tpu_torch.ops import op
    assert "fake_quant_dequant" in op.all_ops()
    x = torch.tensor([0.3, -2.0])
    np.testing.assert_array_equal(
        op.apply("fake_quant_dequant", x, 1.0, bit_length=8,
                 channel_axis=None).numpy(),
        Q.fake_quant_dequant(x, 1.0).numpy())
    assert P.quantization is Q
