"""The port's autograd package (paddle_tpu_torch/autograd) against the
JAX package's: backward and grad with Paddle's argument semantics (the
cases of tests/test_autograd.py, run in both), PyLayer, jacobian,
hessian, jvp, vjp and saved_tensors_hooks, on the same numpy inputs.
f32 within 1e-5 relative (the same derivatives in another order)."""

import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as P
from paddle_tpu_torch import autograd as ta
from paddle_tpu_torch.core import tensor as tt

RTOL = 1e-5


def jt(v):
    return paddle.to_tensor(np.asarray(v, np.float32), stop_gradient=False)


def pt(v):
    return torch.tensor(np.asarray(v, np.float32), requires_grad=True)


def jnp_(t):
    return np.asarray(t.numpy())


# ---------------------------------------------------------------------------
# backward: tests/test_autograd.py's cases through both packages
# ---------------------------------------------------------------------------

def _chain(mk, back):
    x = mk(2.0)
    back(x * x * x)
    return x


def _fanin(mk, back):
    x = mk([1.0, 2.0])
    back(((x * 2.0) + (x * 3.0)).sum())
    return x


def _detach(mk, back):
    x = mk([1.0])
    y = x * 2.0
    back(y + y.detach() * 3.0)
    return x


def _double_use(mk, back):
    x = mk([3.0])
    back(x * x)
    return x


def _deep(mk, back):
    x = mk([1.0])
    y = x
    for _ in range(50):
        y = y + x * 0.1
    back(y)
    return x


CASES = {"chain": _chain, "fanin": _fanin, "detach": _detach,
         "double_use": _double_use, "deep": _deep}


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_reference(case):
    jx = CASES[case](jt, lambda y: y.backward())
    tx = CASES[case](pt, lambda y: ta.backward([y]))
    np.testing.assert_allclose(tx.grad.numpy(), jnp_(jx.grad), rtol=RTOL)


def test_backward_accumulates_and_retains_graph():
    for mk, back in ((jt, lambda y, **k: y.backward(**k)),
                     (pt, lambda y, **k: tt.backward(y, **k))):
        x = mk([1.0])
        y = x * x
        back(y, retain_graph=True)
        back(y)
        np.testing.assert_allclose(np.asarray(x.grad.numpy()), [4.0])


def test_non_scalar_backward_needs_grad():
    """Both raise RuntimeError without a cotangent for a 2-element
    output, and take one."""
    x = pt([1.0, 2.0])
    y = x * 2.0
    with pytest.raises(RuntimeError, match="scalar"):
        ta.backward(y)
    ta.backward([y], [torch.ones(2)])
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])


def test_grad_leaves_accumulators_and_allow_unused():
    jx, jy = jt([2.0]), jt([3.0])
    jgx, jgy = paddle.grad(jx * jy + jx, [jx, jy])
    tx, ty = pt([2.0]), pt([3.0])
    tgx, tgy = P.grad(tx * ty + tx, [tx, ty])
    np.testing.assert_allclose(tgx.numpy(), jnp_(jgx))
    np.testing.assert_allclose(tgy.numpy(), jnp_(jgy))
    assert tx.grad is None and ty.grad is None
    tz = pt([1.0])
    with pytest.raises(RuntimeError, match="allow_unused"):
        P.grad(tx * 2.0, [tx, tz])
    gx, gz = P.grad(tx * 2.0, [tx, tz], allow_unused=True)
    assert gz is None and gx.item() == 2.0


def test_grad_create_graph_gives_second_derivative():
    x = pt([1.5])
    (g,) = P.grad(x ** 3, [x], create_graph=True)
    (h,) = P.grad(g, [x])
    np.testing.assert_allclose(h.detach().numpy(), [9.0], rtol=RTOL)


# ---------------------------------------------------------------------------
# PyLayer
# ---------------------------------------------------------------------------

def _cube(mod):
    class Cube(mod.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor
            return grad * 3.0 * x * x
    return Cube


def _addmul(mod):
    class AddMul(mod.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b, scale=1.0):
            ctx.save_for_backward(a, b)
            ctx.scale = scale
            return a + b, a * b * scale

        @staticmethod
        def backward(ctx, ga, gb):
            a, b = ctx.saved_tensor
            return ga + gb * b * ctx.scale, ga + gb * a * ctx.scale
    return AddMul


def test_pylayer_matches_reference():
    v = np.array([2.0, -1.5, 0.5], np.float32)
    jx, tx = jt(v), pt(v)
    jy = _cube(paddle).apply(jx)
    ty = _cube(P).apply(tx)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jnp_(jy), rtol=RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), jnp_(jx.grad), rtol=RTOL)


def test_pylayer_multi_io_with_keyword_and_list_outputs():
    ja, jb, ta_, tb = jt([2.0]), jt([5.0]), pt([2.0]), pt([5.0])
    js, jp = _addmul(paddle).apply(ja, jb, scale=0.5)
    outs = _addmul(P).apply(ta_, tb, scale=0.5)
    assert isinstance(outs, list) and len(outs) == 2
    ts, tp = outs
    (js + jp).backward()
    (ts + tp).backward()
    np.testing.assert_allclose(ta_.grad.numpy(), jnp_(ja.grad), rtol=RTOL)
    np.testing.assert_allclose(tb.grad.numpy(), jnp_(jb.grad), rtol=RTOL)


def test_pylayer_non_differentiable_and_materialized_grads():
    """A marked output gets no gradient; with materialize on (the
    default) a missing output gradient reaches backward as zeros, with
    it off as None."""
    seen = []

    class Split(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, materialize=True):
            idx = torch.argmax(x)
            ctx.mark_non_differentiable(idx)
            ctx.set_materialize_grads(materialize)
            return x * 2.0, x * 3.0, idx

        @staticmethod
        def backward(ctx, g1, g2, gidx):
            seen.append(g2)
            g2 = torch.zeros_like(g1) if g2 is None else g2
            return g1 * 2.0 + g2 * 3.0

    for mat in (True, False):
        x = pt([1.0, 4.0])
        a, b, idx = Split.apply(x, materialize=mat)
        assert not idx.requires_grad and idx.item() == 1
        a.sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])
    assert torch.equal(seen[0], torch.zeros(2)) and seen[1] is None


def test_pylayer_without_grad_returns_plain_outputs():
    x = torch.tensor([1.0, 2.0])
    y = _cube(P).apply(x)
    assert not y.requires_grad
    np.testing.assert_allclose(y.numpy(), [1.0, 8.0])


# ---------------------------------------------------------------------------
# jacobian, hessian, jvp, vjp
# ---------------------------------------------------------------------------

def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    if isinstance(x, np.ndarray):
        return x
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x.numpy())


def assert_tree_close(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_close(g, w)
        return
    assert np.shape(got) == np.shape(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


X = np.array([[0.5, -1.0, 2.0], [1.5, 0.25, -0.75]], np.float32)
Y = np.array([[1.0, 2.0, -0.5], [0.3, -1.2, 0.8]], np.float32)


def _f1(mod):
    return lambda x: mod.tanh(x) * x


def _f2(mod):
    return lambda x, y: (mod.sin(x) * y, x * y)


def _fs(mod):
    return lambda x, y: (x * x * y).sum()


@pytest.mark.parametrize("fn", ["jacobian", "hessian", "jvp", "vjp"])
def test_functional_matches_reference(fn):
    from paddle_tpu.autograd import functional as jf
    from paddle_tpu_torch.autograd import functional as tf
    jx, jy = paddle.to_tensor(X), paddle.to_tensor(Y)
    tx, ty = torch.from_numpy(X), torch.from_numpy(Y)
    if fn == "jacobian":
        assert_tree_close(tf.jacobian(_f1(torch), tx),
                          jf.jacobian(_f1(paddle), jx))
        assert_tree_close(tf.jacobian(_f2(torch), [tx, ty]),
                          jf.jacobian(_f2(paddle), [jx, jy]))
    elif fn == "hessian":
        assert_tree_close(tf.hessian(lambda x: (x ** 3).sum(), tx),
                          jf.hessian(lambda x: (x ** 3).sum(), jx))
        assert_tree_close(tf.hessian(_fs(torch), [tx, ty]),
                          jf.hessian(_fs(paddle), [jx, jy]))
    elif fn == "jvp":
        assert_tree_close(tf.jvp(_f1(torch), tx, ty),
                          jf.jvp(_f1(paddle), jx, jy))
        assert_tree_close(tf.jvp(_f2(torch), [tx, ty]),
                          jf.jvp(_f2(paddle), [jx, jy]))
    else:
        assert_tree_close(tf.vjp(_f1(torch), tx, ty),
                          jf.vjp(_f1(paddle), jx, jy))
        assert_tree_close(tf.vjp(_f2(torch), [tx, ty]),
                          jf.vjp(_f2(paddle), [jx, jy]))


def test_functional_through_registry_ops():
    """The op surface's functions (registry ops) under torch.func."""
    tx = torch.from_numpy(X)
    jx = paddle.to_tensor(X)
    assert_tree_close(
        ta.jacobian(lambda x: P.matmul(x, x, transpose_y=True), tx),
        paddle.autograd.jacobian(
            lambda x: paddle.matmul(x, x, transpose_y=True), jx))


# ---------------------------------------------------------------------------
# saved_tensors_hooks
# ---------------------------------------------------------------------------

def test_saved_tensors_hooks_fire_and_keep_gradients():
    """Pack and unpack fire for the saved tensors (an offload to numpy and
    back, as the reference's test does); the gradient equals the
    reference's; the active hooks are named while the context is open."""
    packed, unpacked = [], []
    x = pt(X)
    hooks = ta.saved_tensors_hooks(
        lambda a: (packed.append(1), a.detach().numpy())[1],
        lambda a: (unpacked.append(1), torch.from_numpy(a))[1])
    with hooks:
        assert ta.current_saved_tensors_hooks() is hooks
        y = (x * x * torch.sin(x)).sum()
    assert ta.current_saved_tensors_hooks() is None
    y.backward()
    jx = jt(X)
    (jx * jx * paddle.sin(jx)).sum().backward()
    assert packed and unpacked
    np.testing.assert_allclose(x.grad.numpy(), jnp_(jx.grad), rtol=RTOL)


def _double_square(alive):
    class DoubleSquare(P.autograd.PyLayer):
        """y = (2x)^2, saving the intermediate 2x (a weakref to it kept)."""

        @staticmethod
        def forward(ctx, x):
            h = x * 2.0
            alive.append(weakref.ref(h))
            ctx.save_for_backward(h)
            return h * h

        @staticmethod
        def backward(ctx, grad):
            (h,) = ctx.saved_tensor
            return grad * 4.0 * h
    return DoubleSquare


def test_saved_tensors_hooks_pack_frees_pylayer_saved_tensor():
    """A pack hook that offloads a PyLayer's saved tensor leaves it with no
    other holder: the tensor is freed when forward returns (by reference
    count, no collector run), and unpack gives backward its values."""
    alive, packed, unpacked = [], [], []
    x = pt([1.0, -2.0, 0.5])
    with ta.saved_tensors_hooks(
            lambda a: (packed.append(1), a.detach().numpy().copy())[1],
            lambda a: (unpacked.append(1), torch.from_numpy(a))[1]):
        y = _double_square(alive).apply(x)
    assert len(packed) == 1 and alive[0]() is None
    y.sum().backward()
    assert len(unpacked) == 1
    np.testing.assert_allclose(x.grad.numpy(), 8.0 * x.detach().numpy(),
                               rtol=RTOL)


def test_pylayer_saved_tensor_freed_after_backward():
    """With no hooks torch holds the saved tensor until backward and frees
    it then (by reference count, no collector run)."""
    alive = []
    x = pt([1.0, -2.0, 0.5])
    y = _double_square(alive).apply(x)
    assert alive[0]() is not None
    y.sum().backward()
    assert alive[0]() is None
    np.testing.assert_allclose(x.grad.numpy(), 8.0 * x.detach().numpy(),
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# core/tensor.py: the Tensor methods as free functions
# ---------------------------------------------------------------------------

def test_tensor_methods_as_functions_match_reference():
    v = np.arange(12, dtype=np.float32).reshape(3, 4) - 5.5
    j = paddle.to_tensor(v)
    t = torch.from_numpy(v.copy())
    assert tt.shape(t) == j.shape
    assert tt.ndim(t) == j.ndim == tt.dim(t) == tt.ndimension(t)
    assert tt.size(t) == j.size == tt.numel(t) == j.numel()
    assert tt.element_size(t) == j.element_size()
    assert tt.strides(t) == j.strides
    assert tt.is_contiguous(t) and tt.contiguous(t) is t
    np.testing.assert_array_equal(tt.numpy(tt.T(t)), j.T.numpy())
    np.testing.assert_array_equal(tt.numpy(t), j.numpy())
    assert tt.item(t, 1, 2) == j.item(1, 2)
    assert tt.tolist(t) == j.tolist()
    assert tt.stop_gradient(t) == j.stop_gradient is True
    tt.set_stop_gradient(t, False)
    assert tt.requires_grad(t) and not tt.stop_gradient(t)
    assert tt.is_leaf(t) and not tt.is_leaf(t * 2.0)
    assert tt.place(t) == torch.device("cpu")
    assert tt.astype(t, "float16").dtype == torch.float16
    assert tt.to(t, "float64").dtype == torch.float64
    assert tt.to(t, "cpu", dtype="int32").dtype == torch.int32
    d = tt.detach(t)
    assert not d.requires_grad
    tt.set_value(d, 7.0)
    j2 = paddle.to_tensor(v)
    j2.set_value(np.full((3, 4), 7.0, np.float32))
    np.testing.assert_array_equal(tt.numpy(d), j2.numpy())
    tt.copy_(d, np.ones((3, 4), np.float32))
    assert float(d.sum()) == 12.0


def test_tensor_grad_functions():
    x = pt([1.0, 2.0])
    y = x * 3.0
    tt.retain_grads(y)
    calls = []
    handle = tt.register_hook(x, lambda g: (calls.append(1), g * 2.0)[1])
    tt.backward(y.sum())
    np.testing.assert_allclose(tt.grad(y).numpy(), [1.0, 1.0])
    np.testing.assert_allclose(tt.grad(x).numpy(), [6.0, 6.0])
    handle.remove()
    tt.clear_gradient(x)
    assert tt.grad(x) is None and calls == [1]
    tt.set_grad(x, np.array([0.5, 0.5], np.float32))
    np.testing.assert_allclose(x.grad.numpy(), [0.5, 0.5])
    tt.clear_grad(x)
    assert x.grad is None
