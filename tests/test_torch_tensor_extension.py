"""The port's tensor/extension.py against the JAX package's: each of its
48 functions on the same numpy inputs, exported at the top level as the
reference exports them.  float32 within 1e-5 (1e-4 for the special
functions, whose series differ between the two libraries); integer,
bool and shape results exactly; gradients of the differentiable
compositions within 1e-5."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import extension as jext
import paddle_tpu_torch as P
from paddle_tpu_torch.tensor import extension as text

R = np.random.default_rng(0)
A = R.standard_normal((3, 4)).astype(np.float32)
B = R.standard_normal((5, 4)).astype(np.float32)
POS = (R.random((3, 4)) * 3 + 0.2).astype(np.float32)
INTS = np.array([3, 1, 3, 2, 2, 2, 7, 1], np.int64)


def j(x):
    return paddle.to_tensor(x)


def t(x):
    return torch.from_numpy(np.array(x))


# (name, args as numpy, kwargs, tolerance): each arg given to both
# packages as a tensor, lists of arrays as lists of tensors
CASES = [
    ("unique", [INTS], dict(return_index=True, return_inverse=True,
                            return_counts=True), 0),
    ("unique", [np.array([[1, 2], [1, 2], [0, 5]])], dict(axis=0), 0),
    ("unique_consecutive", [INTS], dict(return_inverse=True,
                                        return_counts=True), 0),
    ("argwhere", [A > 0], {}, 0),
    ("take", [A, np.array([[0, 11], [-1, 5]])], {}, 0),
    ("take", [A, np.array([13, -20])], dict(mode="wrap"), 0),
    ("take", [A, np.array([13, -20])], dict(mode="clip"), 0),
    ("block_diag", [[A, B[:2, :3], np.float32(2.0) * np.ones(3,
                                                            np.float32)]],
     {}, 0),
    ("cartesian_prod", [[np.array([1, 2]), np.array([3, 4, 5])]], {}, 0),
    ("cdist", [A, B], {}, 1e-5),
    ("cdist", [A, B], dict(p=1.0), 1e-5),
    ("cdist", [A, B], dict(p=float("inf")), 1e-5),
    ("trapezoid", [A], {}, 1e-5),
    ("trapezoid", [A], dict(dx=0.5, axis=0), 1e-5),
    ("trapezoid", [A, np.array([0.0, 0.5, 1.5, 2.0], np.float32)], {},
     1e-5),
    ("cumulative_trapezoid", [A], dict(dx=0.25), 1e-5),
    ("cumulative_trapezoid", [A, np.array([0.0, 1.0, 1.5, 3.0],
                                          np.float32)], {}, 1e-5),
    ("renorm", [A, 2.0, 0, 1.0], {}, 1e-5),
    ("multigammaln", [POS + 2.0, 3], {}, 1e-4),
    ("polygamma", [POS, 1], {}, 1e-4),
    ("signbit", [A], {}, 0),
    ("sinc", [A], {}, 1e-5),
    ("copysign", [A, B[:3]], {}, 0),
    ("gammaln", [POS], {}, 1e-4),
    ("gammainc", [POS, POS.T.copy().reshape(3, 4)], {}, 1e-4),
    ("gammaincc", [POS, POS.T.copy().reshape(3, 4)], {}, 1e-4),
    ("i0", [A], {}, 1e-4),
    ("i1", [A], {}, 1e-4),
    ("i0e", [A], {}, 1e-4),
    ("i1e", [A], {}, 1e-4),
    ("isneginf", [np.array([-np.inf, 1.0, np.inf], np.float32)], {}, 0),
    ("isposinf", [np.array([-np.inf, 1.0, np.inf], np.float32)], {}, 0),
    ("isreal", [np.array([1 + 0j, 2 + 1j], np.complex64)], {}, 0),
    ("logaddexp", [A, B[:3]], {}, 1e-5),
    ("logaddexp2", [A, B[:3]], {}, 1e-5),
    ("nextafter", [A, B[:3]], {}, 0),
    ("positive", [A], {}, 0),
    ("frexp", [A * 100], {}, 0),
    ("slice_scatter", [A, np.zeros((3, 2), np.float32), [1], [1], [4],
                       [2]], {}, 0),
    ("index_fill", [A, np.array([0, 2]), 1, -1.5], {}, 0),
    ("column_stack", [[np.arange(3.0), A[:, :2]]], {}, 0),
    ("row_stack", [[np.arange(4.0, dtype=np.float32), A]], {}, 0),
    ("hstack", [[A, A[:, :1]]], {}, 0),
    ("vstack", [[A, A[:1]]], {}, 0),
    ("dstack", [[A, A]], {}, 0),
    ("addmm", [np.ones((3, 5), np.float32), A, B.T.copy()],
     dict(beta=0.5, alpha=2.0), 1e-5),
    ("pdist", [B], {}, 1e-5),
    ("sgn", [np.array([3 + 4j, 0j, -2j], np.complex64)], {}, 1e-6),
    ("sgn", [A], {}, 0),
    ("unflatten", [np.arange(24.0).reshape(2, 12), 1, [3, 4]], {}, 0),
    ("diagonal_scatter", [np.zeros((3, 4), np.float32),
                          np.array([1.0, 2.0, 3.0], np.float32)], {}, 0),
    ("diagonal_scatter", [np.zeros((3, 4), np.float32),
                          np.array([1.0, 2.0], np.float32)],
     dict(offset=2), 0),
    ("as_complex", [A[:, :2].copy()], {}, 0),
    ("as_real", [np.array([1 + 2j, -3j], np.complex64)], {}, 0),
    ("shard_index", [np.array([[1], [6], [12], [19]])], dict(
        index_num=20, nshards=2, shard_id=1), 0),
]


def _arg(x, conv):
    if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
        return [conv(v) for v in x]
    return conv(x) if isinstance(x, np.ndarray) else x


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def assert_same(got, want, tol):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w, tol)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    if tol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_extension_op_matches_reference(i):
    name, args, kw, tol = CASES[i]
    want = getattr(jext, name)(*[_arg(a, j) for a in args], **kw)
    got = getattr(text, name)(*[_arg(a, t) for a in args], **kw)
    assert_same(got, want, tol)


def test_every_extension_function_is_exported_and_tested():
    assert text.__all__ == jext.__all__
    tested = {c[0] for c in CASES} | {"index_fill_", "addmm_",
                                      "broadcast_shape"}
    assert set(text.__all__) == tested
    for name in text.__all__:
        assert getattr(P, name) is getattr(text, name), name


def test_take_raise_mode_and_inplace_variants():
    with pytest.raises(IndexError, match="out of range"):
        text.take(t(A), t(np.array([12])))
    x = t(A.copy())
    out = text.index_fill_(x, t(np.array([1])), 0, 9.0)
    assert out is x and (x[1] == 9.0).all()
    want = jext.addmm(j(np.ones((3, 5), np.float32)), j(A), j(B.T.copy()))
    y = t(np.ones((3, 5), np.float32))
    assert text.addmm_(y, t(A), t(B.T.copy())) is y
    assert_same(y, want, 1e-5)
    assert text.broadcast_shape([3, 1, 4], [5, 1]) == \
        jext.broadcast_shape([3, 1, 4], [5, 1]) == [3, 5, 4]


@pytest.mark.parametrize("name", ["cdist", "renorm", "trapezoid",
                                  "addmm"])
def test_extension_gradients_match_reference(name):
    args = {"cdist": [A, B], "renorm": [A, 2.0, 0, 1.0],
            "trapezoid": [A], "addmm": [np.ones((3, 5), np.float32), A,
                                        B.T.copy()]}[name]
    jx = paddle.to_tensor(args[0] if name != "addmm" else args[1],
                          stop_gradient=False)
    tx = torch.tensor(args[0] if name != "addmm" else args[1],
                      requires_grad=True)
    pos = 0 if name != "addmm" else 1
    jargs = [_arg(a, j) for a in args]
    targs = [_arg(a, t) for a in args]
    jargs[pos], targs[pos] = jx, tx
    getattr(jext, name)(*jargs).sum().backward()
    getattr(text, name)(*targs).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               rtol=1e-5, atol=1e-6)
