"""Linear algebra ops (counterpart of ``paddle_tpu/tensor/linalg.py``,
Paddle's ``python/paddle/tensor/linalg.py``).  Products go to cuBLAS
through torch on the card: the reference runs them on XLA, not on a
hand-written kernel."""

from __future__ import annotations

import torch

from ..amp import maybe_autocast_arrays
from ..core import random_state
from ..ops.op import apply, register_many, register_op
from ._helpers import as_tensor

__all__ = [
    "matmul", "dot", "t", "norm", "bmm", "mm", "mv", "dist", "cross",
    "cholesky", "inv", "pinv", "det", "slogdet", "svd", "qr", "eig",
    "eigh", "eigvals", "eigvalsh", "matrix_power", "matrix_rank",
    "triangular_solve", "cholesky_solve", "solve", "lstsq", "lu",
    "multi_dot", "cov", "corrcoef", "householder_product", "vander",
    "vecdot", "matrix_norm", "vector_norm", "cond", "lu_unpack",
    "matrix_exp", "pca_lowrank",
]


def _matmul(x, y, transpose_x, transpose_y):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def _norm(x, p, axis, keepdim):
    """The reference's norm_op: "fro", "nuc", +-inf, 0 or a p-norm."""
    dims = axis if axis is None or isinstance(axis, tuple) else (axis,)
    if p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(x * x))
        return torch.sqrt(torch.sum(x * x, dim=dims, keepdim=keepdim))
    if p == "nuc":
        return torch.sum(torch.linalg.svdvals(x), dim=-1, keepdim=keepdim)
    if dims is None:
        dims = tuple(range(x.dim()))
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dims, keepdim=keepdim)
    if axis is None:
        return torch.pow(torch.sum(torch.pow(torch.abs(x), p)), 1.0 / p)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dims,
                               keepdim=keepdim), 1.0 / p)


def _triangular_solve(x, y, upper, transpose, unitriangular):
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


register_op("matmul_op", _matmul, "matmul")
register_op("dot_op", lambda x, y: torch.sum(x * y, dim=-1))
register_op("cross_op", lambda x, y, axis: torch.linalg.cross(x, y, dim=axis),
            "binary_broadcast")
register_op("norm_op", _norm, "reduction")
register_op("pinv_op", lambda x, rcond: torch.linalg.pinv(x, rtol=rcond))
register_many("square_matrix", {
    "cholesky_op": lambda x, upper: torch.linalg.cholesky(x, upper=upper),
    "inv_op": torch.linalg.inv,
    "det_op": torch.linalg.det,
    "matrix_power_op": lambda x, n: torch.linalg.matrix_power(x, n),
})
register_op("slogdet_op", lambda x: tuple(torch.linalg.slogdet(x)),
            "square_matrix")
register_many("solve", {"solve_op": torch.linalg.solve,
                        "triangular_solve_op": _triangular_solve})


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = maybe_autocast_arrays(x, y, op="matmul")
    return apply("matmul_op", x, y, transpose_x=bool(transpose_x),
                 transpose_y=bool(transpose_y))


def dot(x, y, name=None):
    return apply("dot_op", x, y)


def t(input, name=None):
    if input.dim() < 2:
        return input
    return apply("transpose_op", input, perm=(1, 0))


def norm(x, p=None, axis=None, keepdim=False, name=None):
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2.0
    ax = tuple(a % x.dim() for a in axis) if isinstance(axis, (list, tuple)) \
        else (None if axis is None else int(axis))
    return apply("norm_op", x, p=p if isinstance(p, str) else float(p),
                 axis=ax, keepdim=bool(keepdim))


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    if p == "fro":
        return apply("norm_op", x, p="fro",
                     axis=tuple(a % x.dim() for a in axis),
                     keepdim=bool(keepdim))
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                    keepdim=keepdim)


def bmm(x, y, name=None):
    return matmul(x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def mv(x, vec, name=None):
    return matmul(x, vec)


def dist(x, y, p=2, name=None):
    return norm(apply("subtract", x, y), p=float(p))


def cross(x, y, axis=9, name=None):
    if axis == 9:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return apply("cross_op", x, y, axis=int(axis))


def cholesky(x, upper=False, name=None):
    return apply("cholesky_op", x, upper=bool(upper))


def inv(x, name=None):
    return apply("inv_op", x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply("pinv_op", x, rcond=float(rcond))


def det(x, name=None):
    return apply("det_op", x)


def slogdet(x, name=None):
    sign, logdet = apply("slogdet_op", x)
    return torch.stack([sign, logdet], 0)


def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.transpose(-1, -2)


def qr(x, mode="reduced", name=None):
    return tuple(torch.linalg.qr(x, mode=mode))


def eig(x, name=None):
    return tuple(torch.linalg.eig(x))


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def matrix_power(x, n, name=None):
    return apply("matrix_power_op", x, n=int(n))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=hermitian)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return apply("triangular_solve_op", x, y, upper=bool(upper),
                 transpose=bool(transpose), unitriangular=bool(unitriangular))


def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(x, y, upper=upper)


def solve(x, y, name=None):
    return apply("solve_op", x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    res = torch.linalg.lstsq(x, y, rcond=rcond, driver=driver)
    return res.solution, res.residuals, res.rank, res.singular_values


def lu(x, pivot=True, get_infos=False, name=None):
    """LU factors and Paddle's 1-based sequential row swaps."""
    lu_, piv, info = torch.linalg.lu_factor_ex(x, pivot=pivot)
    return (lu_, piv, info) if get_infos else (lu_, piv)


def multi_dot(x, name=None):
    out = x[0]
    for m in x[1:]:
        out = matmul(out, m)
    return out


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return torch.cov(x if rowvar else x.t(), correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else x.t())


def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(x, tau)


def vander(x, n=None, increasing=False, name=None):
    return torch.vander(x, N=n, increasing=increasing)


def vecdot(x, y, axis=-1, name=None):
    return apply("sum_op", apply("multiply", x, y), axis=int(axis),
                 keepdim=False, dtype=None)


def cond(x, p=None, name=None):
    """Condition number: ||A||_p ||A^-1||_p (p None/2 by singular values)."""
    return torch.linalg.cond(x, p)


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True,
              name=None):
    p, l_, u = torch.lu_unpack(lu_data, lu_pivots, unpack_ludata,
                               unpack_pivots)
    return (p if unpack_pivots else None, l_ if unpack_ludata else None,
            u if unpack_ludata else None)


def matrix_exp(x, name=None):
    return torch.linalg.matrix_exp(x)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized PCA (Halko et al.), drawing from the device's
    generator."""
    a = as_tensor(x)
    m, n = a.shape[-2], a.shape[-1]
    q = min(6, m, n) if q is None else q
    if center:
        a = a - a.mean(-2, keepdim=True)
    r = torch.randn(a.shape[:-2] + (n, q), dtype=a.dtype, device=a.device,
                    generator=random_state.generator(a.device))
    y = a @ r
    for _ in range(niter):
        y = a @ (a.transpose(-2, -1) @ y)
    qmat, _ = torch.linalg.qr(y)
    u_b, s, vt = torch.linalg.svd(qmat.transpose(-2, -1) @ a,
                                  full_matrices=False)
    return qmat @ u_b, s, vt.transpose(-2, -1)
