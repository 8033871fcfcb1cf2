"""Linear algebra on torch tensors: ``paddle_tpu/ops/linalg.py``'s functions.

The matrix products run on cuBLAS through ``torch.matmul``; the
decompositions and solves on ``torch.linalg`` (cuSOLVER on the card), as the
JAX package leaves them to XLA's. Each keeps the JAX function's argument
order, output order and dtypes: 1-based LU pivots (LAPACK's), the Cholesky
factor as the second argument of ``cholesky_solve``, ``lstsq`` by SVD with
its residuals, rank and singular values. The ``*_ex`` forms are used where
torch has one, so a singular or indefinite input gives NaN or inf as XLA's
does, not an error read back from the card.
"""
from __future__ import annotations

import torch

from ..core.dtype import inexact
from .math import operands


def matmul(x, y, *, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    x, y = operands(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(dt), y.to(dt))


def dot(x, y):
    # paddle.dot: elementwise product summed over the last axis
    prod = torch.multiply(*operands(x, y))
    return torch.sum(prod, dim=-1, dtype=None if prod.is_floating_point() else torch.int64)


mm = matmul
bmm = matmul
mv = matmul


def t(x):
    return x.t() if x.dim() >= 2 else x


def norm(x, *, p="fro", axis=None, keepdim=False):
    dims = tuple(range(x.dim())) if axis is None else (
        tuple(axis) if isinstance(axis, (list, tuple)) else (axis,))
    if p == "fro" or (p == 2 and axis is None):
        return torch.sqrt(torch.sum(torch.square(torch.abs(x)), dim=dims, keepdim=keepdim))
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=dims, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=dims, keepdim=keepdim), 1.0 / p)


def dist(x, y, *, p=2.0):
    return norm(x - y, p=p)


def cross(x, y, *, axis=None):
    return torch.linalg.cross(x, y, dim=-1 if axis is None else axis)


def trace(x, *, offset=0, axis1=0, axis2=1):
    d = torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)
    return torch.sum(d, dim=-1, dtype=None if d.is_floating_point() else torch.int64)


def bincount(x, weights=None, *, minlength=0):
    out = torch.bincount(x, weights=weights, minlength=minlength)
    return out if weights is None else out.to(weights.dtype)


def einsum(*operands, equation):
    return torch.einsum(equation, *operands)


def tensordot(x, y, *, axes=2):
    return torch.tensordot(x, y, dims=axes)


def cosine_similarity(x1, x2, *, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


def _symmetrized(x):
    """``(x + x^H) / 2``: jnp's cholesky and eigh read both triangles so (their
    ``symmetrize_input``), where LAPACK reads one, and their gradient is
    the symmetric one torch's backward gives."""
    return (x + x.mH) / 2


def cholesky(x, *, upper=False):
    L, info = torch.linalg.cholesky_ex(_symmetrized(x))
    # XLA's factor of a matrix that is not positive definite is NaN
    L = torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)
    return L.mH if upper else L


def inverse(x):
    return torch.linalg.inv_ex(x)[0]


def _svd(x, full_matrices=False):
    """``torch.linalg.svd``; on the card by cuSOLVER's ``gesvd`` (QR
    iteration, as LAPACK): torch's default Jacobi driver left a 4096-square
    f32 matrix's U S Vh 1e-3 from it and U, V 1e-3 from orthogonal, where
    ``gesvd`` gives 1e-5 (``chip_smoke.py`` phase 14c)."""
    if not x.is_cuda:
        return torch.linalg.svd(x, full_matrices=full_matrices)
    if x.shape[-2] < x.shape[-1]:  # gesvd takes m >= n
        u, s, vh = _svd(x.mH, full_matrices)
        return vh.mH, s, u.mH
    return torch.linalg.svd(x, full_matrices=full_matrices, driver="gesvd")


def _svdvals(x):
    if not x.is_cuda:
        return torch.linalg.svdvals(x)
    return torch.linalg.svdvals(x if x.shape[-2] >= x.shape[-1] else x.mH, driver="gesvd")


def pinv(x, *, rcond=1e-15, hermitian=False):
    if hermitian:
        return torch.linalg.pinv(x, rtol=rcond, hermitian=True)
    # jnp.linalg.pinv: singular values up to rcond times the largest dropped
    u, s, vh = _svd(x)
    s = torch.where(s > rcond * s.amax(-1, keepdim=True), s, torch.full_like(s, float("inf")))
    return vh.mH @ (u.mH / s[..., None])


def det(x):
    return torch.linalg.det(x)


def slogdet(x):
    sign, logabsdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logabsdet])


def matrix_rank(x, *, tol=None, hermitian=False):
    # jnp.linalg.matrix_rank counts the singular values above ``tol`` itself
    # when it is given, above eps * max(m, n) * the largest otherwise; it
    # reads no ``hermitian``
    s = _svdvals(x)
    if tol is None:
        tol = s.amax(-1, keepdim=True) * max(x.shape[-2:]) * torch.finfo(s.dtype).eps
    return (s > tol).sum(-1)


def matrix_power(x, *, n):
    return torch.linalg.matrix_power(x, n)


def qr(x, *, mode="reduced"):
    return tuple(torch.linalg.qr(x, mode=mode))


def svd(x, *, full_matrices=False):
    return tuple(_svd(x, full_matrices))


def eig(x):
    return tuple(torch.linalg.eig(x))


def eigh(x, *, UPLO="L"):
    return tuple(torch.linalg.eigh(_symmetrized(x), UPLO=UPLO))


def eigvals(x):
    return torch.linalg.eigvals(x)


def eigvalsh(x, *, UPLO="L"):
    return torch.linalg.eigvalsh(_symmetrized(x), UPLO=UPLO)


def _solve_columns(fn, b, vector):
    """``fn`` of a matrix right-hand side, for ``b`` a vector or matrices."""
    return fn(b.unsqueeze(-1)).squeeze(-1) if vector else fn(b)


def solve(x, y):
    x, y = operands(x, y)
    dt = torch.promote_types(inexact(x.dtype), inexact(y.dtype))
    x, y = x.to(dt), y.to(dt)
    # jnp's rule: a 1-D ``y`` is a vector, anything else a stack of matrices
    LU, piv, _ = torch.linalg.lu_factor_ex(x)
    return _solve_columns(lambda b: torch.linalg.lu_solve(LU, piv, b), y, y.dim() == 1)


def triangular_solve(x, y, *, upper=True, transpose=False, unitriangular=False):
    """``op(x) @ out = y`` for triangular ``x`` (``op`` the transpose when
    ``transpose``); ``y`` is a vector when it has one axis fewer than ``x``."""
    a = x.mT if transpose else x
    return _solve_columns(
        lambda b: torch.linalg.solve_triangular(a, b, upper=upper != transpose,
                                                unitriangular=unitriangular),
        y, x.dim() == y.dim() + 1)


def cholesky_solve(x, y, *, upper=False):
    """``A @ out = x`` with ``y`` the Cholesky factor of ``A`` (lower unless
    ``upper``): the JAX function's ``cho_solve((y, not upper), x)``."""
    return _solve_columns(lambda b: torch.cholesky_solve(b, y, upper=upper), x,
                          y.dim() == x.dim() + 1)


def lstsq(x, y, *, rcond=None):
    """The least-squares solution of ``x @ out = y`` by the SVD of ``x``, as
    ``jnp.linalg.lstsq``: ``(solution, residuals, rank, singular values)``,
    singular values under ``rcond`` times the largest dropped (rank-deficient
    inputs included), the squared residual norm of each column of ``y``."""
    dt = torch.promote_types(inexact(x.dtype), inexact(y.dtype))
    a, b = x.to(dt), y.to(dt)
    vector = b.dim() == 1
    if vector:
        b = b[:, None]
    m, n = a.shape
    if rcond is None:
        rcond = torch.finfo(dt).eps * max(n, m)
    elif rcond < 0:
        rcond = torch.finfo(dt).eps
    u, s, vh = _svd(a)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[:, None]
    sol = vh.mH @ (s_inv * (u.mH @ b))
    resid = torch.linalg.vector_norm(b - a @ sol, dim=0) ** 2
    return (sol.reshape(-1) if vector else sol), resid, rank, s


def lu(x):
    """The packed LU factors, LAPACK's 1-based pivots (sequential row swaps)
    and the factorisation's status (0 where it succeeded)."""
    return tuple(torch.linalg.lu_factor_ex(x))


def lu_unpack(lu_data, lu_pivots):
    """(P, L, U) with ``P @ L @ U`` the factored matrix, from 1-based pivots."""
    return tuple(torch.lu_unpack(lu_data, lu_pivots.to(torch.int32)))


def cov(x, *, rowvar=True, ddof=True):
    """``jnp.cov``'s arithmetic (``torch.cov`` reads a count back from the
    card): the centred rows' products over the observations less ``ddof``,
    squeezed (one variable gives a 0-d result)."""
    x = x.to(inexact(x.dtype))
    x = x.reshape(1, -1) if x.dim() < 2 else (x if rowvar else x.mT)
    xc = x - x.mean(dim=-1, keepdim=True)
    return ((xc @ xc.mH) / (x.shape[-1] - (1 if ddof else 0))).squeeze()


def corrcoef(x, *, rowvar=True):
    c = cov(x, rowvar=rowvar)
    if c.dim() == 0:
        return c / c
    std = torch.sqrt(torch.diagonal(c).real).to(c.dtype)
    c = c / std[:, None] / std[None, :]
    if c.is_complex():
        return torch.complex(c.real.clamp(-1, 1), c.imag.clamp(-1, 1))
    return c.clamp(-1, 1)


def multi_dot(*mats):
    return torch.linalg.multi_dot(list(mats))


def cond(x, *, p=None):
    if p in (None, 2, -2):  # the ratio of the extreme singular values
        s = _svdvals(x)
        return s[..., 0] / s[..., -1] if p != -2 else s[..., -1] / s[..., 0]
    return torch.linalg.cond(x, p=p)
