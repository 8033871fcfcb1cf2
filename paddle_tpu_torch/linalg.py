"""``paddle.linalg`` of the port: the wrappers of ``paddle_tpu/linalg.py``
over ``ops/linalg.py`` (``torch.linalg`` on the card).

Every function takes Paddle Tensors (or torch tensors) and returns Tensors.
The decompositions without a usable derivative in the JAX package (``eig``,
``eigvals``, ``lstsq``, ``lu``, ``lu_unpack``, ``matrix_rank``, ``cond``,
``histogram``) run without recording, as there. ``lu`` returns LAPACK's
1-based pivots, which ``torch.linalg.lu_factor`` already gives (the JAX
wrapper adds 1 to XLA's 0-based ones); its ``get_infos`` tensor is the
factorisation's own status (0 where it succeeded, as the JAX package's
zeros say).
"""
from __future__ import annotations

from .core.dispatch import apply
from .ops import linalg as _la
from .tensor_api import (  # noqa: F401
    bmm,
    cross,
    dist,
    dot,
    histogram,
    matmul,
    mm,
    mv,
    norm,
    t,
    trace,
)


def cholesky(x, upper=False, name=None):
    return apply(_la.cholesky, x, upper=upper)


def inv(x, name=None):
    return apply(_la.inverse, x, op_name="inverse")


inverse = inv


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply(_la.pinv, x, rcond=rcond, hermitian=hermitian)


def det(x, name=None):
    return apply(_la.det, x)


def slogdet(x, name=None):
    return apply(_la.slogdet, x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return apply(_la.matrix_rank, x, tol=tol, hermitian=hermitian, differentiable=False)


def matrix_power(x, n, name=None):
    return apply(_la.matrix_power, x, n=int(n))


def qr(x, mode="reduced", name=None):
    out = apply(_la.qr, x, mode=mode)
    return out[0], out[1]


def svd(x, full_matrices=False, name=None):
    out = apply(_la.svd, x, full_matrices=full_matrices)
    return out[0], out[1], out[2]


def eig(x, name=None):
    out = apply(_la.eig, x, differentiable=False)
    return out[0], out[1]


def eigh(x, UPLO="L", name=None):
    out = apply(_la.eigh, x, UPLO=UPLO)
    return out[0], out[1]


def eigvals(x, name=None):
    return apply(_la.eigvals, x, differentiable=False)


def eigvalsh(x, UPLO="L", name=None):
    return apply(_la.eigvalsh, x, UPLO=UPLO)


def solve(x, y, name=None):
    return apply(_la.solve, x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False, name=None):
    return apply(_la.triangular_solve, x, y, upper=upper, transpose=transpose,
                 unitriangular=unitriangular)


def cholesky_solve(x, y, upper=False, name=None):
    return apply(_la.cholesky_solve, x, y, upper=upper)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular values)`` by SVD whatever the
    ``driver`` (as in the JAX package)."""
    return tuple(apply(_la.lstsq, x, y, rcond=rcond, differentiable=False))


def lu(x, pivot=True, get_infos=False, name=None):
    """LU factorization; pivots are 1-based sequential row swaps (reference:
    tensor/linalg.py lu — LAPACK getrf convention)."""
    out = apply(_la.lu, x, differentiable=False)
    return (out[0], out[1], out[2]) if get_infos else (out[0], out[1])


def multi_dot(x, name=None):
    return apply(_la.multi_dot, *x)


def cond(x, p=None, name=None):
    return apply(_la.cond, x, p=p, differentiable=False)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply(_la.cov, x, rowvar=rowvar, ddof=ddof)


def corrcoef(x, rowvar=True, name=None):
    return apply(_la.corrcoef, x, rowvar=rowvar)


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` of a packed LU factorization and its 1-based pivots, with
    ``P @ L @ U`` the factored matrix (reference: tensor/linalg.py
    lu_unpack); an output not asked for is None."""
    P, L, U = apply(_la.lu_unpack, lu_data, lu_pivots, differentiable=False)
    if not unpack_pivots:
        P = None
    if not unpack_ludata:
        L = U = None
    return P, L, U
