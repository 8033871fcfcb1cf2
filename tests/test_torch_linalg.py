"""``paddle.linalg`` of the port against the JAX package's, on the CPU: every
function of API.spec's ``paddle.linalg`` and the linalg Tensor methods, on
the same seeded numpy inputs (well-conditioned square, symmetric positive
definite, tall, rank-deficient and batched matrices).

Tolerance: float32 rtol 1e-4, atol 1e-4 times the largest magnitude of the
JAX result (LAPACK in torch and in XLA:CPU factor in other orders), unless
a case states its own. Eigenvectors, singular vectors and Q are compared
with their signs fixed (or, for ``eig``'s complex ones, by ``A V = V
diag(w)``); eigenvalues of ``eig`` sorted. Gradients where the JAX function
is differentiable, through ``backward`` of a weighted sum, at the same
tolerance.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


def _arrays():
    rng = np.random.default_rng(16)
    a = rng.standard_normal((5, 5)).astype(np.float32) + 4 * np.eye(5, dtype=np.float32)
    g = rng.standard_normal((5, 5)).astype(np.float32)
    spd = (g @ g.T + 5 * np.eye(5)).astype(np.float32)
    batch = rng.standard_normal((3, 4, 4)).astype(np.float32) + 3 * np.eye(4, dtype=np.float32)
    low = rng.standard_normal((6, 2)).astype(np.float32)
    return {
        "a": a, "spd": spd, "batch": batch,
        "b": rng.standard_normal((5, 2)).astype(np.float32),
        "v": rng.standard_normal(5).astype(np.float32),
        "bb": rng.standard_normal((3, 4, 2)).astype(np.float32),
        "tall": rng.standard_normal((6, 4)).astype(np.float32),
        "rankdef": (low @ rng.standard_normal((2, 4))).astype(np.float32),
        "y6": rng.standard_normal((6, 3)).astype(np.float32),
        "y6v": rng.standard_normal(6).astype(np.float32),
        "obs": rng.standard_normal((3, 7)).astype(np.float32),
        "triu": np.triu(a), "tril": np.tril(a),
        "ints": rng.integers(0, 10, 20),
        "flat": np.full(6, 2.0, np.float32),
        "x3": rng.standard_normal((4, 3)).astype(np.float32),
        "y3": rng.standard_normal((4, 3)).astype(np.float32),
        "cplx": (rng.standard_normal((3, 5)) + 1j * rng.standard_normal((3, 5))).astype(
            np.complex64),
    }


def _tensors(p, stop_gradient=True):
    return {k: p.to_tensor(v, stop_gradient=stop_gradient
                           or not np.issubdtype(v.dtype, np.floating))
            for k, v in _arrays().items()}


def _np(x):
    return None if x is None else np.asarray(x.numpy())


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale, 1.0), err_msg=what)


def _dtype_name(x):
    return str(x.dtype).rsplit(".", 1)[-1]


# (name, fn(p, t) -> Tensor or tuple of Tensors) compared output by output
VALUE_CASES = [
    ("cholesky", lambda p, t: p.linalg.cholesky(t["spd"])),
    ("cholesky_upper", lambda p, t: p.linalg.cholesky(t["spd"], upper=True)),
    ("inv", lambda p, t: p.linalg.inv(t["a"])),
    ("inverse_batch", lambda p, t: p.linalg.inverse(t["batch"])),
    ("pinv", lambda p, t: p.linalg.pinv(t["tall"])),
    ("pinv_hermitian", lambda p, t: p.linalg.pinv(t["spd"], hermitian=True)),
    ("det", lambda p, t: p.linalg.det(t["a"])),
    ("det_batch", lambda p, t: p.linalg.det(t["batch"])),
    ("slogdet", lambda p, t: p.linalg.slogdet(t["a"])),
    ("matrix_rank", lambda p, t: p.linalg.matrix_rank(t["a"])),
    ("matrix_rank_deficient", lambda p, t: p.linalg.matrix_rank(t["rankdef"])),
    ("matrix_rank_tol", lambda p, t: p.linalg.matrix_rank(t["spd"], tol=0.5)),
    ("matrix_power_3", lambda p, t: p.linalg.matrix_power(t["a"], 3)),
    ("matrix_power_neg", lambda p, t: p.linalg.matrix_power(t["a"], -2)),
    ("matrix_power_0", lambda p, t: p.linalg.matrix_power(t["batch"], 0)),
    ("solve", lambda p, t: p.linalg.solve(t["a"], t["b"])),
    ("solve_vector", lambda p, t: p.linalg.solve(t["a"], t["v"])),
    ("solve_batch", lambda p, t: p.linalg.solve(t["batch"], t["bb"])),
    ("triangular_solve", lambda p, t: p.linalg.triangular_solve(t["triu"], t["b"])),
    ("triangular_solve_lower", lambda p, t: p.linalg.triangular_solve(t["tril"], t["b"],
                                                                      upper=False)),
    ("triangular_solve_transpose", lambda p, t: p.linalg.triangular_solve(
        t["triu"], t["b"], transpose=True)),
    ("triangular_solve_unit", lambda p, t: p.linalg.triangular_solve(
        t["tril"], t["b"], upper=False, unitriangular=True)),
    ("triangular_solve_vector", lambda p, t: p.linalg.triangular_solve(t["triu"], t["v"])),
    ("cholesky_solve", lambda p, t: p.linalg.cholesky_solve(t["b"], p.linalg.cholesky(t["spd"]))),
    ("cholesky_solve_upper", lambda p, t: p.linalg.cholesky_solve(
        t["b"], p.linalg.cholesky(t["spd"], upper=True), upper=True)),
    ("lstsq", lambda p, t: p.linalg.lstsq(t["tall"], t["y6"])),
    ("lstsq_vector", lambda p, t: p.linalg.lstsq(t["tall"], t["y6v"])),
    ("lstsq_rank_deficient", lambda p, t: p.linalg.lstsq(t["rankdef"], t["y6"])),
    ("lstsq_rcond", lambda p, t: p.linalg.lstsq(t["tall"], t["y6"], rcond=0.5)),
    ("lu", lambda p, t: p.linalg.lu(t["a"])),
    ("lu_batch_infos", lambda p, t: p.linalg.lu(t["batch"], get_infos=True)),
    ("lu_unpack", lambda p, t: p.linalg.lu_unpack(*p.linalg.lu(t["a"]))),
    ("lu_unpack_batch", lambda p, t: p.linalg.lu_unpack(*p.linalg.lu(t["batch"]))),
    ("lu_unpack_tall", lambda p, t: p.linalg.lu_unpack(*p.linalg.lu(t["tall"]))),
    ("cond", lambda p, t: p.linalg.cond(t["a"])),
    ("cond_fro", lambda p, t: p.linalg.cond(t["a"], p="fro")),
    ("cond_inf", lambda p, t: p.linalg.cond(t["a"], p=np.inf)),
    ("cov", lambda p, t: p.linalg.cov(t["obs"])),
    ("cov_columns_biased", lambda p, t: p.linalg.cov(t["obs"], rowvar=False, ddof=False)),
    ("corrcoef", lambda p, t: p.linalg.corrcoef(t["obs"])),
    ("corrcoef_columns", lambda p, t: p.linalg.corrcoef(t["obs"], rowvar=False)),
    ("cov_vector", lambda p, t: p.linalg.cov(t["v"])),
    ("corrcoef_vector", lambda p, t: p.linalg.corrcoef(t["v"])),
    ("corrcoef_complex", lambda p, t: p.linalg.corrcoef(t["cplx"])),
    ("histogram", lambda p, t: p.linalg.histogram(t["a"], bins=7)),
    ("histogram_range", lambda p, t: p.linalg.histogram(t["a"], bins=4, min=-1, max=2)),
    ("histogram_flat", lambda p, t: p.linalg.histogram(t["flat"], bins=3)),
    ("histogram_ints", lambda p, t: p.linalg.histogram(t["ints"], bins=5)),
    ("multi_dot", lambda p, t: p.linalg.multi_dot([t["a"], t["spd"], t["b"]])),
    ("multi_dot_vectors", lambda p, t: p.linalg.multi_dot([t["v"], t["a"], t["v"]])),
    ("eigvalsh", lambda p, t: p.linalg.eigvalsh(t["spd"])),
    ("eigvalsh_upper", lambda p, t: p.linalg.eigvalsh(t["spd"], UPLO="U")),
    ("svd_values", lambda p, t: p.linalg.svd(t["tall"])[1]),
    ("eigh_values", lambda p, t: p.linalg.eigh(t["spd"])[0]),
    ("qr_r_abs", lambda p, t: p.abs(p.linalg.qr(t["tall"])[1])),
    ("matmul", lambda p, t: p.linalg.matmul(t["a"], t["b"], transpose_x=True)),
    ("mm", lambda p, t: p.linalg.mm(t["a"], t["spd"])),
    ("bmm", lambda p, t: p.linalg.bmm(t["batch"], t["bb"])),
    ("mv", lambda p, t: p.linalg.mv(t["a"], t["v"])),
    ("dot", lambda p, t: p.linalg.dot(t["x3"], t["y3"])),
    ("norm", lambda p, t: p.linalg.norm(t["a"], p=1, axis=0)),
    ("dist", lambda p, t: p.linalg.dist(t["x3"], t["y3"], p=3.0)),
    ("cross", lambda p, t: p.linalg.cross(t["x3"], t["y3"])),
    ("t", lambda p, t: p.linalg.t(t["tall"])),
    ("trace", lambda p, t: p.linalg.trace(t["batch"], axis1=1, axis2=2)),
]


@pytest.mark.parametrize("name,fn", VALUE_CASES, ids=[c[0] for c in VALUE_CASES])
def test_linalg_function_matches_jax(name, fn):
    outs = {}
    for p in (jp, tp):
        out = fn(p, _tensors(p))
        outs[p] = list(out) if isinstance(out, (tuple, list)) else [out]
    assert len(outs[jp]) == len(outs[tp])
    for i, (a, b) in enumerate(zip(outs[jp], outs[tp])):
        if a is None:
            assert b is None
            continue
        assert _dtype_name(a) == _dtype_name(b), (name, i, a.dtype, b.dtype)
        _close(_np(b), _np(a), what=f"{name}[{i}]")


def _fix_columns(m):
    """Each column's sign chosen so its largest-magnitude entry is positive."""
    idx = np.abs(m).argmax(axis=-2)
    sign = np.sign(np.take_along_axis(m, idx[..., None, :], axis=-2))
    return m * sign


@pytest.mark.parametrize("which", ["reduced", "complete"])
def test_qr_by_reconstruction_and_fixed_signs(which):
    got = {}
    for p in (jp, tp):
        t = _tensors(p)
        q, r = p.linalg.qr(t["tall"], mode=which)
        q, r = _np(q), _np(r)
        _close(q @ r, _arrays()["tall"], what="QR = A")
        _close(q.T @ q, np.eye(q.shape[1]), what="Q orthogonal")
        s = np.sign(np.diag(r[: min(r.shape), :]))
        got[p] = (q[:, : len(s)] * s, r[: len(s)] * s[:, None])
    for a, b in zip(got[jp], got[tp]):
        _close(b, a, what="Q, R with diag(R) > 0")


def test_svd_and_eigh_vectors_with_fixed_signs():
    arrays = _arrays()
    got = {}
    for p in (jp, tp):
        t = _tensors(p)
        u, s, vh = (_np(x) for x in p.linalg.svd(t["tall"]))
        _close((u * s) @ vh, arrays["tall"], what="U S Vh = A")
        w, v = (_np(x) for x in p.linalg.eigh(t["spd"]))
        _close((v * w) @ v.T, arrays["spd"], what="V W V^T = A")
        ub, sb, vhb = (_np(x) for x in p.linalg.svd(t["batch"], full_matrices=True))
        _close(np.einsum("bij,bj,bjk->bik", ub, sb, vhb), arrays["batch"], what="batched")
        got[p] = (_fix_columns(u), _fix_columns(vh.T), _fix_columns(v))
    for a, b in zip(got[jp], got[tp]):
        _close(b, a, what="vectors")


def test_eig_and_eigvals_complex():
    a = _arrays()["a"]
    got = {}
    for p in (jp, tp):
        t = _tensors(p)
        w, v = (_np(x) for x in p.linalg.eig(t["a"]))
        assert w.dtype == np.complex64 and v.dtype == np.complex64
        _close(a.astype(np.complex64) @ v, v * w, what="A V = V diag(w)")
        got[p] = (np.sort_complex(w), np.sort_complex(_np(p.linalg.eigvals(t["a"]))))
    for x, y in zip(got[jp], got[tp]):
        _close(y, x, what="eigenvalues")


def test_lu_pivots_are_one_based_and_unpack_rebuilds():
    """The JAX wrapper adds 1 to XLA's 0-based pivots; ``torch.linalg`` is
    already 1-based, so the port's pivots equal the JAX package's as they
    are, and ``P @ L @ U`` gives the matrix back."""
    a = _arrays()["a"]
    pivots = {}
    for p in (jp, tp):
        lu, piv = p.linalg.lu(_tensors(p)["a"])
        piv = _np(piv)
        assert piv.min() >= 1 and piv.max() <= 5 and _dtype_name(p.to_tensor(piv)) == "int32"
        P, L, U = (_np(x) for x in p.linalg.lu_unpack(lu, p.to_tensor(piv)))
        _close(P @ L @ U, a, what="P L U = A")
        assert p.linalg.lu_unpack(lu, p.to_tensor(piv), unpack_pivots=False)[0] is None
        assert p.linalg.lu_unpack(lu, p.to_tensor(piv), unpack_ludata=False)[1:] == (None, None)
        pivots[p] = piv
    np.testing.assert_array_equal(pivots[tp], pivots[jp])


def test_rank_deficient_lstsq_solution_is_the_minimum_norm_one():
    arrays = _arrays()
    sol, res, rank, sv = tp.linalg.lstsq(tp.to_tensor(arrays["rankdef"]),
                                         tp.to_tensor(arrays["y6"]))
    assert int(rank) == 2 and sv.shape == [4]
    # the float32 rounding leaves two singular values ~1e-7 of the largest:
    # numpy's pseudo-inverse drops them at the same relative cut
    want = np.linalg.pinv(arrays["rankdef"].astype(np.float64), rcond=1e-5) @ arrays["y6"]
    _close(_np(sol), want, rtol=1e-3, what="pinv(A) y")
    _close(_np(res), ((arrays["rankdef"] @ _np(sol) - arrays["y6"]) ** 2).sum(0),
           rtol=1e-3, what="residuals")


def test_cholesky_of_an_indefinite_matrix_is_nan_as_in_xla():
    bad = -np.eye(3, dtype=np.float32)
    for p in (jp, tp):
        assert np.isnan(_np(p.linalg.cholesky(p.to_tensor(bad)))).any()


# (name, fn(p, t) -> Tensor, input names that receive a gradient)
GRAD_CASES = [
    ("cholesky", lambda p, t: p.linalg.cholesky(t["spd"]), ["spd"]),
    ("inv", lambda p, t: p.linalg.inv(t["a"]), ["a"]),
    ("det", lambda p, t: p.linalg.det(t["a"]), ["a"]),
    ("slogdet", lambda p, t: p.linalg.slogdet(t["a"]), ["a"]),
    ("solve", lambda p, t: p.linalg.solve(t["a"], t["b"]), ["a", "b"]),
    ("triangular_solve", lambda p, t: p.linalg.triangular_solve(t["triu"], t["b"]), ["b"]),
    ("cholesky_solve", lambda p, t: p.linalg.cholesky_solve(t["b"], p.linalg.cholesky(t["spd"])),
     ["b"]),
    ("matrix_power", lambda p, t: p.linalg.matrix_power(t["a"], 3), ["a"]),
    ("pinv", lambda p, t: p.linalg.pinv(t["tall"]), ["tall"]),
    ("eigvalsh", lambda p, t: p.linalg.eigvalsh(t["spd"]), ["spd"]),
    ("svd_values", lambda p, t: p.linalg.svd(t["tall"])[1], ["tall"]),
    ("qr_r", lambda p, t: p.abs(p.linalg.qr(t["tall"])[1]), ["tall"]),
    ("cov", lambda p, t: p.linalg.cov(t["obs"]), ["obs"]),
    ("corrcoef", lambda p, t: p.linalg.corrcoef(t["obs"]), ["obs"]),
    ("multi_dot", lambda p, t: p.linalg.multi_dot([t["a"], t["spd"], t["b"]]), ["a", "spd", "b"]),
]


@pytest.mark.parametrize("name,fn,wrt", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_linalg_gradient_matches_jax(name, fn, wrt):
    grads = {}
    for p in (jp, tp):
        t = _tensors(p, stop_gradient=False)
        out = fn(p, t)
        weights = np.linspace(0.5, 1.5, int(np.prod(out.shape) or 1)).astype(np.float32)
        (out * p.to_tensor(weights.reshape(out.shape))).sum().backward()
        grads[p] = [_np(t[k].grad) for k in wrt]
    for k, a, b in zip(wrt, grads[jp], grads[tp]):
        _close(b, a, rtol=1e-3, what=f"d{name}/d{k}")


# Tensor method -> (paddle.linalg function, argument names)
METHODS = {
    "cholesky": ("cholesky", ["spd"]), "cholesky_solve": ("cholesky_solve", ["b", "spd"]),
    "cond": ("cond", ["a"]), "cov": ("cov", ["obs"]), "eigvalsh": ("eigvalsh", ["spd"]),
    "inverse": ("inv", ["a"]), "lstsq": ("lstsq", ["tall", "y6"]), "lu": ("lu", ["a"]),
    "matrix_power": ("matrix_power", ["a"]), "qr": ("qr", ["tall"]),
    "solve": ("solve", ["a", "b"]), "triangular_solve": ("triangular_solve", ["triu", "b"]),
    "eig": ("eig", ["a"]), "eigvals": ("eigvals", ["a"]),
    "multi_dot": ("multi_dot", []), "lu_unpack": ("lu_unpack", []),
}


@pytest.mark.parametrize("method", sorted(METHODS))
def test_linalg_tensor_methods_are_bound_as_in_jax(method):
    target, names = METHODS[method]
    for p in (jp, tp):
        assert getattr(p.Tensor, method) is getattr(p.linalg, target)
    if not names:
        return
    extra = {"matrix_power": (2,)}.get(method, ())
    t = _tensors(tp)
    args = [t[n] for n in names]
    if method == "cholesky_solve":
        args[1] = tp.linalg.cholesky(args[1])
    got = getattr(args[0], method)(*args[1:], *extra)
    want = getattr(tp.linalg, target)(*args, *extra)
    for a, b in zip(want if isinstance(want, tuple) else [want],
                    got if isinstance(got, tuple) else [got]):
        np.testing.assert_array_equal(_np(b), _np(a))


def test_linalg_namespace_holds_every_api_spec_name():
    import pathlib

    spec = (pathlib.Path(__file__).resolve().parent.parent / "API.spec").read_text()
    names = [line.split(" ", 1)[0].rsplit(".", 1)[1] for line in spec.splitlines()
             if line.startswith("paddle.linalg.")]
    assert len(names) == 37
    assert [n for n in names if not hasattr(tp.linalg, n)] == []
    # the reference's apply signature: op_name= before differentiable=
    assert tp.linalg.apply(lambda v: v * 2, tp.to_tensor([1.0]), op_name="scale").numpy() == [2.0]
