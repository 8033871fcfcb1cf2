"""The port's ``paddle.*`` tensor functions and ``Tensor`` methods against the
JAX package's, on the CPU.

Every case takes the same inputs, made from a seed with numpy, through
``paddle_tpu.X`` and ``paddle_tpu_torch.X`` and compares each output's
values, dtype, shape and ``stop_gradient``; where the function is
differentiable, the gradients of ``sum(out * w)`` (``w`` from the seed) with
respect to every float input too. The method cases call each name of the
JAX package's method list (``paddle_tpu/tensor_api.py:978``) on the first
input, with the function case's other arguments.

Tolerances: integers, bools and indices exact; float32 rtol 1e-5 / atol 1e-6
(XLA:CPU and ATen differ by ulps in transcendental functions and in the
order of sums); float64 1e-12; a few special functions whose two
implementations use different series (named in ``LOOSE``) 1e-4. The random
ops cannot match values (jax keys against torch generators): they are held
to shape, dtype, range and moments, and to reproducibility under
``paddle.seed``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from tests import torch_surface_cases as surface_cases


@pytest.fixture(autouse=True)
def _cpu():
    previous = tp.get_device()
    tp.set_device("cpu")
    yield
    tp.set_device(previous)


def _inputs(specs, seed, mod, trainable):
    arrays = surface_cases.inputs(surface_cases.SMALL, seed)
    return [mod.to_tensor(arrays[s], stop_gradient=not (trainable and arrays[s].dtype.kind == "f"))
            for s in specs]


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _tol(dtype_name, loose):
    if loose:
        return dict(rtol=1e-4, atol=1e-5)
    if dtype_name in ("float64", "complex128"):
        return dict(rtol=1e-12, atol=1e-12)
    if dtype_name in ("float32", "complex64"):
        return dict(rtol=1e-5, atol=1e-6)
    if dtype_name in ("float16", "bfloat16"):
        return dict(rtol=1e-2, atol=1e-3)
    return None  # exact


def assert_same(jt, tt, what, loose=False):
    assert isinstance(tt, tp.Tensor), (what, type(tt))
    assert tt.dtype.name == jt.dtype.name, (what, tt.dtype, jt.dtype)
    assert tt.shape == jt.shape, (what, tt.shape, jt.shape)
    assert tt.stop_gradient == jt.stop_gradient, (what, tt.stop_gradient, jt.stop_gradient)
    a, b = np.asarray(jt.numpy()), np.asarray(tt.numpy())
    tol = _tol(jt.dtype.name, loose)
    if tol is None:
        np.testing.assert_array_equal(b, a, err_msg=what)
    else:
        np.testing.assert_allclose(b.astype(a.dtype), a, equal_nan=True, err_msg=what, **tol)


# (name, function of (module, *inputs), input names, differentiable, the
# card sweep's tolerance kind), shared with chip_smoke.py's card sweep
CASES = surface_cases.CASES

LOOSE = {"i0", "i0e", "i1", "i1e", "lgamma", "digamma", "polygamma", "erfinv", "erfinv_",
         "logcumsumexp"}

_by_name = {c[0]: c for c in CASES}
assert len(_by_name) == len(CASES), "duplicate case names"


@pytest.mark.parametrize("name", sorted(_by_name))
def test_function_matches_jax(name):
    _, fn, specs, diff, _ = _by_name[name]
    outs = {}
    grads = {}
    for mod in (jp, tp):
        xs = _inputs(specs, 7, mod, diff)
        out = fn(mod, *xs)
        outs[mod] = _flat(out)
        if diff:
            floats = [o for o in outs[mod] if o.dtype.name in ("float32", "float64")
                      and not o.stop_gradient]
            rng = np.random.default_rng(11)
            loss = None
            for o in floats:
                w = mod.to_tensor(rng.standard_normal(o.shape).astype(o.dtype.name))
                term = (o * w).sum()
                loss = term if loss is None else loss + term
            wrt = [x for x in xs if not x.stop_gradient]
            grads[mod] = mod.grad([loss], wrt, allow_unused=True) if loss is not None else []
    loose = name in LOOSE
    assert len(outs[tp]) == len(outs[jp]), name
    for i, (jt, tt) in enumerate(zip(outs[jp], outs[tp])):
        assert_same(jt, tt, f"{name} output {i}", loose)
    if diff:
        assert len(grads[tp]) == len(grads[jp])
        for i, (jg, tg) in enumerate(zip(grads[jp], grads[tp])):
            # an input the output does not depend on: the JAX engine gives
            # zeros where it was an op's input, torch None
            if jg is None or tg is None:
                rest = tg if jg is None else jg
                assert rest is None or not rest.numpy().any(), f"{name} grad {i}"
            else:
                assert_same(jg, tg, f"{name} grad {i}", loose)


# the JAX package's Tensor method list, by the function case that calls it
METHOD_CASES = {
    "add": "add", "subtract": "subtract", "multiply": "multiply", "divide": "divide",
    "floor_divide": "floor_divide", "remainder": "remainder", "mod": "mod", "pow": "pow",
    "maximum": "maximum", "minimum": "minimum", "fmax": "fmax", "fmin": "fmin",
    "nan_to_num": "nan_to_num", "logit": "logit", "scale": "scale", "clip": "clip",
    "lerp": "lerp", "cumsum": "cumsum", "cumprod": "cumprod", "cummax": "cummax",
    "cummin": "cummin", "logcumsumexp": "logcumsumexp", "diff": "diff", "take": "take",
    "addmm": "addmm", "inner": "inner", "outer": "outer", "kron": "kron",
    "std": "std_axis", "var": "var", "quantile": "quantile",
    "equal_all": "equal_all", "allclose": "allclose", "isclose": "isclose",
    "reshape": "reshape", "reshape_": "reshape_", "transpose": "transpose",
    "squeeze": "squeeze_axis", "unsqueeze": "unsqueeze", "flatten": "flatten", "tile": "tile",
    "expand": "expand", "expand_as": "expand_as", "broadcast_to": "broadcast_to",
    "flip": "flip", "roll": "roll", "gather": "gather", "gather_nd": "gather_nd",
    "scatter": "scatter", "scatter_": "scatter_", "scatter_nd_add": "scatter_nd_add",
    "put_along_axis": "put_along_axis", "take_along_axis": "take_along_axis",
    "index_select": "index_select", "index_sample": "index_sample",
    "index_add": "index_add", "masked_select": "masked_select",
    "masked_fill": "masked_fill", "tril": "tril", "triu": "triu", "diagonal": "diagonal",
    "repeat_interleave": "repeat_interleave", "moveaxis": "moveaxis", "unfold": "unfold",
    "split": "split", "chunk": "chunk", "unstack": "unstack", "as_real": "as_real",
    "as_complex": "as_complex", "rot90": "rot90", "numel": "numel", "argmax": "argmax_axis",
    "argmin": "argmin", "argsort": "argsort", "sort": "sort", "topk": "topk",
    "kthvalue": "kthvalue", "mode": "mode", "nonzero": "nonzero",
    "searchsorted": "searchsorted", "bucketize": "bucketize", "unique": "unique_all",
    "unique_consecutive": "unique_consecutive", "histogram": "histogram",
    "bincount": "bincount", "matmul": "matmul", "dot": "dot", "mm": "mm", "bmm": "bmm",
    "mv": "mv", "t": "t", "norm": "norm_axis", "dist": "dist", "cross": "cross",
    "trace": "trace", "tensordot": "tensordot",
}
for _n in ("abs", "neg", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
           "square", "reciprocal", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
           "tanh", "asinh", "acosh", "atanh", "ceil", "floor", "round", "trunc", "frac",
           "sign", "erf", "erfinv", "lgamma", "digamma", "isnan", "isinf", "isfinite", "conj",
           "real", "imag", "angle", "rad2deg", "deg2rad", "equal", "not_equal",
           "greater_than", "greater_equal", "less_than", "less_equal", "logical_and",
           "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not"):
    METHOD_CASES[_n] = _n
for _n in ("sum", "mean", "max", "min", "amax", "amin", "prod", "logsumexp", "all", "any",
           "median", "nanmedian", "nansum", "nanmean", "count_nonzero"):
    METHOD_CASES[_n] = f"{_n}_keep"
METHOD_CASES["where"] = None  # x.where(...) takes x as the condition: its own case below


@pytest.mark.parametrize("method", sorted(n for n, c in METHOD_CASES.items() if c))
def test_method_matches_function(method):
    """``x.<method>(*rest)`` of the port equals ``paddle.<method>(x, *rest)``
    of the JAX package, on the function case's inputs."""
    _, fn, specs, _, _ = _by_name[METHOD_CASES[method]]
    results = {}
    for mod in (jp, tp):
        xs = _inputs(specs, 7, mod, False)
        # route the module function through the method of its first argument
        proxy = _MethodProxy(mod, method, xs[0]) if mod is tp else mod
        results[mod] = _flat(fn(proxy, *xs))
    for i, (jt, tt) in enumerate(zip(results[jp], results[tp])):
        assert_same(jt, tt, f"{method} output {i}", method in LOOSE)


class _MethodProxy:
    """The port's module, except that ``proxy.<method>(x, ...)`` calls
    ``x.<method>(...)`` on the case's first input."""

    def __init__(self, mod, method, first):
        self._mod, self._method, self._first = mod, method, first

    def __getattr__(self, name):
        if name != self._method:
            return getattr(self._mod, name)

        def call(x, *args, **kwargs):
            assert x is self._first, "the method case must take its first input first"
            return getattr(x, name)(*args, **kwargs)

        return call


def test_where_method_takes_the_condition():
    rng = np.random.default_rng(3)
    c, x, y = rng.random((3, 4)) > 0.5, rng.standard_normal((3, 4)), rng.standard_normal((3, 4))
    out = {mod: mod.to_tensor(c).where(mod.to_tensor(x), mod.to_tensor(y)) for mod in (jp, tp)}
    assert_same(out[jp], out[tp], "where method")


DUNDERS = [
    ("__add__", "f", 1.5), ("__radd__", "f", 1.5), ("__sub__", "f", "g"), ("__rsub__", "f", 2.0),
    ("__mul__", "f", "g"), ("__rmul__", "i", 3), ("__truediv__", "f", "p"),
    ("__rtruediv__", "p", 2.0), ("__floordiv__", "i", "ipos"), ("__rfloordiv__", "ipos", 7),
    ("__mod__", "i", "ipos"), ("__rmod__", "ipos", 7), ("__pow__", "p", 2.0),
    ("__rpow__", "f", 2.0), ("__matmul__", "m", "m"), ("__rmatmul__", "m", "m"),
    ("__eq__", "ties", "ties"), ("__ne__", "f", "g"), ("__lt__", "f", "g"),
    ("__le__", "f", 0.0), ("__gt__", "f", "g"), ("__ge__", "i", 1), ("__and__", "b", "c"),
    ("__or__", "i", "ipos"), ("__xor__", "b", "c"), ("__and__", "i", "ipos"),
    ("__rsub__", "i32", 2.5), ("__rtruediv__", "i32", 2),
]


@pytest.mark.parametrize("dunder,spec,other", DUNDERS,
                         ids=[f"{d}-{s}-{o}" for d, s, o in DUNDERS])
def test_dunder_matches_jax(dunder, spec, other):
    outs = {}
    for mod in (jp, tp):
        x, *rest = _inputs([spec] + ([other] if isinstance(other, str) else []), 5, mod, False)
        o = rest[0] if rest else other
        outs[mod] = getattr(x, dunder)(o)
    assert_same(outs[jp], outs[tp], dunder)


@pytest.mark.parametrize("dunder", ["__neg__", "__abs__", "__invert__"])
def test_unary_dunder_matches_jax(dunder):
    spec = "b" if dunder == "__invert__" else "f"
    outs = {mod: getattr(_inputs([spec], 5, mod, False)[0], dunder)() for mod in (jp, tp)}
    assert_same(outs[jp], outs[tp], dunder)


def test_dunders_take_torch_tensors_and_python_scalars():
    x = tp.to_tensor([1.0, 2.0])
    assert (x + torch.ones(2)).tolist() == [2.0, 3.0]
    assert (3 - x).tolist() == [2.0, 1.0]
    assert tp.matmul(x, torch.ones(2, 1)).shape == [1]


# ---------------------------------------------------------------------------
# random ops: shape, dtype, range, moments, reproducibility under paddle.seed
# ---------------------------------------------------------------------------
RANDOM = [
    ("rand", lambda p: p.rand([4000]), "float32", (0.0, 1.0), 0.5, 1 / 12 ** 0.5),
    ("randn", lambda p: p.randn([4000]), "float32", None, 0.0, 1.0),
    ("standard_normal", lambda p: p.standard_normal([4000], "float64"), "float64", None,
     0.0, 1.0),
    ("uniform", lambda p: p.uniform([4000], min=2.0, max=4.0), "float32", (2.0, 4.0), 3.0,
     2 / 12 ** 0.5),
    ("normal", lambda p: p.normal(1.0, 2.0, [4000]), "float32", None, 1.0, 2.0),
    ("randint", lambda p: p.randint(0, 10, [4000]), "int64", (0, 9), 4.5, 8.25 ** 0.5),
    ("randint_like", lambda p: p.randint_like(p.zeros([4000], "int32"), 0, 4), "int32",
     (0, 3), 1.5, 1.25 ** 0.5),
    ("randperm", lambda p: p.randperm(4000), "int64", (0, 3999), 1999.5, None),
    ("bernoulli", lambda p: p.bernoulli(p.full([4000], 0.3)), "float32", (0.0, 1.0), 0.3,
     0.21 ** 0.5),
    ("poisson", lambda p: p.poisson(p.full([4000], 3.0)), "float32", (0.0, None), 3.0,
     3.0 ** 0.5),
    ("multinomial", lambda p: p.multinomial(p.to_tensor([0.1, 0.2, 0.7]), 4000, True),
     "int64", (0, 2), 1.6, 0.44 ** 0.5),
    ("exponential_", lambda p: p.zeros([4000]).exponential_(2.0), "float32", (0.0, None),
     0.5, 0.5),
    ("uniform_", lambda p: p.zeros([4000]).uniform_(-1.0, 1.0), "float32", (-1.0, 1.0), 0.0,
     1 / 3 ** 0.5),
    ("normal_", lambda p: p.zeros([4000]).normal_(0.5, 0.1), "float32", None, 0.5, 0.1),
]


@pytest.mark.parametrize("name", [r[0] for r in RANDOM])
def test_random_op_shape_dtype_range_moments(name):
    _, fn, dtype, rng_range, mean, std = next(r for r in RANDOM if r[0] == name)
    outs = {mod: fn(mod) for mod in (jp, tp)}
    for mod, out in outs.items():
        assert out.shape == [4000] and out.dtype.name == dtype, (mod.__name__, out)
        v = out.numpy().astype(np.float64)
        if rng_range is not None:
            lo, hi = rng_range
            assert v.min() >= lo and (hi is None or v.max() <= hi)
        # 4000 draws: the mean within 5 standard errors, the std within 10%
        sigma = std if std is not None else v.std()
        assert abs(v.mean() - mean) < 5 * sigma / 4000 ** 0.5 + 1e-9, (mod.__name__, v.mean())
        if std is not None:
            assert abs(v.std() - std) < 0.1 * std
    assert outs[tp].stop_gradient
    tp.seed(3)
    first = fn(tp).numpy()
    tp.seed(3)
    np.testing.assert_array_equal(fn(tp).numpy(), first)
    assert not np.array_equal(fn(tp).numpy(), first)


def test_randperm_is_a_permutation():
    assert sorted(tp.randperm(50).tolist()) == list(range(50))
    assert sorted(tp.multinomial(tp.to_tensor([0.2, 0.3, 0.5]), 3).tolist()) == [0, 1, 2]


def test_card_sweep_covers_every_function_of_this_sweep():
    """chip_smoke.py phase 11b runs this sweep's case table on the card at
    the 345M's widths, against the port on the CPU: every tolerance kind a
    case names is stated there, and no other."""
    import inspect

    import chip_smoke

    assert "surface_cases.CASES" in inspect.getsource(chip_smoke.surface_sweep)
    kinds = {k for c in CASES for k in c[4].split("/")}
    assert set(chip_smoke.SURFACE_TOL) == kinds
    assert {s for c in CASES for s in c[2]} <= set(
        surface_cases.inputs(surface_cases.SMALL, 0))
