"""Elementwise and scalar math on torch tensors: ``paddle_tpu/ops/math.py``'s
functions, names and keywords.

The JAX package runs with 64-bit types on, and its dtypes follow jnp's
promotion, which these functions keep where torch's differs:

- a Python float against an integer or bool tensor computes in float64
  (torch would take float32), and a Python scalar never widens a tensor of
  its own kind;
- a 0-d tensor widens a tensor of the same kind (torch lets the tensor with
  dimensions decide);
- true division and the transcendental functions compute an integer or bool
  input in float64 for int64 and float32 otherwise (``dtype.inexact``).
"""
from __future__ import annotations

import torch

from ..core.dtype import inexact


def _is_inexact(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def operands(x, y):
    """``x`` and ``y`` cast so torch's promotion gives jnp's result dtype."""
    xt, yt = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
    if xt and yt:
        if x.dtype != y.dtype and (x.dim() == 0) != (y.dim() == 0):
            dt = torch.promote_types(x.dtype, y.dtype)
            return x.to(dt), y.to(dt)
        return x, y
    if xt and isinstance(y, float) and not _is_inexact(x):
        return x.to(torch.float64), y
    if yt and isinstance(x, float) and not _is_inexact(y):
        return x, y.to(torch.float64)
    return x, y


def tensor_operands(x, y):
    """``operands``, with a Python scalar made a 0-d tensor beside the other
    (for the torch functions that take no scalar)."""
    x, y = operands(x, y)
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=_scalar_dtype(x, y), device=y.device)
    elif not isinstance(y, torch.Tensor):
        y = torch.tensor(y, dtype=_scalar_dtype(y, x), device=x.device)
    return x, y


def _scalar_dtype(s, t: torch.Tensor) -> torch.dtype:
    if isinstance(s, bool) or (isinstance(s, int) and t.dtype != torch.bool) or (
            isinstance(s, float) and _is_inexact(t)):
        return t.dtype
    return torch.int64 if isinstance(s, int) else torch.float64


def to_inexact(x: torch.Tensor) -> torch.Tensor:
    return x if _is_inexact(x) else x.to(inexact(x.dtype))


def _unary_float(fn):
    def op(x):
        return fn(to_inexact(x))

    op.__name__ = fn.__name__
    return op


# ---- binary elementwise (numpy broadcasting) ----
def add(x, y):
    return torch.add(*operands(x, y))


def subtract(x, y):
    return torch.subtract(*operands(x, y))


def multiply(x, y):
    return torch.multiply(*operands(x, y))


def divide(x, y):
    x, y = tensor_operands(x, y)
    dt = inexact(torch.promote_types(x.dtype, y.dtype))
    return torch.true_divide(x.to(dt), y.to(dt))


def floor_divide(x, y):
    return torch.floor_divide(*operands(x, y))


def remainder(x, y):
    return torch.remainder(*operands(x, y))


def pow(x, y):
    return torch.pow(*operands(x, y))


def _binary_tensors(fn):
    def op(x, y):
        return fn(*tensor_operands(x, y))

    op.__name__ = fn.__name__
    return op


maximum = _binary_tensors(torch.maximum)
minimum = _binary_tensors(torch.minimum)
fmax = _binary_tensors(torch.fmax)
fmin = _binary_tensors(torch.fmin)
gcd = _binary_tensors(torch.gcd)
lcm = _binary_tensors(torch.lcm)


def _float_pair(x, y):
    x, y = tensor_operands(x, y)
    dt = inexact(torch.promote_types(x.dtype, y.dtype))
    return x.to(dt), y.to(dt)


def atan2(x, y):
    return torch.atan2(*_float_pair(x, y))


def hypot(x, y):
    return torch.hypot(*_float_pair(x, y))


def logaddexp(x, y):
    return torch.logaddexp(*_float_pair(x, y))


def copysign(x, y):
    return torch.copysign(*_float_pair(x, y))


def nextafter(x, y):
    return torch.nextafter(*_float_pair(x, y))


def heaviside(x, y):
    x, y = tensor_operands(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.heaviside(x.to(dt), y.to(dt))


def ldexp(x, y):
    x = to_inexact(x)
    return x * torch.pow(torch.tensor(2.0, dtype=x.dtype, device=x.device), y).to(x.dtype)


# ---- unary ----
def abs(x):
    return torch.abs(x)


def neg(x):
    return torch.neg(x)


exp = _unary_float(torch.exp)
expm1 = _unary_float(torch.expm1)
log = _unary_float(torch.log)
log2 = _unary_float(torch.log2)
log10 = _unary_float(torch.log10)
log1p = _unary_float(torch.log1p)
sqrt = _unary_float(torch.sqrt)
rsqrt = _unary_float(torch.rsqrt)
sin = _unary_float(torch.sin)
cos = _unary_float(torch.cos)
tan = _unary_float(torch.tan)
asin = _unary_float(torch.asin)
acos = _unary_float(torch.acos)
atan = _unary_float(torch.atan)
sinh = _unary_float(torch.sinh)
cosh = _unary_float(torch.cosh)
tanh = _unary_float(torch.tanh)
asinh = _unary_float(torch.asinh)
acosh = _unary_float(torch.acosh)
atanh = _unary_float(torch.atanh)
erf = _unary_float(torch.erf)
erfinv = _unary_float(torch.erfinv)
lgamma = _unary_float(torch.lgamma)
digamma = _unary_float(torch.digamma)
i0 = _unary_float(torch.special.i0)
i0e = _unary_float(torch.special.i0e)
i1 = _unary_float(torch.special.i1)
i1e = _unary_float(torch.special.i1e)
reciprocal = _unary_float(torch.reciprocal)
rad2deg = _unary_float(torch.rad2deg)
deg2rad = _unary_float(torch.deg2rad)
angle = _unary_float(torch.angle)


def square(x):
    return torch.square(x)


def _keeps_integers(fn):
    def op(x):
        return fn(x) if _is_inexact(x) else x.clone()

    op.__name__ = fn.__name__
    return op


ceil = _keeps_integers(torch.ceil)
floor = _keeps_integers(torch.floor)
round = _keeps_integers(torch.round)
trunc = _keeps_integers(torch.trunc)


def frac(x):
    return x - trunc(x)


def sign(x):
    return torch.sign(x)


def sgn(x):
    return torch.sgn(x)


def isnan(x):
    return torch.isnan(x)


def isinf(x):
    return torch.isinf(x)


def isfinite(x):
    return torch.isfinite(x)


def nan_to_num(x, *, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def logit(x, *, eps=None):
    x = to_inexact(x)
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def scale(x, *, scale=1.0, bias=0.0, bias_after_scale=True):
    """reference: phi/kernels/scale_kernel.h."""
    if bias_after_scale:
        return add(multiply(x, scale), bias)
    return multiply(add(x, bias), scale)


def clip(x, min, max):
    return torch.minimum(torch.maximum(x, min), max)


def clip_scalar(x, *, min=None, max=None):
    if (isinstance(min, float) or isinstance(max, float)) and not _is_inexact(x):
        x = x.to(torch.float64)
    return torch.clamp(x, min, max)


def stanh(x, *, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * to_inexact(x))


def multiplex(index, *inputs):
    stacked = torch.stack(inputs, dim=0)  # [n, batch, ...]
    idx = index.reshape(-1).long()
    rows = torch.arange(idx.numel(), device=idx.device)
    return stacked[idx, rows]


def addmm(input, x, y, *, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


def inner(x, y):
    return torch.inner(*operands(x, y))


def outer(x, y):
    return torch.outer(*operands(x, y))


def kron(x, y):
    return torch.kron(*operands(x, y))


def diff(x, *, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


def _flat_axis(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, axis)


def cumsum(x, *, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.cumsum(x, dim=axis, dtype=torch.int64 if x.dtype == torch.bool else x.dtype)


def cumprod(x, *, dim=None):
    x, dim = _flat_axis(x, dim)
    return torch.cumprod(x, dim=dim, dtype=torch.int64 if x.dtype == torch.bool else x.dtype)


def _cum_extreme(x, axis, running):
    """(values, indices): the running extreme and the index of the element
    that produced it, the later one on a tie (phi/kernels/cum_maxmin_kernel)."""
    x, axis = _flat_axis(x, axis)
    vals = running(x, dim=axis).values
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    positions = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    marked = torch.where(vals == x, positions, 0)
    return vals, torch.cummax(marked, dim=axis).values


def cummax(x, *, axis=None):
    return _cum_extreme(x, axis, torch.cummax)


def cummin(x, *, axis=None):
    return _cum_extreme(x, axis, torch.cummin)


def logcumsumexp(x, *, axis=None):
    x, axis = _flat_axis(to_inexact(x), axis)
    return torch.logcumsumexp(x, dim=axis)


def trapezoid(y, x=None, *, dx=None, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def lerp(x, y, weight):
    return x + weight * (y - x)


def conj(x):
    return torch.conj(x).resolve_conj()


def real(x):
    return torch.real(x).clone()


def imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def complex_(real, imag):
    return torch.complex(real, imag)


def polygamma(x, *, n=1):
    return torch.polygamma(n, to_inexact(x))


def take(x, index, *, mode="raise"):
    flat = x.reshape(-1)
    n = flat.shape[0]
    if mode == "wrap":
        idx = torch.remainder(index, n)
    elif mode == "clip":
        idx = torch.clamp(index, 0, n - 1)
    else:
        idx = torch.clamp(torch.where(index < 0, index + n, index), 0, n - 1)
    return flat[idx.reshape(-1)].reshape(index.shape)
