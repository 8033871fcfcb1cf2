"""The ``paddle.*`` tensor functions of the port and the ``Tensor`` methods:
the counterpart of ``paddle_tpu/tensor_api.py``.

Every function takes Tensors (a plain ``torch.Tensor`` is taken as a Tensor
whose ``stop_gradient`` is ``not requires_grad``) and Python scalars, runs
the torch function of ``ops/`` on their values through ``core.dispatch.apply``
and returns Tensors. Creation and random functions make their result on the
current device (``set_device``); random ones draw from that device's
generator (``core.random.generator``), which ``paddle.seed`` reseeds.

``_patch_tensor_methods`` binds the JAX package's method list and dunders
(``paddle_tpu/tensor_api.py:973``) onto the port's ``Tensor``; in-place
forms (``add_``, ``reshape_``, ``scatter_``, ...) rebind the cell to the
out-of-place result (``Tensor._rebind``).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from .core import random as _random
from .core.dispatch import apply
from .core.dtype import get_default_dtype, to_torch_dtype
from .core.place import torch_device
from .core.tensor import Tensor, to_tensor
from .ops import (
    creation as _c,
    linalg as _la,
    logic as _lg,
    manipulation as _mp,
    math as _m,
    random_ops as _r,
    reduction as _rd,
    search as _s,
)


def _dev():
    return torch_device()


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        shape = [int(shape)]
    return tuple(int(s) for s in shape)


def _t(x):
    """A Tensor argument: Tensors and torch tensors pass, others become one."""
    return x if isinstance(x, (Tensor, torch.Tensor)) else to_tensor(x)


# ---------------------------------------------------------------------------
# creation — python/paddle/tensor/creation.py
# ---------------------------------------------------------------------------
def zeros(shape, dtype=None, name=None):
    return full(shape, 0.0, dtype or get_default_dtype())


def ones(shape, dtype=None, name=None):
    return full(shape, 1.0, dtype or get_default_dtype())


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return apply(_c.full, shape=_shape(shape), fill_value=fill_value,
                 dtype=dtype or get_default_dtype(), device=_dev())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return apply(_c.zeros_like, x, dtype=dtype)


def ones_like(x, dtype=None, name=None):
    return apply(_c.ones_like, x, dtype=dtype)


def full_like(x, fill_value, dtype=None, name=None):
    return apply(_c.full_like, x, fill_value=fill_value, dtype=dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    for v in (start, end, step):
        if isinstance(v, Tensor):
            raise TypeError("arange with Tensor bounds not supported; pass scalars")
    if dtype is None:
        dtype = ("int64" if builtins.all(isinstance(v, (int, np.integer))
                                         for v in (start, end, step))
                 else get_default_dtype())
    return apply(_c.arange, start=start, end=end, step=step, dtype=dtype, device=_dev())


def linspace(start, stop, num, dtype=None, name=None):
    return apply(_c.linspace, start=float(start), stop=float(stop), num=int(num),
                 dtype=dtype or get_default_dtype(), device=_dev())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return apply(_c.logspace, start=float(start), stop=float(stop), num=int(num),
                 base=float(base), dtype=dtype or get_default_dtype(), device=_dev())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return apply(_c.eye, num_rows=int(num_rows),
                 num_columns=None if num_columns is None else int(num_columns),
                 dtype=dtype or get_default_dtype(), device=_dev())


def meshgrid(*args, **kwargs):
    args = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) else args
    return apply(_c.meshgrid, *args, indexing="ij")


def tril_indices(row, col=None, offset=0, dtype="int64"):
    return apply(_c.tril_indices, row=row, col=col or row, offset=offset, device=_dev())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return apply(_c.triu_indices, row=row, col=col or row, offset=offset, device=_dev())


def diag(x, offset=0, padding_value=0, name=None):
    return apply(_mp.diag, x, offset=offset, padding_value=padding_value)


def diagflat(x, offset=0, name=None):
    return apply(_mp.diagflat, x, offset=offset)


def clone(x, name=None):
    return _t(x).clone()


def assign(x, output=None):
    src = x if isinstance(x, Tensor) else to_tensor(np.asarray(x))
    if output is None:
        return src.clone()
    output.set_value(src)
    return output


def numel(x, name=None):
    return to_tensor(np.int64(_t(x).size))


# ---------------------------------------------------------------------------
# random — python/paddle/tensor/random.py
# ---------------------------------------------------------------------------
def _gen():
    return _random.generator(_dev())


def rand(shape, dtype=None, name=None):
    return apply(_r.uniform, _gen(), shape=_shape(shape), dtype=dtype or get_default_dtype(),
                 min=0.0, max=1.0, differentiable=False)


def randn(shape, dtype=None, name=None):
    return apply(_r.gaussian, _gen(), shape=_shape(shape), dtype=dtype or get_default_dtype(),
                 differentiable=False)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    return apply(_r.uniform, _gen(), shape=_shape(shape), dtype=dtype or get_default_dtype(),
                 min=min, max=max, differentiable=False)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    return apply(_r.normal, _gen(), mean=float(mean), std=float(std),
                 shape=_shape([] if shape is None else shape), dtype=get_default_dtype(),
                 differentiable=False)


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return apply(_r.randint, _gen(), low=int(low), high=int(high), shape=_shape(shape),
                 dtype=dtype, differentiable=False)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, tuple(x.shape), dtype or x.dtype.name)


def randperm(n, dtype="int64", name=None):
    return apply(_r.randperm, _gen(), n=int(n), dtype=dtype, differentiable=False)


def bernoulli(x, name=None):
    return apply(_r.bernoulli, _gen(), x, differentiable=False)


def poisson(x, name=None):
    return apply(_r.poisson, _gen(), x, differentiable=False)


def multinomial(x, num_samples=1, replacement=False, name=None):
    return apply(_r.multinomial, _gen(), x, num_samples=int(num_samples),
                 replacement=replacement, differentiable=False)


# ---------------------------------------------------------------------------
# elementwise math — generated wrappers
# ---------------------------------------------------------------------------
def _binary(fn, op_name):
    def wrapper(x, y, name=None):
        return apply(fn, x, y)

    wrapper.__name__ = op_name
    return wrapper


def _unary(fn, op_name):
    def wrapper(x, name=None):
        return apply(fn, x)

    wrapper.__name__ = op_name
    return wrapper


add = _binary(_m.add, "add")
subtract = _binary(_m.subtract, "subtract")
multiply = _binary(_m.multiply, "multiply")
divide = _binary(_m.divide, "divide")
floor_divide = _binary(_m.floor_divide, "floor_divide")
remainder = _binary(_m.remainder, "remainder")
mod = remainder
floor_mod = remainder
pow = _binary(_m.pow, "pow")
maximum = _binary(_m.maximum, "maximum")
minimum = _binary(_m.minimum, "minimum")
fmax = _binary(_m.fmax, "fmax")
fmin = _binary(_m.fmin, "fmin")
atan2 = _binary(_m.atan2, "atan2")
heaviside = _binary(_m.heaviside, "heaviside")
hypot = _binary(_m.hypot, "hypot")
logaddexp = _binary(_m.logaddexp, "logaddexp")
copysign = _binary(_m.copysign, "copysign")
nextafter = _binary(_m.nextafter, "nextafter")
gcd = _binary(_m.gcd, "gcd")
lcm = _binary(_m.lcm, "lcm")
ldexp = _binary(_m.ldexp, "ldexp")
inner = _binary(_m.inner, "inner")
outer = _binary(_m.outer, "outer")
kron = _binary(_m.kron, "kron")


def lerp(x, y, weight, name=None):
    return apply(_m.lerp, x, y, weight)


abs = _unary(_m.abs, "abs")
neg = _unary(_m.neg, "neg")
exp = _unary(_m.exp, "exp")
expm1 = _unary(_m.expm1, "expm1")
log = _unary(_m.log, "log")
log2 = _unary(_m.log2, "log2")
log10 = _unary(_m.log10, "log10")
log1p = _unary(_m.log1p, "log1p")
sqrt = _unary(_m.sqrt, "sqrt")
rsqrt = _unary(_m.rsqrt, "rsqrt")
square = _unary(_m.square, "square")
reciprocal = _unary(_m.reciprocal, "reciprocal")
sin = _unary(_m.sin, "sin")
cos = _unary(_m.cos, "cos")
tan = _unary(_m.tan, "tan")
asin = _unary(_m.asin, "asin")
acos = _unary(_m.acos, "acos")
atan = _unary(_m.atan, "atan")
sinh = _unary(_m.sinh, "sinh")
cosh = _unary(_m.cosh, "cosh")
tanh = _unary(_m.tanh, "tanh")
asinh = _unary(_m.asinh, "asinh")
acosh = _unary(_m.acosh, "acosh")
atanh = _unary(_m.atanh, "atanh")
ceil = _unary(_m.ceil, "ceil")
floor = _unary(_m.floor, "floor")
round = _unary(_m.round, "round")
trunc = _unary(_m.trunc, "trunc")
frac = _unary(_m.frac, "frac")
sign = _unary(_m.sign, "sign")
sgn = _unary(_m.sgn, "sgn")
erf = _unary(_m.erf, "erf")
erfinv = _unary(_m.erfinv, "erfinv")
lgamma = _unary(_m.lgamma, "lgamma")
digamma = _unary(_m.digamma, "digamma")
i0 = _unary(_m.i0, "i0")
i0e = _unary(_m.i0e, "i0e")
i1 = _unary(_m.i1, "i1")
i1e = _unary(_m.i1e, "i1e")
isnan = _unary(_m.isnan, "isnan")
isinf = _unary(_m.isinf, "isinf")
isfinite = _unary(_m.isfinite, "isfinite")
rad2deg = _unary(_m.rad2deg, "rad2deg")
deg2rad = _unary(_m.deg2rad, "deg2rad")
angle = _unary(_m.angle, "angle")
conj = _unary(_m.conj, "conj")
real = _unary(_m.real, "real")
imag = _unary(_m.imag, "imag")


def tanh_(x, name=None):
    """In-place tanh (reference: paddle.tanh_)."""
    return _rebind_inplace(x, tanh(x))


def polygamma(x, n, name=None):
    return apply(_m.polygamma, x, n=int(n))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply(_m.nan_to_num, x, nan=nan, posinf=posinf, neginf=neginf)


def logit(x, eps=None, name=None):
    return apply(_m.logit, x, eps=eps)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    out = apply(_m.scale, x, scale=float(scale), bias=float(bias),
                bias_after_scale=bias_after_scale)
    if act is not None:
        from .ops import nn_ops as _nn

        out = apply(getattr(_nn, act), out)
    return out


def clip(x, min=None, max=None, name=None):
    if isinstance(min, Tensor) or isinstance(max, Tensor):
        lo = min if isinstance(min, Tensor) else to_tensor(min if min is not None else -np.inf)
        hi = max if isinstance(max, Tensor) else to_tensor(max if max is not None else np.inf)
        return apply(_m.clip, x, lo, hi)
    return apply(_m.clip_scalar, x, min=min, max=max)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply(_m.stanh, x, scale_a=scale_a, scale_b=scale_b)


def multiplex(inputs, index, name=None):
    return apply(_m.multiplex, index, *inputs)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply(_m.addmm, input, x, y, beta=float(beta), alpha=float(alpha))


def diff(x, n=1, axis=-1, name=None):
    return apply(_m.diff, x, n=n, axis=axis)


def cumsum(x, axis=None, dtype=None, name=None):
    out = apply(_m.cumsum, x, axis=axis)
    return out.astype(dtype) if dtype else out


def cumprod(x, dim=None, dtype=None, name=None):
    out = apply(_m.cumprod, x, dim=dim)
    return out.astype(dtype) if dtype else out


def cummax(x, axis=None, dtype="int64", name=None):
    out = apply(_m.cummax, x, axis=axis)
    return out[0], out[1].astype(dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    out = apply(_m.cummin, x, axis=axis)
    return out[0], out[1].astype(dtype)


def logcumsumexp(x, axis=None, name=None):
    return apply(_m.logcumsumexp, x, axis=axis)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply(_m.trapezoid, y, x, axis=axis)
    return apply(_m.trapezoid, y, dx=dx, axis=axis)


def take(x, index, mode="raise", name=None):
    return apply(_m.take, x, index, mode=mode)


# ---------------------------------------------------------------------------
# reductions — python/paddle/tensor/math.py & stat.py
# ---------------------------------------------------------------------------
def _reduction(fn, op_name, has_dtype=False):
    if has_dtype:
        def wrapper(x, axis=None, dtype=None, keepdim=False, name=None):
            return apply(fn, x, axis=axis, keepdim=keepdim,
                         dtype=None if dtype is None else to_torch_dtype(dtype))
    else:
        def wrapper(x, axis=None, keepdim=False, name=None):
            return apply(fn, x, axis=axis, keepdim=keepdim)
    wrapper.__name__ = op_name
    return wrapper


sum = _reduction(_rd.sum, "sum", has_dtype=True)
mean = _reduction(_rd.mean, "mean")
max = _reduction(_rd.max, "max")
min = _reduction(_rd.min, "min")
amax = _reduction(_rd.amax, "amax")
amin = _reduction(_rd.amin, "amin")
prod = _reduction(_rd.prod, "prod", has_dtype=True)
logsumexp = _reduction(_rd.logsumexp, "logsumexp")
all = _reduction(_rd.all, "all")
any = _reduction(_rd.any, "any")
median = _reduction(_rd.median, "median")
nanmedian = _reduction(_rd.nanmedian, "nanmedian")
nansum = _reduction(_rd.nansum, "nansum", has_dtype=True)
nanmean = _reduction(_rd.nanmean, "nanmean")
count_nonzero = _reduction(_rd.count_nonzero, "count_nonzero")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(_rd.std, x, axis=axis, unbiased=unbiased, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(_rd.var, x, axis=axis, unbiased=unbiased, keepdim=keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return apply(_rd.quantile, x, q, axis=axis, keepdim=keepdim)


# ---------------------------------------------------------------------------
# logic — python/paddle/tensor/logic.py
# ---------------------------------------------------------------------------
equal = _binary(_lg.equal, "equal")
not_equal = _binary(_lg.not_equal, "not_equal")
greater_than = _binary(_lg.greater_than, "greater_than")
greater_equal = _binary(_lg.greater_equal, "greater_equal")
less_than = _binary(_lg.less_than, "less_than")
less_equal = _binary(_lg.less_equal, "less_equal")
logical_and = _binary(_lg.logical_and, "logical_and")
logical_or = _binary(_lg.logical_or, "logical_or")
logical_xor = _binary(_lg.logical_xor, "logical_xor")
logical_not = _unary(_lg.logical_not, "logical_not")
bitwise_and = _binary(_lg.bitwise_and, "bitwise_and")
bitwise_or = _binary(_lg.bitwise_or, "bitwise_or")
bitwise_xor = _binary(_lg.bitwise_xor, "bitwise_xor")
bitwise_not = _unary(_lg.bitwise_not, "bitwise_not")
equal_all = _binary(_lg.equal_all, "equal_all")


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply(_lg.allclose, x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply(_lg.isclose, x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


def is_tensor(x):
    return isinstance(x, Tensor)


def is_empty(x):
    return to_tensor(_t(x).size == 0)


def in_dynamic_mode():
    return True  # the port has no static mode (ROADMAP queue 1 item 14)


# ---------------------------------------------------------------------------
# manipulation — python/paddle/tensor/manipulation.py
# ---------------------------------------------------------------------------
def _shape_allow_minus(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    return tuple(int(s) for s in shape)


def reshape(x, shape, name=None):
    return apply(_mp.reshape, x, shape=_shape_allow_minus(shape))


def reshape_(x, shape, name=None):
    return _rebind_inplace(x, reshape(x, shape))


def transpose(x, perm, name=None):
    return apply(_mp.transpose, x, perm=tuple(perm))


def _axes(axis):
    return tuple(np.atleast_1d(axis).tolist())


def squeeze(x, axis=None, name=None):
    return apply(_mp.squeeze, x, axis=axis if axis is None else _axes(axis))


def unsqueeze(x, axis, name=None):
    return apply(_mp.unsqueeze, x, axis=_axes(axis))


def concat(x, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply(_mp.concat, *x, axis=axis)


def stack(x, axis=0, name=None):
    return apply(_mp.stack, *x, axis=axis)


def unstack(x, axis=0, num=None):
    return list(apply(_mp.unstack, x, axis=axis, num=num))


def split(x, num_or_sections, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    if isinstance(num_or_sections, (list, tuple)):
        num_or_sections = tuple(int(s) for s in num_or_sections)
    return list(apply(_mp.split, x, num_or_sections=num_or_sections, axis=axis))


def chunk(x, chunks, axis=0, name=None):
    return list(apply(_mp.chunk, x, chunks=chunks, axis=axis))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return apply(_mp.flatten, x, start_axis=start_axis, stop_axis=stop_axis)


def tile(x, repeat_times, name=None):
    return apply(_mp.tile, x, repeat_times=tuple(repeat_times))


def expand(x, shape, name=None):
    return apply(_mp.expand, x, shape=_shape_allow_minus(shape))


def expand_as(x, y, name=None):
    return apply(_mp.expand_as, x, y)


def broadcast_to(x, shape, name=None):
    return apply(_mp.broadcast_to, x, shape=_shape(shape))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def broadcast_tensors(inputs, name=None):
    shape = np.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [broadcast_to(t, shape) for t in inputs]


def flip(x, axis, name=None):
    return apply(_mp.flip, x, axis=_axes(axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply(_mp.rot90, x, k=k, axes=tuple(axes))


def roll(x, shifts, axis=None, name=None):
    if isinstance(shifts, (list, tuple)):
        shifts = tuple(shifts)
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return apply(_mp.roll, x, shifts=shifts, axis=axis)


def cast(x, dtype):
    return _t(x).astype(dtype)


def slice(x, axes, starts, ends):
    return apply(_mp.slice_op, x, axes=tuple(axes), starts=tuple(int(s) for s in starts),
                 ends=tuple(int(e) for e in ends))


def strided_slice(x, axes, starts, ends, strides, name=None):
    return apply(_mp.strided_slice, x, axes=tuple(axes), starts=tuple(starts),
                 ends=tuple(ends), strides=tuple(strides))


def gather(x, index, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply(_mp.gather, x, index, axis=axis)


def gather_nd(x, index, name=None):
    return apply(_mp.gather_nd, x, index)


def scatter(x, index, updates, overwrite=True, name=None):
    return apply(_mp.scatter, x, index, updates, overwrite=overwrite)


def scatter_(x, index, updates, overwrite=True, name=None):
    return _rebind_inplace(x, scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    return apply(_mp.scatter_nd_add, x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    return apply(_mp.scatter_nd, index, updates, shape=_shape(shape))


def _broadcast_indices(arr, indices, axis):
    """reference take_along_axis broadcast=True: indices broadcast against
    arr on every dim except ``axis``; they must have arr's rank."""
    if indices.ndim != arr.ndim:
        raise ValueError(
            f"take/put_along_axis: indices rank {indices.ndim} must equal "
            f"input rank {arr.ndim} (unsqueeze the missing dims explicitly)")
    tgt = list(arr.shape)
    tgt[axis] = indices.shape[axis]
    return broadcast_to(indices, tgt)


def put_along_axis(arr, indices, values, axis, reduce="assign", include_self=True,
                   broadcast=True):
    if broadcast:
        indices = _broadcast_indices(arr, indices, axis)
    values = _t(values)
    return apply(_mp.put_along_axis, arr, indices, values, axis=axis, reduce=reduce,
                 include_self=bool(include_self))


def take_along_axis(arr, indices, axis, broadcast=True):
    if broadcast:
        indices = _broadcast_indices(arr, indices, axis)
    return apply(_mp.take_along_axis, arr, indices, axis=axis)


def index_select(x, index, axis=0, name=None):
    return apply(_mp.index_select, x, index, axis=axis)


def index_sample(x, index):
    return apply(_mp.index_sample, x, index)


def index_add(x, index, axis, value, name=None):
    return apply(_mp.index_add, x, index, value, axis=axis)


def masked_select(x, mask, name=None):
    # not differentiable in the JAX package either (its output size is data's)
    return apply(_mp.masked_select, x, mask, differentiable=False)


def masked_fill(x, mask, value, name=None):
    if not isinstance(value, (Tensor, torch.Tensor)):
        value = to_tensor(value, dtype=_t(x).dtype)
    return apply(_mp.masked_fill, x, mask, value)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return apply(_mp.where, condition, _t(x), _t(y))


def tril(x, diagonal=0, name=None):
    return apply(_mp.tril, x, diagonal=diagonal)


def triu(x, diagonal=0, name=None):
    return apply(_mp.triu, x, diagonal=diagonal)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(_mp.diagonal, x, offset=offset, axis1=axis1, axis2=axis2)


def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    return apply(_mp.diag_embed, input, offset=offset, dim1=dim1, dim2=dim2)


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, Tensor):
        repeats = repeats._value
    return apply(_mp.repeat_interleave, x, repeats=repeats, axis=axis)


def moveaxis(x, source, destination, name=None):
    return apply(_mp.moveaxis, x, source=_axes(source), destination=_axes(destination))


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return apply(_mp.unfold, x, kernel_sizes=kernel_sizes, strides=strides,
                 paddings=paddings, dilations=dilations)


def as_real(x, name=None):
    return apply(_mp.as_real, x)


def as_complex(x, name=None):
    return apply(_mp.as_complex, x)


def complex(real, imag, name=None):
    return apply(_m.complex_, real, imag)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = tuple(list(a) if isinstance(a, (list, tuple)) else a for a in axes)
    return apply(_la.tensordot, x, y, axes=axes)


def crop(x, shape=None, offsets=None, name=None):
    shape = _shape(shape)
    offsets = tuple(int(o) for o in (offsets or [0] * len(shape)))
    ends = tuple(o + s for o, s in zip(offsets, shape))
    return slice(x, tuple(range(len(shape))), offsets, ends)


# ---------------------------------------------------------------------------
# search/sort — python/paddle/tensor/search.py
# ---------------------------------------------------------------------------
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply(_s.argmax, x, axis=axis, keepdim=keepdim, dtype=dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply(_s.argmin, x, axis=axis, keepdim=keepdim, dtype=dtype)


def argsort(x, axis=-1, descending=False, stable=True, name=None):
    return apply(_s.argsort, x, axis=axis, descending=descending, stable=stable)


def sort(x, axis=-1, descending=False, stable=True, name=None):
    return apply(_s.sort, x, axis=axis, descending=descending, stable=stable)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    if isinstance(k, Tensor):
        k = int(k.item())
    out = apply(_s.topk, x, int(k), axis=axis, largest=largest, sorted=sorted)
    return out[0], out[1]


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    out = apply(_s.kthvalue, x, k=int(k), axis=axis, keepdim=keepdim)
    return out[0], out[1]


def mode(x, axis=-1, keepdim=False, name=None):
    out = apply(_s.mode, x, axis=axis, keepdim=keepdim)
    return out[0], out[1]


def nonzero(x, as_tuple=False):
    out = apply(_s.nonzero, x, as_tuple=as_tuple, differentiable=False)
    return tuple(out) if as_tuple else out


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    return apply(_s.searchsorted, sorted_sequence, values, out_int32=out_int32, right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return apply(_s.bucketize, x, sorted_sequence, out_int32=out_int32, right=right)


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64", name=None):
    return apply(_s.unique, x, return_index=return_index, return_inverse=return_inverse,
                 return_counts=return_counts, axis=axis, differentiable=False)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None,
                       dtype="int64", name=None):
    return apply(_s.unique_consecutive, x, return_inverse=return_inverse,
                 return_counts=return_counts, axis=axis, differentiable=False)


def histogram(x, bins=100, min=0, max=0, name=None):
    return apply(_s.histogram, x, bins=bins, min=min, max=max, differentiable=False)


def bincount(x, weights=None, minlength=0, name=None):
    return apply(_la.bincount, x, weights, minlength=minlength, differentiable=False)


# ---------------------------------------------------------------------------
# linalg — python/paddle/tensor/linalg.py
# ---------------------------------------------------------------------------
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return apply(_la.matmul, x, y, transpose_x=transpose_x, transpose_y=transpose_y)


def dot(x, y, name=None):
    return apply(_la.dot, x, y)


def einsum(equation, *operands):
    """paddle.einsum (reference: python/paddle/tensor/einsum.py)."""
    return apply(_la.einsum, *operands, equation=equation)


def mm(input, mat2, name=None):
    return apply(_la.mm, input, mat2)


def bmm(x, y, name=None):
    return apply(_la.bmm, x, y)


def mv(x, vec, name=None):
    return apply(_la.mv, x, vec)


def t(input, name=None):
    return apply(_la.t, input)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return apply(_la.norm, x, p=p, axis=axis, keepdim=keepdim)


def dist(x, y, p=2.0, name=None):
    return apply(_la.dist, x, y, p=float(p))


def cross(x, y, axis=None, name=None):
    return apply(_la.cross, x, y, axis=axis)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(_la.trace, x, offset=offset, axis1=axis1, axis2=axis2)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return apply(_la.cosine_similarity, x1, x2, axis=axis, eps=eps)


# ---------------------------------------------------------------------------
# Tensor method patching (varbase_patch_methods analogue)
# ---------------------------------------------------------------------------
def _rebind_inplace(target, out):
    """Shared in-place step: ``target`` holds ``out``'s value (and, with it,
    the autograd edge torch recorded), keeping its identity."""
    return target._rebind(out._value)


METHOD_NAMES = [
    # math
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "maximum", "minimum", "fmax", "fmin", "abs", "neg", "exp",
    "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "square",
    "reciprocal", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "asinh", "acosh", "atanh", "ceil", "floor", "round",
    "trunc", "frac", "sign", "erf", "erfinv", "lgamma", "digamma", "isnan",
    "isinf", "isfinite", "nan_to_num", "logit", "scale", "clip", "lerp",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp", "diff",
    "conj", "real", "imag", "angle", "rad2deg", "deg2rad", "take",
    "addmm", "inner", "outer", "kron",
    # reductions
    "sum", "mean", "max", "min", "amax", "amin", "prod", "logsumexp",
    "all", "any", "std", "var", "median", "nanmedian", "nansum",
    "nanmean", "quantile", "count_nonzero",
    # logic
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "equal_all", "allclose", "isclose",
    # manipulation
    "reshape", "reshape_", "transpose", "squeeze", "unsqueeze", "flatten",
    "tile", "expand", "expand_as", "broadcast_to", "flip", "roll",
    "gather", "gather_nd", "scatter", "scatter_", "scatter_nd_add",
    "put_along_axis", "take_along_axis", "index_select", "index_sample",
    "index_add", "masked_select", "masked_fill", "where", "tril", "triu",
    "diagonal", "repeat_interleave", "moveaxis", "unfold", "split",
    "chunk", "unstack", "as_real", "as_complex", "rot90", "numel",
    # search
    "argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
    "nonzero", "searchsorted", "bucketize", "unique",
    "unique_consecutive", "histogram", "bincount",
    # linalg
    "matmul", "dot", "mm", "bmm", "mv", "t", "norm", "dist", "cross",
    "trace", "tensordot",
]


def _swap(fn):
    def rev(self, other):
        return fn(_t(other) if not isinstance(other, Tensor) else other, self)

    return rev


def _inplace(fn):
    def method(self, *a, **k):
        return _rebind_inplace(self, fn(self, *a, **k))

    return method


def _patch_tensor_methods():
    mod = globals()
    for nm in METHOD_NAMES:
        if not hasattr(Tensor, nm):
            setattr(Tensor, nm, mod[nm])

    Tensor.__add__ = lambda s, o: add(s, o)
    Tensor.__radd__ = lambda s, o: add(s, o)
    Tensor.__sub__ = lambda s, o: subtract(s, o)
    Tensor.__rsub__ = _swap(subtract)
    Tensor.__mul__ = lambda s, o: multiply(s, o)
    Tensor.__rmul__ = lambda s, o: multiply(s, o)
    Tensor.__truediv__ = lambda s, o: divide(s, o)
    Tensor.__rtruediv__ = _swap(divide)
    Tensor.__floordiv__ = lambda s, o: floor_divide(s, o)
    Tensor.__rfloordiv__ = _swap(floor_divide)
    Tensor.__mod__ = lambda s, o: remainder(s, o)
    Tensor.__rmod__ = _swap(remainder)
    Tensor.__pow__ = lambda s, o: pow(s, o)
    Tensor.__rpow__ = _swap(pow)
    Tensor.__neg__ = lambda s: neg(s)
    Tensor.__abs__ = lambda s: abs(s)
    Tensor.__matmul__ = lambda s, o: matmul(s, o)
    Tensor.__rmatmul__ = _swap(matmul)
    Tensor.__eq__ = lambda s, o: equal(s, o if o is not None else float("nan"))
    Tensor.__ne__ = lambda s, o: not_equal(s, o)
    Tensor.__lt__ = lambda s, o: less_than(s, o)
    Tensor.__le__ = lambda s, o: less_equal(s, o)
    Tensor.__gt__ = lambda s, o: greater_than(s, o)
    Tensor.__ge__ = lambda s, o: greater_equal(s, o)
    Tensor.__invert__ = lambda s: logical_not(s)
    Tensor.__and__ = lambda s, o: (
        logical_and(s, o) if s.dtype.name == "bool" else bitwise_and(s, o))
    Tensor.__or__ = lambda s, o: (
        logical_or(s, o) if s.dtype.name == "bool" else bitwise_or(s, o))
    Tensor.__xor__ = lambda s, o: (
        logical_xor(s, o) if s.dtype.name == "bool" else bitwise_xor(s, o))
    Tensor.__hash__ = object.__hash__

    Tensor.add_ = _inplace(add)
    Tensor.subtract_ = _inplace(subtract)
    Tensor.multiply_ = _inplace(multiply)
    Tensor.scale_ = _inplace(scale)
    Tensor.clip_ = _inplace(clip)
    Tensor.exponential_ = lambda self, lam=1.0: self.set_value(
        apply(_r.exponential, _random.generator(self._value.device), self, lam=lam,
              differentiable=False))
    Tensor.uniform_ = lambda self, min=-1.0, max=1.0, seed=0: self.set_value(
        apply(_r.uniform, _random.generator(self._value.device), shape=tuple(self.shape),
              dtype=self._value.dtype, min=min, max=max, differentiable=False))
    Tensor.normal_ = lambda self, mean=0.0, std=1.0: self.set_value(
        apply(_r.gaussian, _random.generator(self._value.device), shape=tuple(self.shape),
              dtype=self._value.dtype, mean=mean, std=std, differentiable=False))

    Tensor.rank = property(lambda self: to_tensor(np.int32(self.ndim)))
    Tensor.T = property(lambda self: transpose(self, list(range(self.ndim))[::-1]))
    Tensor.mT = property(lambda self: apply(lambda v: v.transpose(-1, -2), self))


_patch_tensor_methods()


# ---------------------------------------------------------------------------
# top-level surface completion (reference: python/paddle/__init__.py __all__)
# ---------------------------------------------------------------------------
def add_n(inputs, name=None):
    """Element-wise sum of a list of tensors (reference: tensor/math.py add_n)."""
    if isinstance(inputs, Tensor):
        return inputs
    out = inputs[0]
    for x in inputs[1:]:
        out = add(out, x)
    return out


def increment(x, value=1.0, name=None):
    """In-place add of a scalar (reference: tensor/math.py increment)."""
    x.set_value(apply(lambda v: v + value, x))
    return x


def is_complex(x):
    return (x._value if isinstance(x, Tensor) else x).is_complex()


def is_floating_point(x):
    return (x._value if isinstance(x, Tensor) else x).is_floating_point()


def is_integer(x):
    v = x._value if isinstance(x, Tensor) else x
    return not (v.is_floating_point() or v.is_complex() or v.dtype == torch.bool)


def rank(x):
    """Rank (ndim) as a 0-D int32 tensor (reference: tensor/attribute.py)."""
    return to_tensor(np.int32(x.ndim if hasattr(x, "ndim") else np.ndim(x)))


def shape(x):
    """Runtime shape as a 1-D int32 tensor (reference: fluid shape op)."""
    return to_tensor(np.asarray(list(x.shape), np.int32))


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    def _nq(v):
        w = v if v.dtype == torch.float64 else v.to(torch.float64)
        ax = None if axis is None else int(np.atleast_1d(axis)[0])
        out = torch.nanquantile(w.reshape(-1) if ax is None else w,
                                torch.tensor(q, dtype=torch.float64, device=v.device),
                                dim=0 if ax is None else ax, keepdim=keepdim and ax is not None)
        if keepdim and ax is None:
            out = out.reshape(*out.shape, *[1] * v.dim())
        return out.to(v.dtype if v.is_floating_point() else torch.float32)

    return apply(_nq, x)


def renorm(x, p, axis, max_norm, name=None):
    """Clip each slice along ``axis`` to p-norm <= max_norm (reference:
    tensor/math.py renorm)."""

    def _renorm(v):
        ax = axis if axis >= 0 else axis + v.dim()
        red = tuple(i for i in range(v.dim()) if i != ax)
        norms = torch.sum(torch.abs(v) ** p, dim=red, keepdim=True) ** (1.0 / p)
        factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                             torch.ones_like(norms))
        return v * factor

    return apply(_renorm, x)


def reverse(x, axis, name=None):
    return flip(x, axis)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Recode a global index into a shard-local one (reference:
    operators/shard_index_op.h)."""
    if not 0 <= shard_id < nshards:
        raise ValueError(f"shard_id {shard_id} out of range [0, {nshards})")
    size = (index_num + nshards - 1) // nshards
    return apply(lambda v: torch.where(torch.div(v, size, rounding_mode="floor") == shard_id,
                                       v % size, ignore_value), input)


def tolist(x):
    return x.numpy().tolist()


def unbind(input, axis=0):
    """Split along ``axis`` into a list of (axis-removed) tensors."""
    n = input.shape[axis]
    return [squeeze(s, axis=axis) for s in split(input, n, axis=axis)]


def squeeze_(x, axis=None, name=None):
    return _rebind_inplace(x, squeeze(x, axis=axis))


def unsqueeze_(x, axis, name=None):
    return _rebind_inplace(x, unsqueeze(x, axis=axis))


def set_printoptions(precision=None, threshold=None, edgeitems=None, sci_mode=None,
                     linewidth=None):
    """reference: tensor/to_string.py set_printoptions — numpy prints here."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


def check_shape(shape):
    """Validate a shape argument (reference: fluid/layers/utils.py:373)."""
    if isinstance(shape, Tensor):
        return
    for item in shape:
        if isinstance(item, Tensor):
            continue
        if not isinstance(item, (int, np.integer)):
            raise TypeError(f"shape entries must be int, got {type(item)}")
        if item < -1:
            raise ValueError(f"shape entries must be >= -1, got {item}")


def disable_signal_handler():
    """reference: paddle.disable_signal_handler — no custom handlers here."""


_INPLACE_BASES = ("ceil", "exp", "floor", "round", "rsqrt", "sqrt", "reciprocal", "erfinv",
                  "lerp", "flatten", "put_along_axis")


def _bind_remaining_tensor_methods():
    """Bind the rest of the reference Tensor-method surface: module functions
    as methods and generated in-place variants (also exported, as
    ``paddle.sqrt_`` and friends)."""
    mod = globals()
    for name in ("add_n", "broadcast_shape", "broadcast_tensors", "concat", "floor_mod",
                 "gcd", "increment", "is_complex", "is_empty", "is_floating_point",
                 "is_integer", "is_tensor", "lcm", "multiplex", "nanquantile", "reverse",
                 "scatter_nd", "shard_index", "slice", "squeeze_", "stack", "stanh",
                 "strided_slice", "tanh_", "unbind", "unsqueeze_"):
        if not hasattr(Tensor, name):
            setattr(Tensor, name, mod[name])
    for base in _INPLACE_BASES:
        nm = base + "_"
        if not hasattr(Tensor, nm):
            setattr(Tensor, nm, _inplace(mod[base]))
        mod.setdefault(nm, getattr(Tensor, nm))



def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A standalone trainable parameter on the current device
    (``paddle.create_parameter``): ``default_initializer``, else the
    attribute's initializer, else zeros for a bias and XavierNormal
    otherwise; ``name`` becomes its ``param_name``."""
    from .nn import initializer as I
    from .nn.layer.common import create_parameter as make

    init = (default_initializer or getattr(attr, "initializer", None)
            or (I.Constant(0.0) if is_bias else I.XavierNormal()))
    param = make(shape, init, None, to_torch_dtype(dtype))
    if name:
        param.param_name = name
    return param


_bind_remaining_tensor_methods()

__all__ = [n for n, v in globals().items() if not n.startswith("_") and n != "METHOD_NAMES"
           and not isinstance(v, type(np))]
