"""Reductions on torch tensors: ``paddle_tpu/ops/reduction.py``'s functions.

They follow jnp where torch differs: an integer or bool sum or product
gives int64; a mean, variance or median of integers computes in the inexact
dtype of ``dtype.inexact``; ``std`` and ``var`` are unbiased by default;
``median`` and ``nanmedian`` take the mean of the two middle values of an
even count (``torch.median`` takes the lower one).
"""
from __future__ import annotations

import torch

from .math import to_inexact


def axes(axis, ndim):
    """``axis`` (None, an int, a list or tuple) as a tuple of dims."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _int_sum_dtype(x, dtype):
    if dtype is not None:
        return dtype
    return None if (x.is_floating_point() or x.is_complex()) else torch.int64


def sum(x, *, axis=None, keepdim=False, dtype=None):
    return torch.sum(x, dim=axes(axis, x.dim()), keepdim=keepdim,
                     dtype=_int_sum_dtype(x, dtype))


def mean(x, *, axis=None, keepdim=False):
    return torch.mean(to_inexact(x), dim=axes(axis, x.dim()), keepdim=keepdim)


def max(x, *, axis=None, keepdim=False):
    return torch.amax(x, dim=axes(axis, x.dim()), keepdim=keepdim)


def min(x, *, axis=None, keepdim=False):
    return torch.amin(x, dim=axes(axis, x.dim()), keepdim=keepdim)


amax = max
amin = min


def _moved_last(x, axis):
    """``x`` with the reduced axes flattened into one last axis, and the
    shape the result takes with keepdim."""
    dims = tuple(a % x.dim() for a in axes(axis, x.dim())) if x.dim() else ()
    rest = [d for d in range(x.dim()) if d not in dims]
    kept = [1 if d in dims else x.shape[d] for d in range(x.dim())]
    moved = x.permute(*rest, *dims) if x.dim() else x.reshape(1)
    return moved.reshape(*[x.shape[d] for d in rest], -1), kept


def prod(x, *, axis=None, keepdim=False, dtype=None):
    flat, kept = _moved_last(x, axis)
    out = torch.prod(flat, dim=-1, dtype=_int_sum_dtype(x, dtype))
    return out.reshape(kept) if keepdim else out


def logsumexp(x, *, axis=None, keepdim=False):
    return torch.logsumexp(to_inexact(x), dim=axes(axis, x.dim()), keepdim=keepdim)


def all(x, *, axis=None, keepdim=False):
    return torch.all(x.bool(), dim=axes(axis, x.dim()), keepdim=keepdim)


def any(x, *, axis=None, keepdim=False):
    return torch.any(x.bool(), dim=axes(axis, x.dim()), keepdim=keepdim)


def std(x, *, axis=None, unbiased=True, keepdim=False):
    return torch.std(to_inexact(x), dim=axes(axis, x.dim()), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, *, axis=None, unbiased=True, keepdim=False):
    return torch.var(to_inexact(x), dim=axes(axis, x.dim()), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _middle_mean(srt, count):
    """The median of each row of ``srt`` (sorted along its last axis, its
    first ``count`` entries valid): the middle value, or the mean of the two
    middle values of an even count."""
    lo = torch.clamp((count - 1) // 2, min=0).unsqueeze(-1)
    hi = torch.clamp(count // 2, min=0).unsqueeze(-1)
    a = torch.take_along_dim(srt, lo, dim=-1).squeeze(-1)
    b = torch.take_along_dim(srt, hi, dim=-1).squeeze(-1)
    return (a + b) / 2


def _sorted(flat):
    """``flat`` sorted along its last axis, stably: the gradient of a value
    with ties goes to the same element on every device."""
    return torch.sort(flat, dim=-1, stable=True).values


def median(x, *, axis=None, keepdim=False):
    flat, kept = _moved_last(to_inexact(x), axis)
    srt = _sorted(flat)
    out = _middle_mean(srt, torch.full(srt.shape[:-1], srt.shape[-1], device=x.device))
    # jnp.median is NaN where a NaN is among the values (torch.sort puts them last)
    out = torch.where(torch.isnan(srt[..., -1]), srt[..., -1], out)
    return out.reshape(kept) if keepdim else out


def nanmedian(x, *, axis=None, keepdim=False):
    flat, kept = _moved_last(to_inexact(x), axis)
    srt = _sorted(flat)  # NaNs last
    count = (~torch.isnan(srt)).sum(-1)
    out = _middle_mean(srt, count)
    out = torch.where(count == 0, torch.full_like(out, float("nan")), out)
    return out.reshape(kept) if keepdim else out


def nansum(x, *, axis=None, keepdim=False, dtype=None):
    return torch.nansum(x, dim=axes(axis, x.dim()), keepdim=keepdim,
                        dtype=_int_sum_dtype(x, dtype))


def nanmean(x, *, axis=None, keepdim=False):
    return torch.nanmean(to_inexact(x), dim=axes(axis, x.dim()), keepdim=keepdim)


def quantile(x, q, *, axis=None, keepdim=False):
    """jnp.quantile's linear interpolation between the two order statistics
    around ``q * (n - 1)``, on a stable sort; NaN where a NaN is among the
    values. Quantiles lead the result's axes."""
    x = to_inexact(x)
    flat, kept = _moved_last(x, axis)
    qt = q.to(x.dtype) if isinstance(q, torch.Tensor) else torch.tensor(
        q, dtype=x.dtype, device=x.device)
    srt = _sorted(flat)
    n = srt.shape[-1]
    pos = (qt * (n - 1)).reshape(-1)
    low = pos.floor().clamp(0, n - 1)
    high_weight = pos - low
    low = low.long()
    high = (low + 1).clamp(max=n - 1)
    out = (srt.index_select(-1, low) * (1 - high_weight)
           + srt.index_select(-1, high) * high_weight)
    out = torch.where(torch.isnan(srt[..., -1:]), srt[..., -1:], out)
    out = out.movedim(-1, 0).reshape(tuple(qt.shape) + tuple(srt.shape[:-1]))
    if keepdim:
        out = out.reshape(*qt.shape, *kept)
    return out


def count_nonzero(x, *, axis=None, keepdim=False):
    dims = axes(axis, x.dim())
    out = torch.count_nonzero(x, dim=dims)
    if keepdim:
        out = out.reshape([1 if d in [a % x.dim() for a in dims] else s
                           for d, s in enumerate(x.shape)])
    return out
