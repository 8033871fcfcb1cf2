"""Search and sort on torch tensors: ``paddle_tpu/ops/search.py``'s functions.

Orders follow the JAX package: sorts are stable (descending keeps equal
values in their order); ``topk`` lists equal values by index, as
``lax.top_k`` does, so it runs on a stable sort rather than
``torch.topk``, whose order on ties is unspecified; ``kthvalue`` takes its
index from a stable sort; ``mode`` breaks a tie of counts to the larger
value and gives the last index of it. ``nonzero``, ``unique`` and
``unique_consecutive`` read their output size on the host (``unique`` goes
through numpy, as the JAX function does: ``torch.unique`` has no
``return_index``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import inexact, to_torch_dtype


def argmax(x, *, axis=None, keepdim=False, dtype="int64"):
    if axis is None:
        out = torch.argmax(x.reshape(-1))
    else:
        out = torch.argmax(x, dim=axis, keepdim=keepdim)
    return out.to(to_torch_dtype(dtype))


def argmin(x, *, axis=None, keepdim=False, dtype="int64"):
    if axis is None:
        out = torch.argmin(x.reshape(-1))
    else:
        out = torch.argmin(x, dim=axis, keepdim=keepdim)
    return out.to(to_torch_dtype(dtype))


def argsort(x, *, axis=-1, descending=False, stable=True):
    return torch.sort(x, dim=axis, descending=descending, stable=True).indices


def sort(x, *, axis=-1, descending=False, stable=True):
    return torch.sort(x, dim=axis, descending=descending, stable=True).values


def topk(x, k, *, axis=-1, largest=True, sorted=True):
    vals, idx = torch.sort(x, dim=axis, descending=largest, stable=True)
    return vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)


def kthvalue(x, *, k, axis=-1, keepdim=False):
    vals, idx = torch.sort(x, dim=axis, stable=True)
    v = vals.select(axis, k - 1)
    i = idx.select(axis, k - 1)
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i


def mode(x, *, axis=-1, keepdim=False):
    """The most frequent value along ``axis`` (ties to the larger value) and
    the index of its last occurrence; sort-based, O(n log n) per row."""
    xm = x.movedim(axis, -1)
    n = xm.shape[-1]
    srt = torch.sort(xm, dim=-1).values
    starts = torch.ones_like(srt, dtype=torch.bool)
    starts[..., 1:] = srt[..., 1:] != srt[..., :-1]
    run = torch.cumsum(starts.long(), dim=-1) - 1  # run id of each sorted slot
    counts = torch.zeros_like(run).scatter_add_(-1, run, torch.ones_like(run))
    count = torch.take_along_dim(counts, run, dim=-1)
    # the most slots, then the larger value (later in the sort)
    score = count * (n + 1) + torch.arange(n, device=x.device)
    best = torch.argmax(score, dim=-1, keepdim=True)
    v = torch.take_along_dim(srt, best, dim=-1).squeeze(-1)
    matches = (xm == v.unsqueeze(-1)).long() * torch.arange(1, n + 1, device=x.device)
    idx = torch.argmax(matches, dim=-1)
    if keepdim:
        v, idx = v.unsqueeze(axis), idx.unsqueeze(axis)
    return v, idx


def nonzero(x, *, as_tuple=False):
    idx = torch.nonzero(x)
    if as_tuple:
        return tuple(idx[:, d].reshape(-1, 1) for d in range(idx.shape[1]))
    return idx


def searchsorted(sorted_sequence, values, *, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values, right=right, out_int32=out_int32)


def bucketize(x, sorted_sequence, *, out_int32=False, right=False):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def _to_device(arrays, like):
    out = tuple(torch.as_tensor(np.ascontiguousarray(a), device=like.device) for a in arrays)
    return out if len(out) > 1 else out[0]


def unique(x, *, return_index=False, return_inverse=False, return_counts=False, axis=None):
    res = np.unique(x.detach().cpu().numpy(), return_index=return_index,
                    return_inverse=return_inverse, return_counts=return_counts, axis=axis)
    return _to_device(res if isinstance(res, tuple) else (res,), x)


def unique_consecutive(x, *, return_inverse=False, return_counts=False, axis=None):
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    xn = x.detach().cpu().numpy().reshape(-1)
    keep = np.concatenate([[True], xn[1:] != xn[:-1]]) if xn.size else np.zeros(0, bool)
    outs = [xn[keep]]
    if return_inverse:
        outs.append(np.cumsum(keep) - 1)
    if return_counts:
        idx = np.flatnonzero(keep)
        outs.append(np.diff(np.concatenate([idx, [len(xn)]])))
    return _to_device(outs, x)


def histogram(x, *, bins=100, min=0, max=0):
    """Counts of ``bins`` equal bins over [min, max] (the data's range when
    both are 0), the last bin closed, in the inexact dtype of ``x``, as
    ``jnp.histogram`` gives them."""
    xf = x.to(inexact(x.dtype)).reshape(-1)
    if min == 0 and max == 0:
        lo, hi = xf.min(), xf.max()
    else:
        lo = torch.tensor(min, dtype=xf.dtype, device=x.device)
        hi = torch.tensor(max, dtype=xf.dtype, device=x.device)
    # jnp.histogram widens an empty range by 0.5 on either side
    same = lo == hi
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    steps = torch.linspace(0, 1, bins + 1, dtype=xf.dtype, device=x.device)
    edges = lo + (hi - lo) * steps
    which = torch.searchsorted(edges, xf, right=True) - 1
    which = torch.where(xf == edges[-1], bins - 1, which)
    inside = (which >= 0) & (which < bins)
    counts = torch.zeros(bins, dtype=xf.dtype, device=x.device)
    return counts.index_add_(0, which[inside], torch.ones_like(xf[inside]))
