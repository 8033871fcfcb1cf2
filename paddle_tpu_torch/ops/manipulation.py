"""Shape and layout ops on torch tensors: ``paddle_tpu/ops/manipulation.py``'s
functions. Paddle's conventions stay: a 0 in ``reshape`` copies the input's
dim, a -1 in ``expand`` keeps it, ``split`` sections may hold one -1,
``chunk`` splits as ``numpy.array_split`` does, ``scatter(overwrite=False)``
zeroes its target rows before summing the updates into them. Every result
is a new value: nothing here writes into its input.
"""
from __future__ import annotations

import functools

import torch

from .math import operands


def reshape(x, *, shape):
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return torch.reshape(x, tuple(shape))


def transpose(x, *, perm):
    return x.permute(*perm)


def squeeze(x, *, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=(axis,) if isinstance(axis, int) else tuple(axis))


def unsqueeze(x, *, axis):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    nd = x.dim() + len(axis)
    for a in sorted(a % nd for a in axis):
        x = x.unsqueeze(a)
    return x


def _common(xs):
    dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return [x.to(dt) for x in xs]


def concat(*xs, axis=0):
    return torch.cat(_common(xs), dim=axis)


def stack(*xs, axis=0):
    return torch.stack(_common(xs), dim=axis)


def unstack(x, *, axis=0, num=None):
    return torch.unbind(x, dim=axis)


def split(x, *, num_or_sections, axis=0):
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: {total} is not divisible into {num_or_sections} parts")
        return torch.split(x, total // num_or_sections, dim=axis)
    sections = list(num_or_sections)
    if -1 in sections:
        sections[sections.index(-1)] = total - sum(s for s in sections if s != -1)
    return torch.split(x, sections, dim=axis)


def chunk(x, *, chunks, axis=0):
    return torch.tensor_split(x, chunks, dim=axis)


def flatten(x, *, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


def tile(x, *, repeat_times):
    return torch.tile(x, tuple(repeat_times))


def expand(x, *, shape):
    ndiff = len(shape) - x.dim()
    shape = [x.shape[i - ndiff] if s == -1 else s for i, s in enumerate(shape)]
    return x.expand(*shape)


def expand_as(x, y):
    return x.expand_as(y)


def broadcast_to(x, *, shape):
    return torch.broadcast_to(x, tuple(shape))


def flip(x, *, axis):
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


def rot90(x, *, k=1, axes=(0, 1)):
    return torch.rot90(x, k, tuple(axes))


def roll(x, *, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, dims=axis)


def _stepped(x, ax, start, end, step):
    """``x[..., start:end:step, ...]`` on axis ``ax``, any sign of step."""
    if step > 0:
        idx = [slice(None)] * x.dim()
        idx[ax] = slice(start, end, step)
        return x[tuple(idx)]
    positions = torch.arange(*slice(start, end, step).indices(x.shape[ax]), device=x.device)
    return torch.index_select(x, ax, positions)


def slice_op(x, *, axes, starts, ends):
    """reference: phi/kernels/slice_kernel.h — static starts and ends."""
    for ax, st, en in zip(axes, starts, ends):
        x = _stepped(x, ax, st, en, 1)
    return x


def strided_slice(x, *, axes, starts, ends, strides):
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        x = _stepped(x, ax, st, en, sd)
    return x


def gather(x, index, *, axis=0):
    return torch.index_select(x, axis, index.reshape(-1))


def _nd(index):
    return tuple(index.movedim(-1, 0))


def gather_nd(x, index):
    return x[_nd(index)]


def scatter(x, index, updates, *, overwrite=True):
    index = (index.reshape(-1),)
    updates = updates.to(x.dtype)
    if overwrite:
        return torch.index_put(x, index, updates)
    # paddle overwrite=False: zero the rows, then accumulate
    zeroed = torch.index_put(x, index, torch.zeros_like(updates))
    return torch.index_put(zeroed, index, updates, accumulate=True)


def scatter_nd_add(x, index, updates):
    return torch.index_put(x, _nd(index), updates.to(x.dtype), accumulate=True)


def scatter_nd(index, updates, *, shape):
    zeros = torch.zeros(tuple(shape), dtype=updates.dtype, device=updates.device)
    return torch.index_put(zeros, _nd(index), updates, accumulate=True)


def put_along_axis(x, index, value, *, axis, reduce="assign", include_self=True):
    value = value.to(x.dtype).expand(index.shape)
    if reduce == "assign":
        return torch.scatter(x, axis, index, value)
    if reduce in ("add", "mul", "multiply"):
        how = "sum" if reduce == "add" else "prod"
        return torch.scatter_reduce(x, axis, index, value, how, include_self=include_self)
    raise ValueError(f"unsupported reduce {reduce}")


def take_along_axis(x, index, *, axis):
    return torch.take_along_dim(x, index, dim=axis)


def index_select(x, index, *, axis=0):
    return torch.index_select(x, axis, index.reshape(-1))


def index_sample(x, index):
    return torch.take_along_dim(x, index, dim=1)


def index_add(x, index, value, *, axis=0):
    return torch.index_add(x, axis, index.reshape(-1), value.to(x.dtype))


def masked_select(x, mask):
    return torch.masked_select(x, mask)


def masked_fill(x, mask, value):
    return torch.where(mask, value.to(x.dtype), x)


def where(condition, x, y):
    return torch.where(condition, *operands(x, y))


def tril(x, *, diagonal=0):
    return torch.tril(x, diagonal)


def triu(x, *, diagonal=0):
    return torch.triu(x, diagonal)


def diag(x, *, offset=0, padding_value=0.0):
    out = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0.0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(mask, out, torch.tensor(padding_value, dtype=out.dtype,
                                                  device=out.device))
    return out


def diagflat(x, *, offset=0):
    return torch.diagflat(x, offset)


def diagonal(x, *, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)


def diag_embed(x, *, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset=offset, dim1=dim1, dim2=dim2)


def repeat_interleave(x, *, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def moveaxis(x, *, source, destination):
    return torch.movedim(x, source, destination)


def as_real(x):
    return torch.view_as_real(x)


def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def unfold(x, *, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col — reference: phi/kernels/unfold_kernel.h; ``paddings`` is one
    int, (h, w) or (top, left, bottom, right)."""
    if isinstance(paddings, int):
        paddings = (paddings,) * 4
    elif len(paddings) == 2:
        paddings = (paddings[0], paddings[1], paddings[0], paddings[1])
    x = torch.nn.functional.pad(x, (paddings[1], paddings[3], paddings[0], paddings[2]))
    return torch.nn.functional.unfold(x, kernel_sizes, dilation=dilations, stride=strides)


def pad(x, *, pad, mode="constant", value=0.0, data_format="NCHW"):
    """``paddle.nn.functional.pad``: a pad list of 2 x ndim is a (before,
    after) pair per axis in order; a shorter one pads the trailing spatial
    axes, last axis first (before the channel axis for channel-last
    formats). ``reflect`` mirrors without the edge, ``replicate`` repeats it,
    ``circular`` wraps, as jnp's ``reflect``, ``edge`` and ``wrap``."""
    pad = [int(p) for p in pad]
    if len(pad) == 2 * x.dim():
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        n_spatial = len(pad) // 2
        widths = [(0, 0)] * x.dim()
        if data_format.endswith("C"):
            spatial_axes = list(range(1, 1 + n_spatial))
        else:
            spatial_axes = list(range(x.dim() - n_spatial, x.dim()))
        for i, ax in enumerate(reversed(spatial_axes)):
            widths[ax] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [v for lo, hi in reversed(widths) for v in (lo, hi)]
        return torch.nn.functional.pad(x, flat, value=value)
    for ax, (lo, hi) in enumerate(widths):
        if lo == 0 and hi == 0:
            continue
        n = x.shape[ax]
        i = torch.arange(-lo, n + hi, device=x.device)
        if mode == "replicate":
            i = i.clamp(0, n - 1)
        elif mode == "reflect":
            i = i.abs()
            i = torch.where(i >= n, 2 * (n - 1) - i, i)
        elif mode == "circular":
            i = i.remainder(n)
        else:
            raise ValueError(f"unknown pad mode {mode!r}")
        x = x.index_select(ax, i)
    return x
