"""Products and norms on torch tensors: ``paddle_tpu/ops/linalg.py``'s
functions (the matrix products run on cuBLAS through ``torch.matmul``)."""
from __future__ import annotations

import torch

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
