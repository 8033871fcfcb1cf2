"""Creation ops on torch tensors: ``paddle_tpu/ops/creation.py``'s functions.
Each takes the torch ``device`` it creates on."""
from __future__ import annotations

import torch

from ..core.dtype import to_torch_dtype


def full(*, shape, fill_value, dtype="float32", device=None):
    return torch.full(tuple(shape), fill_value, dtype=to_torch_dtype(dtype), device=device)


def full_like(x, *, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=None if dtype is None else to_torch_dtype(dtype))


def zeros_like(x, *, dtype=None):
    return torch.zeros_like(x, dtype=None if dtype is None else to_torch_dtype(dtype))


def ones_like(x, *, dtype=None):
    return torch.ones_like(x, dtype=None if dtype is None else to_torch_dtype(dtype))


def arange(*, start, end, step, dtype="int64", device=None):
    return torch.arange(start, end, step, dtype=to_torch_dtype(dtype), device=device)


def linspace(*, start, stop, num, dtype="float32", device=None):
    return torch.linspace(start, stop, num, dtype=to_torch_dtype(dtype), device=device)


def logspace(*, start, stop, num, base=10.0, dtype="float32", device=None):
    return torch.logspace(start, stop, num, base=base, dtype=to_torch_dtype(dtype),
                          device=device)


def eye(*, num_rows, num_columns=None, dtype="float32", device=None):
    return torch.eye(num_rows, num_rows if num_columns is None else num_columns,
                     dtype=to_torch_dtype(dtype), device=device)


def meshgrid(*xs, indexing="ij"):
    return tuple(torch.meshgrid(*xs, indexing=indexing))


def tril_indices(*, row, col, offset=0, device=None):
    return torch.tril_indices(row, col, offset, device=device)


def triu_indices(*, row, col, offset=0, device=None):
    return torch.triu_indices(row, col, offset, device=device)


def one_hot(x, *, num_classes):
    """f32 one-hot rows; a label outside ``[0, num_classes)`` gives a row of
    zeros, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)
