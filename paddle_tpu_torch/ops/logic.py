"""Comparison, logical and bitwise ops on torch tensors:
``paddle_tpu/ops/logic.py``'s functions. Comparisons and logical ops give
bool; ``equal_all``, ``allclose`` give a 0-d bool tensor."""
from __future__ import annotations

import torch

from .math import operands, tensor_operands


def _compare(fn):
    def op(x, y):
        return fn(*operands(x, y))

    op.__name__ = fn.__name__
    return op


equal = _compare(torch.eq)
not_equal = _compare(torch.ne)
greater_than = _compare(torch.gt)
greater_equal = _compare(torch.ge)
less_than = _compare(torch.lt)
less_equal = _compare(torch.le)


def logical_and(x, y):
    return torch.logical_and(*tensor_operands(x, y))


def logical_or(x, y):
    return torch.logical_or(*tensor_operands(x, y))


def logical_xor(x, y):
    return torch.logical_xor(*tensor_operands(x, y))


def logical_not(x):
    return torch.logical_not(x)


def bitwise_and(x, y):
    return torch.bitwise_and(*operands(x, y))


def bitwise_or(x, y):
    return torch.bitwise_or(*operands(x, y))


def bitwise_xor(x, y):
    return torch.bitwise_xor(*operands(x, y))


def bitwise_not(x):
    return torch.bitwise_not(x)


def _same_dtype(x, y):
    x, y = tensor_operands(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def equal_all(x, y):
    x, y = _same_dtype(x, y)
    same = x.shape == y.shape and bool(torch.equal(x, y))
    return torch.tensor(same, device=x.device)


def allclose(x, y, *, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _same_dtype(x, y)
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan).all()


def isclose(x, y, *, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(*_same_dtype(x, y), rtol=rtol, atol=atol, equal_nan=equal_nan)
