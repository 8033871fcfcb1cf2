"""``paddle.autograd.functional`` of the port: ``vjp``, ``jvp``, the lazy
``Jacobian`` and ``Hessian`` matrices and the dense ``jacobian`` /
``hessian`` (the counterpart of ``paddle_tpu/autograd/functional.py``).

The user function takes and returns Paddle Tensors; each API calls it on
Tensors over fresh leaves of the inputs' values and differentiates with
``torch.autograd.functional`` (reverse mode; ``jvp`` by the double-backward
trick), where the JAX package uses ``jax.vjp`` / ``jax.jvp`` /
``jax.jacrev`` / ``jax.hessian``. Results stop gradient. A ``Jacobian`` is
the JAX package's 2-D view: ``[out_numel, in_numel]`` (inputs side by side
along the last axis), ``[B, out_numel, in_numel]`` when ``is_batched``; a
``Hessian`` of a scalar function is ``[n, n]`` over the inputs flattened
and concatenated.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.place import torch_device
from ..core.tensor import Tensor, _wrap

__all__ = ["vjp", "jvp", "Jacobian", "Hessian", "jacobian", "hessian"]


def _values(xs) -> list:
    """The torch values of ``xs`` (a Tensor, a tensor, anything numpy takes,
    or a list or tuple of them), detached."""
    items = xs if isinstance(xs, (tuple, list)) else [xs]
    out = []
    for x in items:
        if isinstance(x, Tensor):
            x = x._value
        elif not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x), device=torch_device(None))
        out.append(x.detach())
    return out


def _pure(func):
    """``func`` of Tensors as a function of torch tensors."""

    def f(*vals):
        outs = func(*[_wrap(v) for v in vals])
        if isinstance(outs, (tuple, list)):
            return tuple(o._value if isinstance(o, Tensor) else o for o in outs)
        return outs._value if isinstance(outs, Tensor) else outs

    return f


def _result(v):
    if isinstance(v, (tuple, list)):
        return [_wrap(x.detach()) for x in v]
    return _wrap(v.detach())


def vjp(func, xs, v=None):
    """``(func(xs), v @ J)``; ``v`` defaults to ones of the output's shape.
    An input the output does not reach gets zeros."""
    vals = [x.requires_grad_(True) for x in _values(xs)]
    with torch.enable_grad():
        out = _pure(func)(*vals)
    outs = list(out) if isinstance(out, tuple) else [out]
    seeds = [torch.ones_like(o) for o in outs] if v is None else _values(v)
    grads = torch.autograd.grad(outs, vals, seeds, allow_unused=True)
    gs = [_wrap(torch.zeros_like(x) if g is None else g) for x, g in zip(vals, grads)]
    return _result(out), (gs if isinstance(xs, (tuple, list)) else gs[0])


def jvp(func, xs, v=None):
    """``(func(xs), J @ v)``; ``v`` defaults to ones of the inputs' shapes."""
    vals = _values(xs)
    tangents = [torch.ones_like(x) for x in vals] if v is None else _values(v)
    out, jv = torch.autograd.functional.jvp(_pure(func), tuple(vals), tuple(tangents))
    return _result(out), _result(jv)


def _numel(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


class Jacobian:
    """Lazy Jacobian matrix of ``func`` at ``xs``, computed once, at the
    first read: ``[out_numel, in_numel]`` (several inputs side by side), or
    ``[B, out_numel, in_numel]`` when ``is_batched`` (axis 0 of the inputs
    and the output is the batch; the batch's cross terms are dropped)."""

    def __init__(self, func, xs, is_batched: bool = False):
        self._func = func
        self._xs = xs
        self._is_batched = is_batched
        self._mat = None

    def _compute(self):
        if self._mat is not None:
            return self._mat
        vals = _values(self._xs)
        f = _pure(self._func)
        with torch.no_grad():
            out = f(*vals)
        if isinstance(out, tuple):
            raise NotImplementedError("Jacobian over multi-output functions")
        jac = torch.autograd.functional.jacobian(f, tuple(vals))
        out_shape = tuple(out.shape)
        mats = []
        for j, v in zip(jac, vals):
            in_shape = tuple(v.shape)
            if self._is_batched:
                b = out_shape[0]
                o, i = _numel(out_shape[1:]), _numel(in_shape[1:])
                idx = torch.arange(b, device=j.device)
                mats.append(j.reshape(b, o, b, i)[idx, :, idx, :])
            else:
                mats.append(j.reshape(_numel(out_shape), _numel(in_shape)))
        self._mat = torch.cat(mats, dim=-1) if isinstance(self._xs, (tuple, list)) else mats[0]
        return self._mat

    @property
    def shape(self):
        return tuple(self._compute().shape)

    def __getitem__(self, idx):
        return _wrap(self._compute()[idx])

    def numpy(self):
        return self[:].numpy()


class Hessian:
    """Lazy Hessian matrix of a scalar-output ``func`` at ``xs``: ``[n, n]``
    over the inputs flattened and concatenated."""

    def __init__(self, func, xs, is_batched: bool = False):
        if is_batched:
            raise NotImplementedError("batched Hessian")
        self._func = func
        self._xs = xs
        self._mat = None

    def _compute(self):
        if self._mat is not None:
            return self._mat
        vals = _values(self._xs)
        f = _pure(self._func)
        shapes = [tuple(v.shape) for v in vals]
        sizes = [_numel(s) for s in shapes]

        def packed(flat):
            parts = torch.split(flat, sizes)
            out = f(*[p.reshape(s) for p, s in zip(parts, shapes)])
            if isinstance(out, tuple):
                raise ValueError("Hessian requires a single scalar output")
            return out.reshape(())

        flat0 = torch.cat([v.reshape(-1) for v in vals])
        self._mat = torch.autograd.functional.hessian(packed, flat0)
        return self._mat

    @property
    def shape(self):
        return tuple(self._compute().shape)

    def __getitem__(self, idx):
        return _wrap(self._compute()[idx])

    def numpy(self):
        return self[:].numpy()


def jacobian(func, xs, create_graph: bool = False, allow_unused: bool = False):
    """The dense Jacobian as a Tensor (the legacy ``functional.jacobian``)."""
    if create_graph:
        raise NotImplementedError(
            "jacobian(create_graph=True): use paddle.grad(..., create_graph=True) per row")
    return Jacobian(func, xs)[:]


def hessian(func, xs, create_graph: bool = False, allow_unused: bool = False):
    """The dense Hessian of a scalar function as a Tensor."""
    if create_graph:
        raise NotImplementedError(
            "hessian(create_graph=True): compose paddle.grad(..., create_graph=True) sweeps")
    return Hessian(func, xs)[:]
