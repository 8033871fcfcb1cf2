"""Activation recomputation: the port of ``paddle_tpu/incubate/recompute.py``.

A segment's forward runs without keeping its activations; the backward runs
it again under autograd and differentiates that. As in the JAX package the
segment is one node whose inputs are the tensor arguments AND the
parameters of the function's layer (``seg_params``), so it works under
``torch.autograd.grad`` as well as ``backward()``.

The recomputation sees what the forward saw:
  - the same dropout masks: the port's generator of the segment's device is
    stashed at the forward and restored around the recomputation
    (``core.random.SegmentRng``; inside a CUDA-graph capture, a pair of
    generator states registered before the capture). ``torch.utils.checkpoint``
    would stash only torch's default generators, not the port's, and
    recompute with new masks;
  - the same AMP O1 cast state, which is thread-local and may differ where
    the backward runs (autograd runs a CUDA backward on its own thread).
A parameter changed in place between the forward and the backward raises,
by autograd's saved-tensor version check.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import amp as _amp
from ..core import random as _random

__all__ = ["recompute", "recompute_sequential"]


class _Segment(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, n_args, *flat):
        args = flat[:n_args]
        ctx.run, ctx.n_args = run, n_args
        ctx.rng = _random.SegmentRng(args[0].device)
        ctx.amp = _amp.state()
        ctx.save_for_backward(*flat)
        with ctx.rng.forward():
            out = run(*args)
        ctx.tuple_out = isinstance(out, tuple)
        return out

    @staticmethod
    def backward(ctx, *grad_outs):
        flat = ctx.saved_tensors
        args = [a.detach().requires_grad_(a.requires_grad) for a in flat[:ctx.n_args]]
        params = list(flat[ctx.n_args:])
        with torch.enable_grad(), ctx.rng.replay(), _amp.restored(ctx.amp):
            out = ctx.run(*args)
        outs = out if ctx.tuple_out else (out,)
        pairs = [(o, g) for o, g in zip(outs, grad_outs)
                 if g is not None and o.requires_grad]
        wrt = [a for a in args if a.requires_grad] + params
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                         allow_unused=True) if pairs else [None] * len(wrt))
        arg_grads = [next(grads) if a.requires_grad else None for a in args]
        return (None, None, *arg_grads, *grads)


def _segment(function, params, args, kwargs):
    """``function(*args, **kwargs)`` as one recompute segment whose gradient
    also flows to ``params``."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    params = [p for p in params if p.requires_grad]
    if not tensors or not torch.is_grad_enabled() or not (
            params or any(t.requires_grad for t in tensors)):
        return function(*args, **kwargs)

    def run(*tensor_args):
        it = iter(tensor_args)
        return function(*[next(it) if isinstance(a, torch.Tensor) else a for a in args],
                        **kwargs)

    return _Segment.apply(run, len(tensors), *tensors, *params)


def recompute(function: Callable, *args, **kwargs):
    """``paddle.distributed.fleet.utils.recompute``: run ``function`` as one
    segment whose activations are recomputed in the backward. The parameters
    of the layer a bound method belongs to are differentiated through it."""
    kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", True)
    owner = getattr(function, "__self__", None)
    params = list(owner.parameters()) if isinstance(owner, torch.nn.Module) else []
    return _segment(function, params, args, kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``paddle.incubate.distributed.fleet.recompute_sequential``: run the
    layers of ``functions`` in ``ctx["segments"]`` chunks (or ``ctx`` chunks),
    each chunk one recompute segment over its layers' parameters."""
    kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", True)
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else int(ctx or 1)
    layers = list(functions)
    per = (len(layers) + segments - 1) // segments
    out = args[0]
    for i in range(0, len(layers), per):
        chunk = layers[i:i + per]

        def run(x, _chunk=chunk):
            for layer in _chunk:
                x = layer(x)
            return x

        params = [p for layer in chunk if isinstance(layer, torch.nn.Module)
                  for p in layer.parameters()]
        out = _segment(run, params, (out,), kwargs)
    return out
