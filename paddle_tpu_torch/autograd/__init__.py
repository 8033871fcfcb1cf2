"""``paddle.autograd`` of the port: ``grad``, ``backward``, ``PyLayer`` over
torch's autograd (the counterpart of ``paddle_tpu/autograd/__init__.py``).

``autograd.functional`` (``vjp``, ``jvp``, ``Jacobian``, ``Hessian``,
``jacobian``, ``hessian``) is exported here too, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..core import dispatch
from ..core.dispatch import enable_grad, is_grad_enabled, no_grad  # noqa: F401
from ..core.tensor import Tensor, _wrap
from .functional import Hessian, Jacobian, hessian, jacobian, jvp, vjp  # noqa: F401

__all__ = ["grad", "backward", "PyLayer", "PyLayerContext", "no_grad", "enable_grad",
           "vjp", "jvp", "Jacobian", "Hessian", "jacobian", "hessian"]


def _as_list(x):
    return [x] if isinstance(x, (Tensor, torch.Tensor)) else list(x)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None, create_graph=False,
         only_inputs=True, allow_unused=False, no_grad_vars=None, name=None):
    """paddle.grad (reference: fluid/dygraph/base.py grad): the gradients of
    ``outputs`` with respect to ``inputs``, touching no ``grad``.

    ``retain_graph`` defaults to ``create_graph``. An input the outputs do
    not reach raises unless ``allow_unused``, which gives None for it.
    Without ``create_graph`` the results stop gradient; with it the
    backward is recorded, so they can be differentiated again. No gradient
    flows through the tensors of ``no_grad_vars``."""
    outputs = _as_list(outputs)
    single = isinstance(inputs, (Tensor, torch.Tensor))
    inputs = _as_list(inputs)
    if grad_outputs is not None:
        grad_outputs = _as_list(grad_outputs)
    if no_grad_vars is not None:
        no_grad_vars = _as_list(no_grad_vars)
    got = dispatch.run_grad(outputs, inputs, grad_outputs, retain_graph=retain_graph,
                            create_graph=create_graph, allow_unused=allow_unused,
                            no_grad_vars=no_grad_vars)
    results = [None if g is None else _wrap(g if create_graph else g.detach()) for g in got]
    return results[0] if single else results


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward."""
    tensors = _as_list(tensors)
    if grad_tensors is not None:
        grad_tensors = _as_list(grad_tensors)
    dispatch.run_backward(tensors, grad_tensors, retain_graph=retain_graph)


class PyLayerContext:
    """reference: python/paddle/autograd/py_layer.py PyLayerContext."""

    def __init__(self):
        self._saved = ()
        self.non_differentiable = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def mark_non_differentiable(self, *tensors):
        self.non_differentiable = tensors


class _PyLayerFunction(torch.autograd.Function):
    """The torch Function behind every PyLayer: it hands the user's forward
    and backward Paddle Tensors and maps their results back."""

    @staticmethod
    def forward(ctx, layer, kwargs, *args):
        pctx = PyLayerContext()
        cells = [_wrap(a) if isinstance(a, torch.Tensor) else a for a in args]
        outputs = layer.forward(pctx, *cells, **kwargs)
        ctx.pctx, ctx.layer = pctx, layer
        ctx.is_seq = isinstance(outputs, (tuple, list))
        ctx.tensor_at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        outs = [dispatch.unwrap(o) for o in (outputs if ctx.is_seq else (outputs,))]
        if pctx.non_differentiable:
            ctx.mark_non_differentiable(*[dispatch.unwrap(t) for t in pctx.non_differentiable])
        return tuple(outs) if ctx.is_seq else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        got = ctx.layer.backward(ctx.pctx, *[_wrap(g) for g in grads])
        got = got if isinstance(got, (tuple, list)) else (got,)
        if len(got) != len(ctx.tensor_at):
            raise RuntimeError(f"{ctx.layer.__name__}.backward returned {len(got)} grads for "
                               f"{len(ctx.tensor_at)} tensor inputs")
        out = [None] * len(ctx.needs_input_grad)
        for i, g in zip(ctx.tensor_at, got):
            out[2 + i] = dispatch.unwrap(g)
        return tuple(out)


class PyLayer:
    """Custom autograd op with a user forward and backward (reference:
    python/paddle/autograd/py_layer.py:202), on ``torch.autograd.Function``.

    ``forward(ctx, *args, **kwargs)`` runs without recording and gets
    Tensors; ``backward(ctx, *grads)`` returns one gradient per Tensor
    input of ``forward``, in order (None for one that needs none)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        vals = [a._value if isinstance(a, Tensor) else a for a in args]
        out = _PyLayerFunction.apply(cls, kwargs, *vals)
        return dispatch.wrap(list(out) if isinstance(out, tuple) else out)
