"""Gradient and parameter-vector utilities (``paddle_tpu/nn/utils_fns.py``)."""
from __future__ import annotations

import torch

from ..core import dispatch


def _params(parameters):
    parameters = dispatch.unwrap(parameters)
    return [parameters] if isinstance(parameters, torch.Tensor) else list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Scale the gradients in place so their joint ``norm_type`` norm is at
    most ``max_norm`` (by ``min(max_norm / (total + 1e-6), 1)``); returns the
    norm before clipping."""
    grads = [p.grad for p in _params(parameters) if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([torch.sum(g.abs() ** norm_type) for g in grads]).sum() \
            ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite total norm")
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    for p in _params(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)


@dispatch.accepts_tensors
def parameters_to_vector(parameters, name=None):
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of ``vec`` into ``parameters``, in place."""
    vec = dispatch.unwrap(vec)
    offset = 0
    for p in _params(parameters):
        n = p.numel()
        p.copy_(vec[offset:offset + n].reshape(p.shape))
        offset += n
