"""``paddle.nn.utils`` (``paddle_tpu/nn/utils/__init__.py``): weight and
spectral normalisation as forward pre-hooks, and the parameter-vector
and gradient-clipping utilities."""
from __future__ import annotations

import torch

from ...core import random as _random
from ..utils_fns import (  # noqa: F401
    clip_grad_norm_, clip_grad_value_, parameters_to_vector, vector_to_parameters,
)

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm", "parameters_to_vector",
           "vector_to_parameters", "clip_grad_norm_", "clip_grad_value_"]


def _norm_except_dim(v, dim):
    if dim is None or v.dim() == 1:
        return torch.sqrt((v * v).sum())
    shape = [1] * v.dim()
    shape[dim] = v.shape[dim]
    axes = [i for i in range(v.dim()) if i != dim]
    return torch.sqrt((v * v).sum(dim=axes)).reshape(shape)


class _WeightNormHook:
    """``name`` recomputed as ``g * v / ||v||`` before every forward."""

    def __init__(self, name, dim):
        self.name = name
        self.dim = dim

    def compute_weight(self, layer):
        g = getattr(layer, self.name + "_g")
        v = getattr(layer, self.name + "_v")
        return g * (v / _norm_except_dim(v, self.dim))

    def __call__(self, layer, inputs):
        setattr(layer, self.name, self.compute_weight(layer))
        return inputs


def weight_norm(layer, name="weight", dim=0):
    """Reparameterise ``layer.<name>`` as ``<name>_g`` (the norms over every
    axis but ``dim``) times ``<name>_v / ||<name>_v||``."""
    w = getattr(layer, name)
    if dim is not None and dim < 0:
        dim += w.dim()
    hook = _WeightNormHook(name, dim)
    with torch.no_grad():
        g0 = _norm_except_dim(w, dim)
    del layer._parameters[name]
    layer.register_parameter(name + "_g", torch.nn.Parameter(g0))
    layer.register_parameter(name + "_v", torch.nn.Parameter(w.detach().clone()))
    setattr(layer, name, hook.compute_weight(layer))
    handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_hooks = getattr(layer, "_weight_norm_hooks", {})
    layer._weight_norm_hooks[name] = (hook, handle)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g * v / ||v||`` back into one parameter ``<name>``."""
    hooks = getattr(layer, "_weight_norm_hooks", {})
    if name not in hooks:
        raise ValueError(f"weight_norm of '{name}' not found on {layer}")
    hook, handle = hooks.pop(name)
    with torch.no_grad():
        w = hook.compute_weight(layer)
    handle.remove()
    del layer._parameters[name + "_g"]
    del layer._parameters[name + "_v"]
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, torch.nn.Parameter(w))
    return layer


class _SpectralNormHook:
    """``name`` recomputed before every forward as ``<name>_orig`` over its
    top singular value, estimated by power iteration on the buffer
    ``<name>_u`` (refined in place)."""

    def __init__(self, name, n_power_iterations, eps, dim):
        self.name = name
        self.power_iters = n_power_iterations
        self.eps = eps
        self.dim = dim

    def compute_weight(self, layer):
        w_orig = getattr(layer, self.name + "_orig")
        u = getattr(layer, self.name + "_u")
        mat = w_orig.movedim(self.dim, 0).reshape(w_orig.shape[self.dim], -1)
        with torch.no_grad():
            v = None
            for _ in range(max(1, self.power_iters)):
                v = mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + self.eps)
                u_new = mat @ v
                u.copy_(u_new / (torch.linalg.vector_norm(u_new) + self.eps))
        sigma = u @ (mat @ v)
        return w_orig / sigma

    def __call__(self, layer, inputs):
        setattr(layer, self.name, self.compute_weight(layer))
        return inputs


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12, dim=None):
    """Divide ``layer.<name>`` by its top singular value on every forward;
    ``dim`` defaults to 1 for a ``Linear`` (``[in, out]``) and 0 otherwise."""
    w = getattr(layer, name)
    if dim is None:
        dim = 1 if type(layer).__name__ == "Linear" else 0
    hook = _SpectralNormHook(name, n_power_iterations, eps, dim)
    del layer._parameters[name]
    layer.register_parameter(name + "_orig", torch.nn.Parameter(w.detach().clone()))
    u0 = torch.randn(w.shape[dim], generator=_random.generator(w.device), device=w.device)
    layer.register_buffer(name + "_u", u0 / (torch.linalg.vector_norm(u0) + eps))
    setattr(layer, name, hook.compute_weight(layer))
    handle = layer.register_forward_pre_hook(hook)
    layer._spectral_norm_hooks = getattr(layer, "_spectral_norm_hooks", {})
    layer._spectral_norm_hooks[name] = (hook, handle)
    return layer
