"""Random ops on torch tensors: ``paddle_tpu/ops/random_ops.py``'s functions.

Each draws from the torch generator it is given (``core.random.generator``
of the device, reseeded by ``paddle.seed``). The JAX package draws from jax
keys, so the two never share bits: the ops are held to shape, dtype, range
and moments, and to their own reproducibility under ``paddle.seed``.
"""
from __future__ import annotations

import torch

from ..core.dtype import to_torch_dtype


def uniform(gen, *, shape, dtype="float32", min=-1.0, max=1.0):
    out = torch.empty(tuple(shape), dtype=to_torch_dtype(dtype), device=gen.device)
    return out.uniform_(min, max, generator=gen)


def gaussian(gen, *, shape, dtype="float32", mean=0.0, std=1.0):
    out = torch.empty(tuple(shape), dtype=to_torch_dtype(dtype), device=gen.device)
    return out.normal_(mean, std, generator=gen)


normal = gaussian


def randint(gen, *, low, high, shape, dtype="int64"):
    return torch.randint(low, high, tuple(shape), generator=gen, dtype=to_torch_dtype(dtype),
                         device=gen.device)


def randperm(gen, *, n, dtype="int64"):
    return torch.randperm(n, generator=gen, device=gen.device).to(to_torch_dtype(dtype))


def bernoulli(gen, p):
    return torch.bernoulli(p, generator=gen)


def poisson(gen, lam):
    return torch.poisson(lam, generator=gen)


def exponential(gen, x, *, lam=1.0):
    return torch.empty_like(x).exponential_(lam, generator=gen)


def multinomial(gen, x, *, num_samples=1, replacement=False):
    return torch.multinomial(x, num_samples, replacement=replacement, generator=gen)
