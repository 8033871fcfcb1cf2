"""Tensor-parallel layers at world size 1 (``paddle_tpu/distributed/fleet/meta_parallel.py:45-122``).

On one card there is nothing to shard: the layers compute what their JAX
counterparts compute unsharded, with weights ``[in, out]``, and
``with_sharding_constraint`` returns its input. Sharding across cards
comes with the multi-GPU work.
"""
from __future__ import annotations

import torch

from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer.common import create_parameter, param_of
from ...nn.layer_base import Layer

__all__ = [
    "VocabParallelEmbedding",
    "ColumnParallelLinear",
    "RowParallelLinear",
    "with_sharding_constraint",
]


def with_sharding_constraint(x, *spec):
    """A sharding hint; a no-op on one card."""
    return x


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None):
        super().__init__()
        self.weight = param_of(
            [num_embeddings, embedding_dim], weight_attr, I.XavierNormal(), device
        )

    def forward(self, x):
        return F.embedding(x, self.weight)


class ColumnParallelLinear(Layer):
    """Weight ``[in, out]`` (out dim sharded over mp at world > 1)."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 gather_output=True, fuse_matmul_bias=False, mp_group=None,
                 name=None, device=None):
        super().__init__()
        self.weight = param_of(
            [in_features, out_features], weight_attr, I.XavierNormal(), device
        )
        self.bias = (
            create_parameter([out_features], I.Constant(0.0), device) if has_bias else None
        )

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(Layer):
    """Weight ``[in, out]`` (in dim sharded over mp at world > 1). The bias is
    added AFTER the matmul, where the JAX layer adds it after the mp
    all-reduce."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 input_is_parallel=False, fuse_matmul_bias=False, mp_group=None,
                 name=None, device=None):
        super().__init__()
        self.weight = param_of(
            [in_features, out_features], weight_attr, I.XavierNormal(), device
        )
        self.bias = (
            create_parameter([out_features], I.Constant(0.0), device) if has_bias else None
        )

    def forward(self, x):
        out = F.linear(x, self.weight, None)
        if self.bias is not None:
            out = out + self.bias
        return out
