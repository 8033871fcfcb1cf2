"""LayerNorm (``paddle_tpu/nn/layer/norm.py:93``): weight ones, bias zeros."""
from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .common import _init_of, create_parameter


class LayerNorm(torch.nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = (
            None if weight_attr is False
            else create_parameter(
                self._normalized_shape, _init_of(weight_attr, I.Constant(1.0)), device
            )
        )
        self.bias = (
            None if bias_attr is False
            else create_parameter(
                self._normalized_shape, _init_of(bias_attr, I.Constant(0.0)), device
            )
        )

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"
