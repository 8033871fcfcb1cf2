"""Common layers: Linear, Embedding, Dropout, LayerList (``paddle_tpu/nn/layer/common.py``).

Layers are ``torch.nn.Module``s. Each takes an explicit ``device`` (the
current device when None, see ``core/place.py``) and draws its parameters
there from the port's generator. ``Linear`` keeps Paddle's ``[in, out]``
weight, unlike ``torch.nn.Linear``'s ``[out, in]``.
"""
from __future__ import annotations

import torch

from ...core.place import torch_device
from .. import functional as F
from .. import initializer as I


_param_count = [0]


def create_parameter(shape, initializer, device=None, dtype=torch.float32):
    """A parameter of ``shape`` on ``device``, filled by ``initializer``.

    It carries its Paddle name, ``param_<n>`` from one process-wide counter
    as in the JAX package, as ``param_name`` (torch reserves ``Tensor.name``);
    the optimizer keys its state by it."""
    t = torch.empty(tuple(int(s) for s in shape), dtype=dtype, device=torch_device(device))
    param = torch.nn.Parameter(initializer(t))
    _param_count[0] += 1
    param.param_name = f"param_{_param_count[0]}"
    return param


def _init_of(attr, default):
    """A ``weight_attr`` that is an Initializer overrides the layer's default."""
    return attr if isinstance(attr, I.Initializer) else default


class Linear(torch.nn.Module):
    """y = xW + b with the Paddle weight layout ``[in_features, out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None,
                 name=None, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = create_parameter(
            [in_features, out_features], _init_of(weight_attr, I.XavierNormal()), device
        )
        self.bias = (
            None if bias_attr is False
            else create_parameter([out_features], _init_of(bias_attr, I.Constant(0.0)), device)
        )

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(torch.nn.Module):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, device=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (
            None if padding_idx is None
            else padding_idx if padding_idx >= 0
            else num_embeddings + padding_idx
        )
        self.weight = create_parameter(
            [num_embeddings, embedding_dim], _init_of(weight_attr, I.XavierNormal()), device
        )
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(torch.nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


# ``paddle.nn.LayerList``: sublayers named "0", "1", ... as in Paddle
LayerList = torch.nn.ModuleList
