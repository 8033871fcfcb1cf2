"""Normalization layers (``paddle_tpu/nn/layer/norm.py``).

The batch norms keep their running statistics in the buffers ``_mean``
(zeros) and ``_variance`` (ones), f32, so ``state_dict`` keys are the
JAX layers'; ``F.batch_norm`` updates them in place in training. Weights
default to ones, biases to zeros.
"""
from __future__ import annotations

import torch

from ...core import random as _random
from ...core.place import torch_device
from ...ops import nn_ops as _nn
from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer
from .common import param_of


def _affine(layer, shape, weight_attr, bias_attr, device):
    layer.weight = (None if weight_attr is False
                    else param_of(shape, weight_attr, I.Constant(1.0), device))
    layer.bias = (None if bias_attr is False
                  else param_of(shape, bias_attr, None, device, is_bias=True))


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None,
                 device=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _affine(self, [num_features], weight_attr, bias_attr, device)
        dev = torch_device(device)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self._momentum,
                            epsilon=self._epsilon, data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class BatchNorm(_BatchNormBase):
    """The fluid-era ``BatchNorm(num_channels, act=None, ...)``: an optional
    activation of ``nn.functional`` after the normalisation."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05, **kw):
        super().__init__(num_channels, momentum, epsilon)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(F, self._act)(out) if self._act else out


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics would be reduced across replicas; on one
    card (no mesh) they are the local batch's, as in the JAX layer outside
    a mesh."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it replaced by a SyncBatchNorm
        holding the same parameters and statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      weight_attr=False if layer.weight is None else None,
                      bias_attr=False if layer.bias is None else None,
                      data_format=layer._data_format, use_global_stats=layer._use_global_stats,
                      device=layer._mean.device)
            with torch.no_grad():
                for name, t in layer.state_dict().items():
                    out.state_dict()[name].copy_(t)
        for name, sub in list(layer.named_children()):
            setattr(out, name, cls.convert_sync_batchnorm(sub))
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None, bias_attr=None,
                 name=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        _affine(self, self._normalized_shape, weight_attr, bias_attr, device)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None, device=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        _affine(self, [num_channels], weight_attr, bias_attr, device)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight, self.bias,
                            self._data_format)


class InstanceNorm2D(Layer):
    """Per-sample, per-channel statistics over the spatial axes; the scale is
    named ``scale`` as in the JAX layer. One class serves 1-d, 2-d and 3-d
    inputs, as there."""

    def __init__(self, num_features, epsilon=1e-05, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale = (None if weight_attr is False
                      else param_of([num_features], weight_attr, I.Constant(1.0), device))
        self.bias = (None if bias_attr is False
                     else param_of([num_features], bias_attr, None, device, is_bias=True))

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias, eps=self._epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta, self.k)


class SpectralNorm(Layer):
    """``weight`` over its largest singular value, estimated by
    ``power_iters`` rounds of power iteration on the buffers ``weight_u`` and
    ``weight_v`` (drawn from the port's generator), refined in place on
    every forward."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12, name=None,
                 device=None):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        self._shape = list(weight_shape)
        h = self._shape[dim]
        w = 1
        for i, s in enumerate(self._shape):
            if i != dim:
                w *= s
        dev = torch_device(device)
        gen = _random.generator(dev)
        self.register_buffer("weight_u", torch.randn(h, generator=gen, device=dev))
        self.register_buffer("weight_v", torch.randn(w, generator=gen, device=dev))

    def forward(self, weight):
        # the iteration reads copies: the buffers are refined in place below
        out, u, v = _nn.spectral_normalize(weight, self.weight_u.clone(), self.weight_v.clone(),
                                           dim=self.dim,
                                           power_iters=self.power_iters, eps=self.eps)
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return out
