"""Activation layers (``paddle_tpu/nn/layer/activation.py``): each holds its
arguments and calls its ``nn.functional`` function; ``PReLU`` holds its
slope as a parameter."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer
from .common import functional_layer


def _define(cls_name, fn_name, *arg_names, **defaults):
    return functional_layer(__name__, cls_name, fn_name, arg_names, defaults)


ReLU = _define("ReLU", "relu")
ReLU6 = _define("ReLU6", "relu6")
LeakyReLU = _define("LeakyReLU", "leaky_relu", "negative_slope", negative_slope=0.01)
ELU = _define("ELU", "elu", "alpha", alpha=1.0)
SELU = _define("SELU", "selu", "scale", "alpha", scale=1.0507009873554805,
               alpha=1.6732632423543772)
CELU = _define("CELU", "celu", "alpha", alpha=1.0)
GELU = _define("GELU", "gelu", "approximate", approximate=False)
Sigmoid = _define("Sigmoid", "sigmoid")
LogSigmoid = _define("LogSigmoid", "log_sigmoid")
Tanh = _define("Tanh", "tanh")
Tanhshrink = _define("Tanhshrink", "tanhshrink")
Silu = _define("Silu", "silu")
Swish = _define("Swish", "swish")
Mish = _define("Mish", "mish")
Hardshrink = _define("Hardshrink", "hardshrink", "threshold", threshold=0.5)
Hardsigmoid = _define("Hardsigmoid", "hardsigmoid")
Hardswish = _define("Hardswish", "hardswish")
Hardtanh = _define("Hardtanh", "hardtanh", "min", "max", min=-1.0, max=1.0)
Softplus = _define("Softplus", "softplus", "beta", "threshold", beta=1.0, threshold=20.0)
Softshrink = _define("Softshrink", "softshrink", "threshold", threshold=0.5)
Softsign = _define("Softsign", "softsign")
ThresholdedReLU = _define("ThresholdedReLU", "thresholded_relu", "threshold", threshold=1.0)
Softmax = _define("Softmax", "softmax", "axis", axis=-1)
LogSoftmax = _define("LogSoftmax", "log_softmax", "axis", axis=-1)
Maxout = _define("Maxout", "maxout", "groups", "axis", axis=1)
GLU = _define("GLU", "glu", "axis", axis=-1)


class PReLU(Layer):
    """``max(0, x) + weight * min(0, x)`` with ``num_parameters`` slopes
    (one, or one per channel), initialised to ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(shape=[num_parameters], attr=weight_attr,
                                            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
