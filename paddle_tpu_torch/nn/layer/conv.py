"""Convolution layers (``paddle_tpu/nn/layer/conv.py``).

Weights are OIHW (``[out, in / groups, *kernel]``) for the convolutions and
``[in, out / groups, *kernel]`` for the transposes, as in the JAX layers
and in torch. A convolution's weight defaults to ``Normal(0, sqrt(2 /
fan_in))``, a transpose's to XavierNormal, a bias to zeros.
"""
from __future__ import annotations

import math

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer
from .common import param_of


class _ConvNd(Layer):
    _dims = 2
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW", device=None):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * self._dims
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = tuple(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        self.weight = param_of([out_channels, in_channels // groups, *self._kernel_size],
                               weight_attr, I.Normal(0.0, (2.0 / fan_in) ** 0.5), device)
        self.bias = (None if bias_attr is False
                     else param_of([out_channels], bias_attr, None, device, is_bias=True))

    def forward(self, x):
        return self._fn(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, stride={self._stride}")


class Conv1D(_ConvNd):
    _dims, _fn = 1, staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL", device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format, device)


class Conv2D(_ConvNd):
    _dims, _fn = 2, staticmethod(F.conv2d)


class Conv3D(_ConvNd):
    _dims, _fn = 3, staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCDHW", device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format, device)


class _ConvTransposeNd(Layer):
    _dims = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCHW", device=None):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * self._dims
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self.weight = param_of([in_channels, out_channels // groups, *kernel_size],
                               weight_attr, None, device)
        self.bias = (None if bias_attr is False
                     else param_of([out_channels], bias_attr, None, device, is_bias=True))


class Conv1DTranspose(_ConvTransposeNd):
    _dims = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCL", device=None):
        k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        super().__init__(in_channels, out_channels, k, stride, padding, output_padding,
                         groups, dilation, weight_attr, bias_attr, data_format, device)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  output_size, self._data_format)


class Conv2DTranspose(_ConvTransposeNd):
    _dims = 2

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None, bias_attr=None,
                 data_format="NCHW", device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         output_padding, groups, dilation, weight_attr, bias_attr,
                         data_format, device)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  self._data_format, output_size)


class Conv3DTranspose(_ConvTransposeNd):
    _dims = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCDHW", device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         output_padding, groups, dilation, weight_attr, bias_attr,
                         data_format, device)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  output_size, self._data_format)
