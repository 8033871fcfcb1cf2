"""Pooling layers (``paddle_tpu/nn/layer/pooling.py``): each holds its
arguments and calls its ``nn.functional`` function."""
from __future__ import annotations

from .common import functional_layer


def _pool(cls_name, fn_name, arg_names, defaults, n_inputs=1):
    return functional_layer(__name__, cls_name, fn_name, arg_names, defaults, n_inputs)


_WINDOW = ("kernel_size", "stride", "padding")
_W = {"stride": None, "padding": 0}

MaxPool1D = _pool("MaxPool1D", "max_pool1d", _WINDOW + ("ceil_mode",), {**_W, "ceil_mode": False})
MaxPool2D = _pool("MaxPool2D", "max_pool2d", _WINDOW + ("ceil_mode", "return_mask", "data_format"),
                  {**_W, "ceil_mode": False, "return_mask": False, "data_format": "NCHW"})
MaxPool3D = _pool("MaxPool3D", "max_pool3d", _WINDOW + ("ceil_mode", "return_mask", "data_format"),
                  {**_W, "ceil_mode": False, "return_mask": False, "data_format": "NCDHW"})
AvgPool1D = _pool("AvgPool1D", "avg_pool1d", _WINDOW + ("exclusive", "ceil_mode"),
                  {**_W, "exclusive": True, "ceil_mode": False})
AvgPool2D = _pool("AvgPool2D", "avg_pool2d",
                  _WINDOW + ("ceil_mode", "exclusive", "divisor_override", "data_format"),
                  {**_W, "ceil_mode": False, "exclusive": True, "divisor_override": None,
                   "data_format": "NCHW"})
AvgPool3D = _pool("AvgPool3D", "avg_pool3d",
                  _WINDOW + ("ceil_mode", "exclusive", "divisor_override", "data_format"),
                  {**_W, "ceil_mode": False, "exclusive": True, "divisor_override": None,
                   "data_format": "NCDHW"})
AdaptiveAvgPool1D = _pool("AdaptiveAvgPool1D", "adaptive_avg_pool1d", ("output_size",), {})
AdaptiveAvgPool2D = _pool("AdaptiveAvgPool2D", "adaptive_avg_pool2d",
                          ("output_size", "data_format"), {"data_format": "NCHW"})
AdaptiveAvgPool3D = _pool("AdaptiveAvgPool3D", "adaptive_avg_pool3d",
                          ("output_size", "data_format"), {"data_format": "NCDHW"})
AdaptiveMaxPool1D = _pool("AdaptiveMaxPool1D", "adaptive_max_pool1d",
                          ("output_size", "return_mask"), {"return_mask": False})
AdaptiveMaxPool2D = _pool("AdaptiveMaxPool2D", "adaptive_max_pool2d",
                          ("output_size", "return_mask"), {"return_mask": False})
AdaptiveMaxPool3D = _pool("AdaptiveMaxPool3D", "adaptive_max_pool3d",
                          ("output_size", "return_mask"), {"return_mask": False})
MaxUnPool1D = _pool("MaxUnPool1D", "max_unpool1d",
                    _WINDOW + ("data_format", "output_size"),
                    {**_W, "data_format": "NCL", "output_size": None}, n_inputs=2)
MaxUnPool2D = _pool("MaxUnPool2D", "max_unpool2d",
                    _WINDOW + ("data_format", "output_size"),
                    {**_W, "data_format": "NCHW", "output_size": None}, n_inputs=2)
MaxUnPool3D = _pool("MaxUnPool3D", "max_unpool3d",
                    _WINDOW + ("data_format", "output_size"),
                    {**_W, "data_format": "NCDHW", "output_size": None}, n_inputs=2)
