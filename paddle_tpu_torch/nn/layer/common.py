"""Common layers and containers (``paddle_tpu/nn/layer/common.py``).

Layers are ``nn.Layer``s (``torch.nn.Module``s with Paddle's state
methods, ``nn/layer_base.py``). Each takes an explicit ``device`` (the
current device when None, see ``core/place.py``) and draws its parameters
there from the port's generator. ``Linear`` keeps Paddle's ``[in, out]``
weight, unlike ``torch.nn.Linear``'s ``[out, in]``. A ``weight_attr`` or
``bias_attr`` is a ``ParamAttr``, an Initializer, a name, or False for no
parameter (``param_of``).

The containers are torch's, under Paddle's names and signatures:
``Sequential`` (layers, ``(name, layer)`` pairs or an OrderedDict),
``LayerList`` (``append(layer)``, ``insert(index, layer)``,
``extend(layers)``), ``LayerDict`` and ``ParameterList``; their sublayers
are named "0", "1", ... as in Paddle, so ``state_dict`` keys match the
JAX package's.
"""
from __future__ import annotations

import collections

import torch

from ...core.place import torch_device
from ...core.tensor import Parameter
from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer
from ..param_attr import ParamAttr


_param_count = [0]


def create_parameter(shape, initializer, device=None, dtype=torch.float32):
    """A parameter of ``shape`` on ``device``, filled by ``initializer``.

    It carries its Paddle name, ``param_<n>`` from one process-wide counter
    as in the JAX package, as ``param_name`` (torch reserves ``Tensor.name``);
    the optimizer keys its state by it."""
    t = torch.empty(tuple(int(s) for s in shape), dtype=dtype, device=torch_device(device))
    param = Parameter(initializer(t))
    _param_count[0] += 1
    param.param_name = f"param_{_param_count[0]}"
    return param


def param_of(shape, attr, default=None, device=None, dtype=torch.float32, is_bias=False):
    """The parameter a layer makes for ``attr`` (the JAX
    ``Layer.create_parameter``): the initializer of a ``ParamAttr`` or the
    Initializer given, else the one of ``set_global_initializer`` (for
    biases its bias one), else ``default``, else zeros for a bias and
    XavierNormal for a weight. A ``ParamAttr`` also sets ``trainable`` and
    the Paddle name (``param_name``); a string is a name."""
    init, trainable, name = None, True, None
    if isinstance(attr, ParamAttr):
        init, trainable, name = attr.initializer, attr.trainable, attr.name
    elif isinstance(attr, I.Initializer):
        init = attr
    elif isinstance(attr, str):
        name = attr
    if init is None:
        init = (I._global_bias_init if is_bias else I._global_weight_init) or default
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    param = create_parameter(shape, init, device, dtype)
    param.requires_grad_(bool(trainable))
    if name:
        param.param_name = name
    return param


def functional_layer(module, cls_name, fn_name, arg_names=(), defaults=None, n_inputs=1):
    """A layer class, in ``module``, whose forward is ``F.<fn_name>(*inputs,
    **args)``: its constructor takes the arguments ``arg_names`` positionally
    or by name (``defaults`` for those not given) and keeps each as an
    attribute of that name; ``forward`` passes its first ``n_inputs``
    inputs."""
    def __init__(self, *args, name=None, **kwargs):
        Layer.__init__(self)
        values = dict(defaults or {})
        values.update(zip(arg_names, args))
        values.update(kwargs)
        for a in arg_names:
            setattr(self, a, values[a])

    def forward(self, *inputs):
        return getattr(F, fn_name)(*inputs[:n_inputs], **{a: getattr(self, a) for a in arg_names})

    def extra_repr(self):
        return ", ".join(f"{a}={getattr(self, a)}" for a in arg_names)

    return type(cls_name, (Layer,), {
        "__init__": __init__, "forward": forward, "extra_repr": extra_repr,
        "__module__": module, "__doc__": f"``nn.functional.{fn_name}`` as a layer."})


class Linear(Layer):
    """y = xW + b with the Paddle weight layout ``[in_features, out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None,
                 name=None, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = param_of([in_features, out_features], weight_attr, I.XavierNormal(),
                               device)
        self.bias = (None if bias_attr is False
                     else param_of([out_features], bias_attr, None, device, is_bias=True))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
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
        self.weight = param_of([num_embeddings, embedding_dim], weight_attr, I.XavierNormal(),
                               device)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training, data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest", align_corners=False,
                 align_mode=0, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode, self.align_corners,
                             self.align_mode, self.data_format)


class UpsamplingBilinear2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size, scale_factor=self.scale_factor,
                             mode="bilinear", align_corners=True, data_format=self.data_format)


class UpsamplingNearest2D(Layer):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size, scale_factor=self.scale_factor,
                             mode="nearest", data_format=self.data_format)


class _Pad(Layer):
    _sides = 2

    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW", name=None):
        super().__init__()
        self.padding = (list(padding) if isinstance(padding, (list, tuple))
                        else [padding] * self._sides)
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_Pad):
    _sides = 2

    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_Pad):
    _sides = 4


class Pad3D(_Pad):
    _sides = 6

    def __init__(self, padding, mode="constant", value=0.0, data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_Pad):
    _sides = 4

    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    """The p-norm of ``x - y + epsilon`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return torch.linalg.vector_norm(x - y + self.epsilon, ord=self.p, dim=-1,
                                        keepdim=self.keepdim)


class Bilinear(Layer):
    """``out[n, o] = x1[n] · W[o] · x2[n] + b[o]``, weight ``[out, in1, in2]``,
    bias ``[1, out]``."""

    def __init__(self, in1_features, in2_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        self.weight = param_of([out_features, in1_features, in2_features], weight_attr, None,
                               device)
        self.bias = (None if bias_attr is False
                     else param_of([1, out_features], bias_attr, None, device, is_bias=True))

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides, self.paddings,
                      self.dilations)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings, self.dilations)


# ----------------------------- containers -----------------------------------
class Sequential(Layer, torch.nn.Sequential):
    """Runs its sublayers in order."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)


class LayerList(Layer, torch.nn.ModuleList):
    """A list of sublayers named "0", "1", ..."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.extend(sublayers)

    def append(self, layer):
        return torch.nn.ModuleList.append(self, layer)

    def extend(self, layers):
        return torch.nn.ModuleList.extend(self, layers)

    def insert(self, index, layer):
        return torch.nn.ModuleList.insert(self, index, layer)


class LayerDict(Layer, torch.nn.ModuleDict):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers:
            self.update(sublayers)


class ParameterList(Layer, torch.nn.ParameterList):
    def __init__(self, parameters=None):
        Layer.__init__(self)
        if parameters is not None:
            for p in parameters:
                self.append(p)

    def append(self, parameter):
        return torch.nn.ParameterList.append(self, parameter)
