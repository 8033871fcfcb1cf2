"""Parameter initializers drawing from the port's generator (``core/random.py``).

The counterpart of ``paddle_tpu/nn/initializer``. Each initializer fills a
tensor in place on its own device, so a model made on the card draws its
weights there. ``set_global_initializer`` sets the initializers a layer's
parameters take when their attribute names none (``nn.layer.common.param_of``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import random as _random

__all__ = [
    "Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal", "XavierNormal",
    "XavierUniform", "KaimingNormal", "KaimingUniform", "Assign", "Orthogonal", "Dirac",
    "Bilinear", "calculate_gain", "set_global_initializer",
]


def calculate_gain(nonlinearity, param=None):
    recommended = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
        "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)), "selu": 3.0 / 4,
    }
    return recommended[nonlinearity]


def _fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # paddle linear weight is [in, out]
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, param, block=None):
        """Fill ``param`` (a torch tensor, or a Paddle Tensor's value) in place."""
        t = getattr(param, "_value", param)
        with torch.no_grad():
            self._fill(t)
        return param

    def _fill(self, t: torch.Tensor):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _fill(self, t):
        t.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _fill(self, t):
        t.normal_(self.mean, self.std, generator=_random.generator(t.device))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self._fan_in, self._fan_out, self._gain = fan_in, fan_out, gain

    def _fill(self, t):
        fan_in, fan_out = _fans(tuple(t.shape))
        fan_in = self._fan_in or fan_in
        fan_out = self._fan_out or fan_out
        std = self._gain * math.sqrt(2.0 / (fan_in + fan_out))
        t.normal_(0.0, std, generator=_random.generator(t.device))


def _gen(t):
    return _random.generator(t.device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def _fill(self, t):
        t.uniform_(self.low, self.high, generator=_gen(t))


class TruncatedNormal(Initializer):
    """A normal truncated at two standard deviations, as ``jax.random.truncated_normal(-2, 2)``."""

    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def _fill(self, t):
        torch.nn.init.trunc_normal_(t, self.mean, self.std, self.mean - 2 * self.std,
                                    self.mean + 2 * self.std, generator=_gen(t))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self._fan_in, self._fan_out, self._gain = fan_in, fan_out, gain

    def _fill(self, t):
        fan_in, fan_out = _fans(tuple(t.shape))
        limit = self._gain * math.sqrt(6.0 / ((self._fan_in or fan_in) + (self._fan_out or fan_out)))
        t.uniform_(-limit, limit, generator=_gen(t))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in, self._slope, self._nonlinearity = fan_in, negative_slope, nonlinearity

    def _fill(self, t):
        fan_in = self._fan_in or _fans(tuple(t.shape))[0]
        std = calculate_gain(self._nonlinearity, self._slope) / math.sqrt(fan_in)
        t.normal_(0.0, std, generator=_gen(t))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in, self._slope, self._nonlinearity = fan_in, negative_slope, nonlinearity

    def _fill(self, t):
        fan_in = self._fan_in or _fans(tuple(t.shape))[0]
        limit = calculate_gain(self._nonlinearity, self._slope) * math.sqrt(3.0 / fan_in)
        t.uniform_(-limit, limit, generator=_gen(t))


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = np.asarray(getattr(value, "numpy", lambda: value)())

    def _fill(self, t):
        if tuple(self.value.shape) != tuple(t.shape):
            raise ValueError(f"Assign shape {self.value.shape} != param shape {tuple(t.shape)}")
        t.copy_(torch.as_tensor(self.value))


class Orthogonal(Initializer):
    """``gain`` times the Q of a QR factorisation of a normal draw, signs
    fixed by R's diagonal, as in the JAX initializer."""

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _fill(self, t):
        rows = t.shape[0]
        cols = math.prod(t.shape[1:]) if t.dim() > 1 else 1
        flat = torch.empty(max(rows, cols), min(rows, cols), device=t.device)
        flat.normal_(generator=_gen(t))
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        t.copy_((self.gain * q[:rows, :cols]).reshape(t.shape))


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _fill(self, t):
        t.zero_()
        oc, ic = t.shape[0], t.shape[1]
        centers = tuple(s // 2 for s in t.shape[2:])
        per = oc // self.groups
        for g in range(self.groups):
            for i in range(min(per, ic)):
                t[(g * per + i, i) + centers] = 1.0


class Bilinear(Initializer):
    """The bilinear upsampling kernel for a transposed convolution's weight."""

    def _fill(self, t):
        if t.dim() != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        kh, kw = t.shape[2], t.shape[3]
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        og = np.ogrid[:kh, :kw]
        filt = (1 - abs(og[0] / f_h - c_h)) * (1 - abs(og[1] / f_w - c_w))
        t.copy_(torch.as_tensor(np.broadcast_to(filt, tuple(t.shape)).copy()))


# fluid-era aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
XavierInitializer = XavierNormal
MSRAInitializer = KaimingNormal
NumpyArrayInitializer = Assign

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """The initializers every later parameter without an initializer of its
    own attribute takes (weights, biases); ``(None, None)`` restores the
    layers' defaults."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init
