"""Parameter initializers drawing from the port's generator (``core/random.py``).

The counterpart of ``paddle_tpu/nn/initializer``. Each initializer fills a
tensor in place on its own device, so a model made on the card draws its
weights there.
"""
from __future__ import annotations

import math

import torch

from ..core import random as _random


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
    def __call__(self, param: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            self._fill(param)
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
